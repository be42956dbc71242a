// K3 matvec / matvec_dot: the two per-iteration pair products of the DFSPH
// pressure loops.
//
// Replace bandmat.matvec / matvec_dot (cfd_taichi_tpu/ops/bandmat.py:
// 1964-1985) over a stored (QB, B, W) coefficient band, and the stored-
// coefficient forms coef_matvec_ops / split_coef_matvec_ops (:817, :1419).
// With a = m gc x_ij over pairs j != i, r2 <= h2:
//   matvec[i]     = sum_j a * k_j            (3 components)
//   matvec_dot[i] = sum_j a . v_j
// The coefficients are recomputed from positions on every call, so nothing
// per pair is stored. As in JAX, the reference's (k_i + k_j) > 1e-5 pair
// guard is dropped (bandmat.py:40-46).
// Bound on the card: f32 operations by perf/bounds.py, far below what the
// walk of ~27 x occupancy candidates takes. As measured for this form of
// walk on an NVIDIA H100 80GB HBM3 (PERF.md section 6): at breaking_dam_1m
// the card is full and the warps' instruction slots set the time, because
// the pair term sits in the candidate loop and the warp runs it for about
// every candidate, though one in eight is a pair; at 30k particles and on
// dense cells a thread's serial walk waits on its loads. fluid_terms left
// this form for the queued walk (stencil.cuh), which these two kernels are
// to take next. Design so far: one thread per query, sums in registers, no
// atomics; recomputing the coefficients keeps no band in memory, at the
// price of a walk per loop iteration, so the stored-coefficient engine
// (ops/coef.py) carries every scene whose pair store fits its budget.
#include "stencil.cuh"

__global__ void __launch_bounds__(kThreads)
matvec_kernel(const float* __restrict__ pos, const int* __restrict__ starts,
              int n, StencilParams p, float m, const float* __restrict__ k,
              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  int c[3];
  cell_of(xi, yi, zi, p, c);

  float ox = 0.f, oy = 0.f, oz = 0.f;
  for (int dm = -1; dm <= 1; ++dm) {
    for (int ds = -1; ds <= 1; ++ds) {
      int lo, hi;
      if (!stencil_run(c, dm, ds, starts, p, lo, hi)) continue;
      for (int j = lo; j < hi; ++j) {
        if (j == i) continue;
        const float dx = xi - __ldg(pos + 3 * j);
        const float dy = yi - __ldg(pos + 3 * j + 1);
        const float dz = zi - __ldg(pos + 3 * j + 2);
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (!(r2 <= p.h2)) continue;
        const float w = m * cubic_grad_coeff(pair_r(r2), p);
        const float kj = __ldg(k + j);
        ox += (w * dx) * kj;
        oy += (w * dy) * kj;
        oz += (w * dz) * kj;
      }
    }
  }
  out[3 * i] = ox;
  out[3 * i + 1] = oy;
  out[3 * i + 2] = oz;
}

__global__ void __launch_bounds__(kThreads)
matvec_dot_kernel(const float* __restrict__ pos,
                  const int* __restrict__ starts, int n, StencilParams p,
                  float m, const float* __restrict__ v,
                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  int c[3];
  cell_of(xi, yi, zi, p, c);

  // Per-component partial sums, added at the end like JAX's three einsums.
  float ox = 0.f, oy = 0.f, oz = 0.f;
  for (int dm = -1; dm <= 1; ++dm) {
    for (int ds = -1; ds <= 1; ++ds) {
      int lo, hi;
      if (!stencil_run(c, dm, ds, starts, p, lo, hi)) continue;
      for (int j = lo; j < hi; ++j) {
        if (j == i) continue;
        const float dx = xi - __ldg(pos + 3 * j);
        const float dy = yi - __ldg(pos + 3 * j + 1);
        const float dz = zi - __ldg(pos + 3 * j + 2);
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (!(r2 <= p.h2)) continue;
        const float w = m * cubic_grad_coeff(pair_r(r2), p);
        ox += (w * dx) * __ldg(v + 3 * j);
        oy += (w * dy) * __ldg(v + 3 * j + 1);
        oz += (w * dz) * __ldg(v + 3 * j + 2);
      }
    }
  }
  out[i] = ox + oy + oz;
}

extern "C" int matvec_launch(const float* pos, const int* starts, int n,
                             const StencilParams* p, float m, const float* k,
                             float* out, void* stream) {
  if (n > 0) {
    matvec_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, starts, n, *p, m, k, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int matvec_dot_launch(const float* pos, const int* starts, int n,
                                 const StencilParams* p, float m,
                                 const float* v, float* out, void* stream) {
  if (n > 0) {
    matvec_dot_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, starts, n, *p, m, v, out);
  }
  return (int)cudaGetLastError();
}
