// R1 rigid_terms and R2 rigid_contact_dot: the fluid side of the
// fluid-rigid coupling, per cell-sorted fluid query over the rigid
// particles in its stencil.
//
// Replace rigid_dense.build_rigid_windows + rigid_terms and contact_dot_op
// (cfd_taichi_tpu/ops/rigid_dense.py:63-158, 161-176), XLA passes of the
// JAX package that select the fluid groups near the body and evaluate them
// against the whole padded body. With w_s = rho0 V_j and c the cubic
// gradient factor, for every rigid j with |x_i - x_j|^2 <= h2 at the
// start-of-step positions, r = sqrt(max(r2, 1e-24)):
//   rigid_terms:       rho_s = sum w_s W(r),  S_s = sum w_s c x_ij,
//                      qsum_s = sum (w_s c r)^2,  g2_s = sum w_s c^2 r^2
//   rigid_contact_dot: sum w_s c (x_ij . v_r[lid_j])
// where v_r holds a velocity per rigid particle in its original order and
// lid_j is the original index of sorted slot j. W and c take q = r *
// f32(1/h), the product XLA makes of JAX's r / h (cubic_w,
// cubic_grad_coeff, stencil.cuh).
//
// Bound on the card: the bytes of the fluid positions and the outputs
// (perf/bounds.py), a few microseconds at 1M particles; only fluid near the
// body has pairs. What the first form spends is the walk itself: every
// query loads its 9 stencil runs of the rigid table, and all but the
// queries near the body find them empty.
//
// Design: one thread per query on the queued walk (queued_walk_of,
// stencil.cuh) over the rigid table, as pcisph_predict_rho's boundary walk
// does over the walls; the drain runs the pair term on lanes that nearly
// all hold a pair. Hits drain in walk order, sums stay in registers and
// each output is written once by its thread: no atomics, a run repeats bit
// for bit. Queries far from the body walk 27 empty cells; a list of the
// queries near the body, which would skip them, is later work.
#include "stencil.cuh"

constexpr int kRigidQueue = 40;  // hits a thread can hold
constexpr int kRigidChunk = 8;   // candidates tested between two votes

struct RigidSums {
  const float* vol;
  const StencilParams* p;
  float rho0;
  float rho, sx, sy, sz, qsum, g2;

  __device__ __forceinline__ void operator()(int j, const XyzRows::Record&,
                                             float dx, float dy, float dz,
                                             float r2, bool take) {
    const float r = pair_r(r2);
    const float ws = rho0 * __ldg(vol + j);
    const float wk = cubic_w(r, *p);
    const float gc = cubic_grad_coeff(r, *p);
    const float wg = ws * gc;
    const float wr = wg * r;
    const float g2t = wg * gc * r * r;
    if (take) {
      rho += ws * wk;
      sx += wg * dx;
      sy += wg * dy;
      sz += wg * dz;
      qsum += wr * wr;
      g2 += g2t;
    }
  }
};

struct ContactDot {
  const float* vol;
  const int* lid;
  const float* v_r;
  const StencilParams* p;
  float rho0;
  float sum;

  __device__ __forceinline__ void operator()(int j, const XyzRows::Record&,
                                             float dx, float dy, float dz,
                                             float r2, bool take) {
    const float r = pair_r(r2);
    const float wg = (rho0 * __ldg(vol + j)) * cubic_grad_coeff(r, *p);
    const int l = __ldg(lid + j);
    const float t = wg * (dx * __ldg(v_r + 3 * l) +
                          dy * __ldg(v_r + 3 * l + 1) +
                          dz * __ldg(v_r + 3 * l + 2));
    if (take) sum += t;
  }
};

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
rigid_terms_kernel(const float* __restrict__ pos, int n,
                   const float* __restrict__ rpos,
                   const float* __restrict__ rvol,
                   const int* __restrict__ rstarts, int nr, StencilParams p,
                   float rho0, float* __restrict__ rho,
                   float* __restrict__ s, float* __restrict__ qsum,
                   float* __restrict__ g2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  RigidSums acc{rvol, &p, rho0, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  queued_walk_of<kRigidQueue, kRigidChunk, kDrainUnroll>(
      XyzRows{rpos}, nr, rstarts, p, live, -1, xi, yi, zi, acc);
  if (live) {
    rho[i] = acc.rho;
    s[3 * i] = acc.sx;
    s[3 * i + 1] = acc.sy;
    s[3 * i + 2] = acc.sz;
    qsum[i] = acc.qsum;
    g2[i] = acc.g2;
  }
}

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
rigid_contact_dot_kernel(const float* __restrict__ pos, int n,
                         const float* __restrict__ rpos,
                         const float* __restrict__ rvol,
                         const int* __restrict__ rlid,
                         const int* __restrict__ rstarts, int nr,
                         StencilParams p, float rho0,
                         const float* __restrict__ v_r,
                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  ContactDot acc{rvol, rlid, v_r, &p, rho0, 0.f};
  queued_walk_of<kRigidQueue, kRigidChunk, kDrainUnroll>(
      XyzRows{rpos}, nr, rstarts, p, live, -1, xi, yi, zi, acc);
  if (live) out[i] = acc.sum;
}

extern "C" int rigid_terms_launch(const float* pos, int n, const float* rpos,
                                  const float* rvol, const int* rstarts,
                                  int nr, const StencilParams* p,
                                  float rho0, float* rho, float* s,
                                  float* qsum, float* g2, void* stream) {
  if (n > 0) {
    rigid_terms_kernel<<<grid_blocks(n), kThreads, 0,
                         (cudaStream_t)stream>>>(pos, n, rpos, rvol, rstarts,
                                                 nr, *p, rho0, rho, s,
                                                 qsum, g2);
  }
  return (int)cudaGetLastError();
}

extern "C" int rigid_contact_dot_launch(const float* pos, int n,
                                        const float* rpos, const float* rvol,
                                        const int* rlid, const int* rstarts,
                                        int nr, const StencilParams* p,
                                        float rho0,
                                        const float* v_r, float* out,
                                        void* stream) {
  if (n > 0) {
    rigid_contact_dot_kernel<<<grid_blocks(n), kThreads, 0,
                               (cudaStream_t)stream>>>(
        pos, n, rpos, rvol, rlid, rstarts, nr, *p, rho0, v_r, out);
  }
  return (int)cudaGetLastError();
}
