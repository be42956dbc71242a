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
//
// Bound on the card: f32 operations (a distance test a candidate and a
// 27-operation pair term a pair, perf/bounds.py), far below what the walk
// of ~27 x occupancy candidates takes. The form before this one ran the
// pair term (a square root, two divisions, the gather of k_j or v_j, three
// products) inside the candidate loop, where the warp runs it for about
// every candidate although one candidate in eight is a pair, and had one
// candidate's loads in flight at a time.
//
// Design: one thread per query on the queued walk (queued_walk,
// stencil.cuh), as fluid_terms. The candidate loop only tests, a chunk of
// candidates' loads in flight at a time, and queues the hits in shared
// memory (40 a thread: a lattice query's pairs, so it drains about once);
// the pair term, with its gather, runs in a drain loop on lanes that
// nearly all hold a pair. The hits drain in walk order and the three
// products keep their bracketing, (w * dx) * k_j, so every sum is added as
// in the form before: the outputs are bit-equal to it. Sums stay in
// registers, each output is written once, with no atomics. Recomputing the
// coefficients keeps no band in memory, at the price of a walk per loop
// iteration, so the stored-coefficient engine (ops/coef.py) carries every
// scene whose pair store fits its budget.
//
// The constants, as measured on an NVIDIA H100 80GB HBM3 (PERF.md section
// 6; matvec / matvec_dot, device us at breaking_dam_1m, on the clustered
// cloud, at 30k particles). The term is lighter than fluid_terms' (48
// registers against 56 at chunks of 6), which leaves room for the loads
// of 8 candidates (56 registers): 387 / 406, 1093 / 1154, 28 / 30 against
// 405 / 433, 1251 / 1344, 34 / 36 with chunks of 6, which on the clustered
// cloud is slower than the form before (595 / 616, 1119 / 1202, 74 / 79);
// chunks of 12 lose at 1M. A queue of 32 or 36 hits
// drains mid-walk on part-filled lanes (497-529 / 510-539 at 1M); 44 and
// 48 take shared memory from the L1 that serves the walk's loads (396 /
// 428 at 1M, 31 / 33 at 30k). 2, 4 or 8 terms a drain turn, 6 or 10
// blocks an SM and a queue depth of its own for matvec_dot change nothing
// beyond 3 %.
#include "stencil.cuh"

constexpr int kMatvecQueue = 40;  // hits a thread can hold
constexpr int kMatvecChunk = 8;   // candidates tested between two votes

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
matvec_kernel(const float* __restrict__ pos, const int* __restrict__ starts,
              int n, StencilParams p, float m, const float* __restrict__ k,
              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];

  float ox = 0.f, oy = 0.f, oz = 0.f;
  queued_walk<kMatvecQueue, kMatvecChunk>(
      pos, n, starts, p, live, i, xi, yi, zi,
      [&](int j, float dx, float dy, float dz, float r2, bool take) {
        const float w = m * cubic_grad_coeff(pair_r(r2), p);
        const float kj = __ldg(k + j);
        const float tx = (w * dx) * kj;
        const float ty = (w * dy) * kj;
        const float tz = (w * dz) * kj;
        if (!take) return;
        ox += tx;
        oy += ty;
        oz += tz;
      });
  if (!live) return;
  out[3 * i] = ox;
  out[3 * i + 1] = oy;
  out[3 * i + 2] = oz;
}

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
matvec_dot_kernel(const float* __restrict__ pos,
                  const int* __restrict__ starts, int n, StencilParams p,
                  float m, const float* __restrict__ v,
                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];

  // Per-component partial sums, added at the end like JAX's three einsums.
  float ox = 0.f, oy = 0.f, oz = 0.f;
  queued_walk<kMatvecQueue, kMatvecChunk>(
      pos, n, starts, p, live, i, xi, yi, zi,
      [&](int j, float dx, float dy, float dz, float r2, bool take) {
        const float w = m * cubic_grad_coeff(pair_r(r2), p);
        const float tx = (w * dx) * __ldg(v + 3 * j);
        const float ty = (w * dy) * __ldg(v + 3 * j + 1);
        const float tz = (w * dz) * __ldg(v + 3 * j + 2);
        if (!take) return;
        ox += tx;
        oy += ty;
        oz += tz;
      });
  if (!live) return;
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
