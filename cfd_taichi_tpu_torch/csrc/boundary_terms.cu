// K2 boundary_terms: the Akinci boundary sums of a fluid query.
//
// Replaces bandmat.dense_boundary_terms (cfd_taichi_tpu/ops/bandmat.py:
// 1527-1623), a group-sparse dense window pass whose selected groups are
// capped by a static capacity. Per sorted fluid particle i, over boundary
// particles b (cell-sorted, with volumes V_b) with r2 <= h2, and
// w_b = rho0 V_b:
//   rho[i]  = sum w_b W
//   s[i]    = sum w_b gc x_ib
//   qsum[i] = sum (w_b gc r)^2
//   g2[i]   = sum w_b gc^2 r^2
//
// Bound on the card: bytes (the queries' pos read, six floats a query
// written, the boundary set and the per-cell table read once:
// perf/bounds.py). The boundary shell is static and thin: at
// breaking_dam_1m 137,602 boundary particles stand beside 1,000,000 fluid
// ones, so most queries are interior and their nine boundary runs are
// empty. The form before this one still paid 18 dependent reads of
// bstarts for each of them, and its wall-near threads ran the pair term
// in the candidate loop beside lanes that idled (times on an NVIDIA H100
// 80GB HBM3: PERF.md section 6).
//
// Design: `bnear` (scene.py, ops/neighbors.stencil_counts) holds, per
// cell, the boundary particles of the cell's 27-cell stencil. A thread
// reads it after cell_of; a warp none of whose lanes has any writes its
// zeros and leaves after that one read. The other warps take the queued
// walk (queued_walk, stencil.cuh) over the boundary table: no self-pair,
// loads clamped at the boundary count, the volume loaded per pair in the
// drain; a lane whose cell has no boundary particle near walks empty
// runs. A wall-near query holds few boundary pairs, so the queue is 16
// deep: its 8 KB a block leave more blocks resident for the interior
// queries' reads than a deeper one (at breaking_dam_1m 40 us at 16, 43 at
// 32, 54 at 48), at the price of more drains where the boundary is dense.
// Hits drain in walk order, so the sums are bit-equal to the form
// before. The walk needs no capacity, so unlike the JAX pass no wall-near
// query can be dropped.
#include "stencil.cuh"

constexpr int kBoundaryQueue = 16;  // hits a thread can hold

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
boundary_terms_kernel(const float* __restrict__ qpos, int n,
                      const float* __restrict__ bpos,
                      const float* __restrict__ bvol,
                      const int* __restrict__ bstarts,
                      const int* __restrict__ bnear, int nb, StencilParams p,
                      float rho0, float* __restrict__ rho,
                      float* __restrict__ s, float* __restrict__ qsum,
                      float* __restrict__ g2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  bool near = false;
  if (i < n) {
    xi = qpos[3 * i], yi = qpos[3 * i + 1], zi = qpos[3 * i + 2];
    int c[3];
    cell_of(xi, yi, zi, p, c);
    near = __ldg(bnear + c[0] * p.strides[0] + c[1] * p.strides[1] +
                 c[2] * p.strides[2]) > 0;
  }

  float a_rho = 0.f, a_q = 0.f, a_g2 = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  if (__any_sync(kFullWarp, near)) {
    queued_walk<kBoundaryQueue>(
        bpos, nb, bstarts, p, near, -1, xi, yi, zi,
        [&](int j, float dx, float dy, float dz, float r2, bool take) {
          const float r = pair_r(r2);
          const float wb = rho0 * __ldg(bvol + j);
          const float wk = cubic_w(r, p);
          const float gcv = cubic_grad_coeff(r, p);
          const float wg = wb * gcv, wr = wg * r;
          const float bw = wb * wk, q2 = wr * wr;
          const float wx = wg * dx, wy = wg * dy, wz = wg * dz;
          const float gg = wg * gcv * r2;
          if (!take) return;
          a_rho += bw;
          sx += wx;
          sy += wy;
          sz += wz;
          a_q += q2;
          a_g2 += gg;
        });
  }
  if (i >= n) return;
  rho[i] = a_rho;
  s[3 * i] = sx;
  s[3 * i + 1] = sy;
  s[3 * i + 2] = sz;
  qsum[i] = a_q;
  g2[i] = a_g2;
}

extern "C" int boundary_terms_launch(const float* qpos, int n,
                                     const float* bpos, const float* bvol,
                                     const int* bstarts, const int* bnear,
                                     int nb, const StencilParams* p,
                                     float rho0, float* rho, float* s,
                                     float* qsum, float* g2, void* stream) {
  if (n > 0) {
    boundary_terms_kernel<<<grid_blocks(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
        qpos, n, bpos, bvol, bstarts, bnear, nb, *p, rho0, rho, s, qsum, g2);
  }
  return (int)cudaGetLastError();
}
