// K1 fluid_terms: the one-shot fluid-fluid pair sums of a DFSPH step.
//
// Replaces bandmat.build_band_terms (cfd_taichi_tpu/ops/bandmat.py:431-505),
// which evaluates every slot of a (QB, B, nbcap*64) block window densely.
// Per sorted fluid particle i, over pairs j != i with r2 <= h2:
//   rho[i]   = sum m W
//   count[i] = number of pairs
//   s[i]     = sum m gc x_ij           (gc = grad W factor, x_ij = x_i - x_j)
//   qsum[i]  = sum (m gc r)^2
//   tvec[i]  = sum W x_ij
//
// Bound on the card: f32 operations (a distance test and a 49-operation
// pair term per pair within h, perf/bounds.py), far below what any form
// reaches. What sets the time was measured on an NVIDIA H100 80GB HBM3
// (PERF.md section 6): at breaking_dam_1m the card is full and the warps'
// instruction slots set it; at 30k particles (910 warps on 132 SMs) and
// on dense cells a thread's serial walk waits on its loads. The form
// before this one ran the pair term (a square root, two divisions, both
// cubic polynomials, nine accumulations) inside the candidate loop, where
// the warp runs it for about every candidate although one candidate in
// eight is a pair.
//
// Design: one thread per query on the queued walk (queued_walk,
// stencil.cuh). The candidate loop only tests, a chunk of candidates'
// loads in flight at a time, and queues the hits in shared memory (40 a
// thread: a lattice query's pairs, so it drains about once); the pair term
// runs in a drain loop on lanes that nearly all hold a pair. The hits
// drain in walk order, so every sum is added in the order of the form
// before: the outputs are bit-equal to it, and `count` exactly the plain
// version's. Sums stay in registers, each output is written once, with no
// atomics and no stored pair list.
#include "stencil.cuh"

constexpr int kFluidQueue = 40;  // hits a thread can hold

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
fluid_terms_kernel(const float* __restrict__ pos, const int* __restrict__ starts,
                   int n, StencilParams p, float m, float* __restrict__ rho,
                   int* __restrict__ count, float* __restrict__ s,
                   float* __restrict__ qsum, float* __restrict__ tvec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];

  float a_rho = 0.f, a_q = 0.f;
  float sx = 0.f, sy = 0.f, sz = 0.f, tx = 0.f, ty = 0.f, tz = 0.f;
  int cnt = 0;
  queued_walk<kFluidQueue>(pos, n, starts, p, live, i, xi, yi, zi,
              [&](int, float dx, float dy, float dz, float r2, bool take) {
                const float r = pair_r(r2);
                const float w = m * cubic_grad_coeff(r, p);
                const float wk = cubic_w(r, p);
                const float mw = m * wk, wr = w * r;
                const float wx = w * dx, wy = w * dy, wz = w * dz;
                const float kx = wk * dx, ky = wk * dy, kz = wk * dz;
                const float q2 = wr * wr;
                if (!take) return;
                cnt += 1;
                a_rho += mw;
                sx += wx;
                sy += wy;
                sz += wz;
                a_q += q2;
                tx += kx;
                ty += ky;
                tz += kz;
              });
  if (!live) return;
  rho[i] = a_rho;
  count[i] = cnt;
  s[3 * i] = sx;
  s[3 * i + 1] = sy;
  s[3 * i + 2] = sz;
  qsum[i] = a_q;
  tvec[3 * i] = tx;
  tvec[3 * i + 1] = ty;
  tvec[3 * i + 2] = tz;
}

extern "C" int fluid_terms_launch(const float* pos, const int* starts, int n,
                                  const StencilParams* p, float m, float* rho,
                                  int* count, float* s, float* qsum,
                                  float* tvec, void* stream) {
  if (n > 0) {
    fluid_terms_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, starts, n, *p, m, rho, count, s, qsum, tvec);
  }
  return (int)cudaGetLastError();
}
