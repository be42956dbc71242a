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
// body has pairs. What the first form spent was the walk itself: every
// query loaded its 9 stencil runs of the rigid table, each with a warp
// vote, and all but the queries near the body (~3 % at 1M) found them
// empty: 48.6 us for rigid_contact_dot at 1M against a 5.5 us bound
// (PERF.md section 6).
//
// Design: one thread per query on the queued walk (queued_walk_of,
// stencil.cuh) over the rigid table, as pcisph_predict_rho's boundary walk
// does over the walls; the drain runs the pair term on lanes that nearly
// all hold a pair. Hits drain in walk order, sums stay in registers and
// each output is written once by its thread: no atomics, a run repeats bit
// for bit. Both entries walk only from warps with a lane inside the body's
// gate (in_body_box, stencil.cuh; rbox, made once a step by
// stencil.make_body_box before rigid_terms, and shared with the step's
// other gated walks), and only from those lanes: a query outside the box
// has no pair and writes the 0.f its walk would sum (all six of
// rigid_terms' outputs), so every output keeps its bits, and a far warp
// reads its positions, votes once and leaves. The pair work is an
// irregular gather of a few pairs a near query, with no tile for TMA or
// wgmma to feed.
//
// Measured on an NVIDIA H100 80GB HBM3 (PERF.md section 6, perf/
// coef_compare.py --kernel rigid_gate; device us at 1M / 30k / the half-
// immersed torus): the contact dot gated 40.7 / 20.3 / 23.9, ungated 51.0
// / 20.2 / 23.5, the first form 48.7-49.2 / 19.4-19.5 / 22.0-22.7; the
// solid sums gated 42.4-43.0 / 15.4-15.8 / 16.2-16.7, ungated 52.1-52.6 /
// 15.4-15.7 / 15.8-16.1, the first form 51.7 / 15.2 / 15.8, and 26.3 / 1.8
// at 1M / 30k with a gate that holds no query (its 24 bytes of sums a
// query). With a gate that holds no query a launch still takes 19.6 us at
// 1M (the contact dot): waves of the blocks an SM holds (8: 64 registers
// a thread, the queue's 20 KB), each loading positions, voting and
// storing; handing tiles of 32 queries to warps from one counter instead
// took 29.4 (31k atomics on one address). At 30k the near warps' own
// walks set the time (1.8 us with no walk): a near query tests ~60
// candidates (up to 144) of a table packed 8 to a cell, a chain of
// dependent loads that 1-2 warps an SM cannot hide.
// Swept at 1M (contact dot / solid viscosity, the latter loading vel and
// rho for the lanes inside the box alone; us): chunks of 4, 8, 12, 16
// candidates 41.7, 40.3, 39.3, 42.5 / 47.7, 45.3, 45.8, 48.3; drain turns
// of 1, 2, 4, 8 hits 40.5, 40.3, 41.1, 40.7 / 45.3, 45.3, 45.9, 46.9; at
// 30k all within 1 us but chunks of 4 (+2); the 9 runs walked as one list
// with their bounds loaded first, 46.3 / 52.3. So 40 / 8 / 2 stay.
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
                   float rho0, const float* __restrict__ rbox,
                   float* __restrict__ rho, float* __restrict__ s,
                   float* __restrict__ qsum, float* __restrict__ g2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  const bool near = live && in_body_box(rbox, xi, yi, zi);
  RigidSums acc{rvol, &p, rho0, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (__any_sync(kFullWarp, near)) {
    queued_walk_of<kRigidQueue, kRigidChunk, kDrainUnroll>(
        XyzRows{rpos}, nr, rstarts, p, near, -1, xi, yi, zi, acc);
  }
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
                         const float* __restrict__ rbox,
                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  const bool near = live && in_body_box(rbox, xi, yi, zi);
  ContactDot acc{rvol, rlid, v_r, &p, rho0, 0.f};
  if (__any_sync(kFullWarp, near)) {
    queued_walk_of<kRigidQueue, kRigidChunk, kDrainUnroll>(
        XyzRows{rpos}, nr, rstarts, p, near, -1, xi, yi, zi, acc);
  }
  if (live) out[i] = acc.sum;
}

extern "C" int rigid_terms_launch(const float* pos, int n, const float* rpos,
                                  const float* rvol, const int* rstarts,
                                  int nr, const StencilParams* p,
                                  float rho0, const float* rbox, float* rho,
                                  float* s, float* qsum, float* g2,
                                  void* stream) {
  if (n > 0) {
    rigid_terms_kernel<<<grid_blocks(n), kThreads, 0,
                         (cudaStream_t)stream>>>(pos, n, rpos, rvol, rstarts,
                                                 nr, *p, rho0, rbox, rho, s,
                                                 qsum, g2);
  }
  return (int)cudaGetLastError();
}

extern "C" int rigid_contact_dot_launch(const float* pos, int n,
                                        const float* rpos, const float* rvol,
                                        const int* rlid, const int* rstarts,
                                        int nr, const StencilParams* p,
                                        float rho0, const float* v_r,
                                        const float* rbox, float* out,
                                        void* stream) {
  if (n > 0) {
    rigid_contact_dot_kernel<<<grid_blocks(n), kThreads, 0,
                               (cudaStream_t)stream>>>(
        pos, n, rpos, rvol, rlid, rstarts, nr, *p, rho0, v_r, rbox, out);
  }
  return (int)cudaGetLastError();
}
