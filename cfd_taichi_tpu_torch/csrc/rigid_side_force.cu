// R4 rigid_side_force: the fluid's reaction on each rigid particle in a
// two-way coupled step: once a density iteration of DFSPH and PCISPH, once
// a step of IISPH and WCSPH.
//
// Replaces rigid_dense.build_rigid_side + rigid_side_force (cfd_taichi_tpu/
// ops/rigid_dense.py:255-292), the JAX package's compact (Nr, Kf) list of
// each rigid particle's fluid neighbours and its per-iteration gather,
// which charge each fluid-rigid pair once from the rigid side (the
// reference scatters with atomics, dfsph_solver.py:204-212). Per rigid
// particle j in original order, over the cell-sorted fluid i of the step's
// CSR table with |x_i - x_j|^2 <= h2 and r = |x_i - x_j| <= h
// (rigid_dense.py:272):
//   out_j = force_j + sum_i (rho0 V_j c(r)) (x_i - x_j) u_i
// with c the cubic gradient factor at q = r * f32(1/h) (cubic_grad_coeff)
// and u the per-fluid scalar the solver hands in: k / rho m (DFSPH), p m /
// rho^2 (PCISPH, IISPH) or p' m (WCSPH).
//
// Bound on the card: bytes, the fluid's u and the rigid rows (perf/
// bounds.py), under a microsecond for 10^4 rigid particles; the walk of
// ~27 x occupancy fluid candidates per rigid particle and its launch
// set the time.
//
// Design: one thread per rigid particle on the queued walk (queued_walk_of,
// stencil.cuh) over the fluid's table, the pair term in the drain; the
// pair geometry is recomputed every iteration from the start-of-step
// positions, so nothing per pair is stored. A thread owns its particle's
// sum, so there are no atomics: a run repeats bit for bit, and the card
// can be held to the CPU. The voxels come in the mesh's lattice order, so
// neighbouring threads walk neighbouring cells.
#include "stencil.cuh"

constexpr int kSideQueue = 40;  // hits a thread can hold
constexpr int kSideChunk = 8;   // candidates tested between two votes

struct SideForce {
  const float* u;
  const StencilParams* p;
  float coeff_v;  // rho0 V_j of the query
  float fx, fy, fz;

  __device__ __forceinline__ void operator()(int i, const XyzRows::Record&,
                                             float dx, float dy, float dz,
                                             float r2, bool take) {
    // dx is the query (rigid) minus the source (fluid): x_i - x_j = -dx.
    const float r = pair_r(r2);
    const float coeff = coeff_v * cubic_grad_coeff(r, *p);
    const float ui = __ldg(u + i);
    if (take && r <= p->h) {
      fx += ((-dx) * coeff) * ui;
      fy += ((-dy) * coeff) * ui;
      fz += ((-dz) * coeff) * ui;
    }
  }
};

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
rigid_side_force_kernel(const float* __restrict__ rpos,
                        const float* __restrict__ rvol, int nr,
                        const float* __restrict__ pos,
                        const int* __restrict__ starts, int n,
                        StencilParams p, float rho0,
                        const float* __restrict__ u,
                        const float* __restrict__ force,
                        float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < nr;
  float xj = 0.f, yj = 0.f, zj = 0.f;
  SideForce acc{u, &p, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    xj = rpos[3 * j], yj = rpos[3 * j + 1], zj = rpos[3 * j + 2];
    acc.coeff_v = rho0 * rvol[j];
  }
  queued_walk_of<kSideQueue, kSideChunk, kDrainUnroll>(
      XyzRows{pos}, n, starts, p, live, -1, xj, yj, zj, acc);
  if (live) {
    out[3 * j] = force[3 * j] + acc.fx;
    out[3 * j + 1] = force[3 * j + 1] + acc.fy;
    out[3 * j + 2] = force[3 * j + 2] + acc.fz;
  }
}

extern "C" int rigid_side_force_launch(const float* rpos, const float* rvol,
                                       int nr, const float* pos,
                                       const int* starts, int n,
                                       const StencilParams* p,
                                       float rho0, const float* u,
                                       const float* force, float* out,
                                       void* stream) {
  if (nr > 0) {
    rigid_side_force_kernel<<<grid_blocks(nr), kThreads, 0,
                              (cudaStream_t)stream>>>(
        rpos, rvol, nr, pos, starts, n, *p, rho0, u, force, out);
  }
  return (int)cudaGetLastError();
}
