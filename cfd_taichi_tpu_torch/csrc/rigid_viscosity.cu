// R3 rigid_viscosity: the solid branch of the Monaghan viscosity, per
// cell-sorted fluid query over the rigid particles in its stencil.
//
// Replaces rigid_dense.viscosity_op (cfd_taichi_tpu/ops/rigid_dense.py:
// 202-237), an XLA pass of the JAX package over the fluid groups near the
// body. With w_s = rho0 V_j, c the cubic gradient factor and r = sqrt(max(
// r2, 1e-24)) over the pairs with r2 <= h2 at the start-of-step positions:
//   shear = (v_i - v_body) . x_ij
//   pi    = -(nu / (rho_i + rho_q[lid_j])) shear / (r^2 + (eps h) h)
//   out_i = m sum_{shear < 0} (-w_s pi c) x_ij
// with nu = 2 alpha h c_s. The rigid side carries the body's linear
// velocity only (rigid_solver.py:97), and its density is the reference's
// quirk: rho_q, a fluid density read at the rigid particle's own index
// (models/dfsph.py makes the table), through lid_j, the original index of
// sorted slot j. W's gradient takes q = r * f32(1/h), as XLA computes
// JAX's r / h (cubic_grad_coeff, stencil.cuh).
//
// Bound on the card: the bytes of the fluid positions and the output, and
// of the velocities and densities of the queries with a body pair
// (perf/bounds.py). The first form spent its time on the walk: every query
// loaded its velocity and density, then its 9 stencil runs of the rigid
// table, each with a warp vote, and only queries near the body (~3 % at
// 1M) found pairs: 56.5 us at 1M against a 12.3 us bound (PERF.md section
// 6).
//
// Design: one thread per query on the queued walk (queued_walk_of,
// stencil.cuh) over the rigid table, the pair term in the drain, walked
// only from warps with a lane inside the body's gate (in_body_box,
// stencil.cuh; rbox, made once a step by stencil.make_body_box and shared
// with the step's other gated walks) and only from those lanes. Such a
// warp alone loads its queries' velocities and densities and the body's
// velocity, read from device memory (a (3,) tensor) so that a step reads
// nothing back to the host; a far warp reads its positions, votes once
// and writes 0.f * m, what its empty walk would give: every output keeps
// its bits. Hits drain in walk order, sums stay in registers, each output
// is written once: no atomics, a run repeats bit for bit.
//
// Measured on an NVIDIA H100 80GB HBM3 (PERF.md section 6, perf/
// coef_compare.py --kernel rigid_gate; device us at 1M / 30k / the half-
// immersed torus): gated 43.9 / 20.4 / 24.0, ungated 60.0 / 20.5 / 23.7,
// the first form 56.2-56.9 / 20.0-20.2 / 23.5; loading vel and rho for the
// lanes inside the box alone, not every live lane of a warp that walks,
// took 45.6 / 22.0 / 27.5. The floor with no walk, the sweep of the
// queue's constants and why the near warps set the time at 30k:
// rigid_terms.cu.
#include "stencil.cuh"

constexpr int kViscQueue = 40;  // hits a thread can hold
constexpr int kViscChunk = 8;   // candidates tested between two votes

struct SolidViscosity {
  const float* vol;
  const int* lid;
  const float* rho_q;
  const StencilParams* p;
  float rho0, nu_num, q2e_add;
  float vx, vy, vz, rho_i;  // v_i - v_body and rho_i of the query
  float fx, fy, fz;

  __device__ __forceinline__ void operator()(int j, const XyzRows::Record&,
                                             float dx, float dy, float dz,
                                             float r2, bool take) {
    const float r = pair_r(r2);
    const float gc = cubic_grad_coeff(r, *p);
    const float wsv = rho0 * __ldg(vol + j);
    const float shear = vx * dx + vy * dy + vz * dz;
    const float rho_j = __ldg(rho_q + __ldg(lid + j));
    const float pi = -(nu_num / (rho_i + rho_j)) * shear / (r * r + q2e_add);
    const float scale = -wsv * pi * gc;
    if (take && shear < 0.0f) {
      fx += scale * dx;
      fy += scale * dy;
      fz += scale * dz;
    }
  }
};

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
rigid_viscosity_kernel(const float* __restrict__ pos, int n,
                       const float* __restrict__ rpos,
                       const float* __restrict__ rvol,
                       const int* __restrict__ rlid,
                       const int* __restrict__ rstarts, int nr,
                       StencilParams p, float rho0, float m,
                       float nu_num, float q2e_add,
                       const float* __restrict__ vel,
                       const float* __restrict__ rho,
                       const float* __restrict__ rho_q,
                       const float* __restrict__ body_vel,
                       const float* __restrict__ rbox,
                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  const bool near = live && in_body_box(rbox, xi, yi, zi);
  SolidViscosity acc{rvol, rlid, rho_q, &p, rho0, nu_num, q2e_add,
                     0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (__any_sync(kFullWarp, near)) {
    if (live) {
      acc.vx = vel[3 * i] - __ldg(body_vel);
      acc.vy = vel[3 * i + 1] - __ldg(body_vel + 1);
      acc.vz = vel[3 * i + 2] - __ldg(body_vel + 2);
      acc.rho_i = rho[i];
    }
    queued_walk_of<kViscQueue, kViscChunk, kDrainUnroll>(
        XyzRows{rpos}, nr, rstarts, p, near, -1, xi, yi, zi, acc);
  }
  if (live) {
    out[3 * i] = acc.fx * m;
    out[3 * i + 1] = acc.fy * m;
    out[3 * i + 2] = acc.fz * m;
  }
}

extern "C" int rigid_viscosity_launch(
    const float* pos, int n, const float* rpos, const float* rvol,
    const int* rlid, const int* rstarts, int nr, const StencilParams* p,
    float rho0, float m, float nu_num, float q2e_add,
    const float* vel, const float* rho, const float* rho_q,
    const float* body_vel, const float* rbox, float* out, void* stream) {
  if (n > 0) {
    rigid_viscosity_kernel<<<grid_blocks(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
        pos, n, rpos, rvol, rlid, rstarts, nr, *p, rho0, m, nu_num,
        q2e_add, vel, rho, rho_q, body_vel, rbox, out);
  }
  return (int)cudaGetLastError();
}
