// K5 wcsph_forces: the fluid-fluid pair forces of a WCSPH step.
//
// Replaces bandmat.dense_wcsph_forces (cfd_taichi_tpu/ops/bandmat.py:
// 1867-1961), an XLA pass of the JAX package that evaluates every slot of
// a (QB, B, nbcap*64) block window. Per sorted fluid particle i, over pairs
// j != i with r2 <= h2, with gc = grad W factor and W the cubic spline:
//   coeff  = -m (p'_i + p'_j) gc                       Tait pressure
//          + [shear < 0] (-m m pi gc)                  Monaghan viscosity
//          + (-k m) W                                  cohesion
//   shear  = x_ij . (v_i - v_j)
//   pi     = -(nu / (rho_i + rho_j)) shear / (r2 + eps h^2),  nu = 2 alpha h c_s
//   out[i] = sum_j coeff x_ij
// with p' = p / rho^2 (reference wcsph_solver.py:102-116, solver_base.py:
// 170-217). The three terms are added into one coefficient per pair in
// that order, as JAX adds them.
//
// Bound on the card: f32 operations (a distance test and the pair term per
// pair within h, perf/bounds.py), far below what the walk of ~27 x
// occupancy candidates takes, as for fluid_terms (PERF.md section 6). The
// pair term is heavier than fluid_terms': five gathers (v_j, rho_j, p'_j),
// both cubic polynomials and a branch on the shear's sign.
//
// Design: one thread per query on the queued walk (queued_walk,
// stencil.cuh), with matvec's constants (queue 40, chunks of 8, 8 blocks an
// SM): the candidate loop only tests and queues, and the pair term with its
// gathers runs in the drain, on lanes that nearly all hold a pair. The
// viscosity branch is a select, so a drain turn stays one straight line.
// The hits drain in walk order and each sum is added in that order, so a
// run repeats bit for bit. Sums stay in registers, each output is written
// once, with no atomics.
#include "stencil.cuh"

constexpr int kWcsphQueue = 40;  // hits a thread can hold
constexpr int kWcsphChunk = 8;   // candidates tested between two votes

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
wcsph_forces_kernel(const float* __restrict__ pos,
                    const int* __restrict__ starts, int n, StencilParams p,
                    float m, float nu_num, float q2e_add, float tension_mk,
                    const float* __restrict__ vel,
                    const float* __restrict__ rho,
                    const float* __restrict__ pr, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f, vxi = 0.f, vyi = 0.f, vzi = 0.f,
        rhoi = 0.f, pri = 0.f;
  if (live) {
    xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    vxi = vel[3 * i], vyi = vel[3 * i + 1], vzi = vel[3 * i + 2];
    rhoi = rho[i];
    pri = pr[i];
  }
  const float mm = -m * m;

  float ox = 0.f, oy = 0.f, oz = 0.f;
  queued_walk<kWcsphQueue, kWcsphChunk>(
      pos, n, starts, p, live, i, xi, yi, zi,
      [&](int j, float dx, float dy, float dz, float r2, bool take) {
        const float r = pair_r(r2);
        const float gc = cubic_grad_coeff(r, p);
        const float wk = cubic_w(r, p);
        const float shear = dx * (vxi - __ldg(vel + 3 * j)) +
                            dy * (vyi - __ldg(vel + 3 * j + 1)) +
                            dz * (vzi - __ldg(vel + 3 * j + 2));
        const float pi =
            -(nu_num / (rhoi + __ldg(rho + j))) * shear / (r2 + q2e_add);
        float coeff = -m * (pri + __ldg(pr + j)) * gc;
        coeff = coeff + ((shear < 0.f) ? mm * pi * gc : 0.f);
        coeff = coeff + tension_mk * wk;
        const float tx = coeff * dx;
        const float ty = coeff * dy;
        const float tz = coeff * dz;
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

extern "C" int wcsph_forces_launch(const float* pos, const int* starts, int n,
                                   const StencilParams* p, float m,
                                   float nu_num, float q2e_add,
                                   float tension_mk, const float* vel,
                                   const float* rho, const float* pr,
                                   float* out, void* stream) {
  if (n > 0) {
    wcsph_forces_kernel<<<grid_blocks(n), kThreads, 0,
                          (cudaStream_t)stream>>>(pos, starts, n, *p, m,
                                                  nu_num, q2e_add, tension_mk,
                                                  vel, rho, pr, out);
  }
  return (int)cudaGetLastError();
}
