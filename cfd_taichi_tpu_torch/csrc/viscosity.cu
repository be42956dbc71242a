// K4 viscosity: Monaghan artificial viscosity under compression.
//
// Replaces bandmat.dense_viscosity (cfd_taichi_tpu/ops/bandmat.py:975-1076)
// as reached by dfsph.dense_visc (cfd_taichi_tpu/models/dfsph.py:453-467).
// Per sorted fluid particle i, over pairs j != i with r2 <= h2:
//   shear = x_ij . (v_i - v_j)
//   pi_ij = -(nu / (rho_i + rho_j)) * shear / (r2 + eps h^2)
//   out[i] = m * sum_{shear < 0} (-m pi_ij gc) x_ij
// with nu = 2 alpha h c_s (reference solver_base.py:170-202).
//
// Bound on the card: bytes (pos, starts, vel and rho read, out written:
// 42 MB, 12.5 us at breaking_dam_1m, perf/bounds.py). Neither form comes
// near it. One thread per query (the form before this one, 0.77 ms at 1M
// on the H100, PERF.md) walks ~216 candidates in series, and the force
// term runs on every lane whenever any lane of the warp holds a
// compressive pair. The per-query sum keeps no (Q, W) window temporaries,
// which made the JAX pass chunk itself to fit at 1M.
//
// Design: a group of kGroupWalk lanes per query (group_walk, stencil.cuh):
// a round tests G neighbouring candidates with one contiguous pos read,
// the group queues its hits, and the warp hands them out in batches, so
// that the vel and rho loads, the shear test and the force term run on
// lanes that nearly all hold a pair. Each lane adds the terms of the pairs
// it is handed with the one-thread form's arithmetic; the group then sums
// the three partial sums with a __shfl_xor_sync tree and lane 0 writes the
// row. That order differs from a serial sum, so the checks hold the output
// to 1e-5 of its largest value. Groups past n walk nothing, join the tree
// with zero sums and skip only the store. Measured (PERF.md §6): 2.9x
// faster than one thread per query at 30k and 3.7x on the clustered cloud
// (dense cells), where a thread's serial walk waits on its loads; 7 %
// slower at 1M, where the one-thread form keeps the card's issue slots
// busy and the group walk's ballots, queue and batches cost about as many
// instructions as the force terms they save.
#include "stencil.cuh"

__global__ void __launch_bounds__(kThreads)
viscosity_kernel(const float* __restrict__ pos, const int* __restrict__ starts,
                 int n, StencilParams p, float m, float nu_num, float q2e_add,
                 const float* __restrict__ vel, const float* __restrict__ rho,
                 float* __restrict__ out) {
  const WalkGroup g = walk_group(n);
  const int i = g.i;
  float vxi = 0.f, vyi = 0.f, vzi = 0.f, rhoi = 0.f, xi = 0.f, yi = 0.f,
        zi = 0.f;
  if (g.live) {
    xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    vxi = vel[3 * i], vyi = vel[3 * i + 1], vzi = vel[3 * i + 2];
    rhoi = rho[i];
  }
  float ox = 0.f, oy = 0.f, oz = 0.f;
  group_walk(pos, n, starts, p, g, xi, yi, zi, [&](const Pair& k, int) {
    if (!k.hit) return;
    const int j = k.j;
    const float shear = k.dx * (vxi - __ldg(vel + 3 * j)) +
                        k.dy * (vyi - __ldg(vel + 3 * j + 1)) +
                        k.dz * (vzi - __ldg(vel + 3 * j + 2));
    if (!(shear < 0.f)) return;
    const float gc = cubic_grad_coeff(pair_r(k.r2), p);
    const float pi =
        -(nu_num / (rhoi + __ldg(rho + j))) * shear / (k.r2 + q2e_add);
    const float scale = -m * pi * gc;
    ox += scale * k.dx;
    oy += scale * k.dy;
    oz += scale * k.dz;
  });
  ox = walk_sum(ox, g);
  oy = walk_sum(oy, g);
  oz = walk_sum(oz, g);
  if (!g.live || g.lane != 0) return;
  out[3 * i] = ox * m;
  out[3 * i + 1] = oy * m;
  out[3 * i + 2] = oz * m;
}

extern "C" int viscosity_launch(const float* pos, const int* starts, int n,
                                const StencilParams* p, float m, float nu_num,
                                float q2e_add, const float* vel,
                                const float* rho, float* out, void* stream) {
  if (n > 0) {
    viscosity_kernel<<<walk_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, starts, n, *p, m, nu_num, q2e_add, vel, rho, out);
  }
  return (int)cudaGetLastError();
}
