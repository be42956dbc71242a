// K9 pbf_xsph: PBF's XSPH velocity sum at the updated positions.
//
// Replaces xsph of bandmat.dense_pbf_ops (cfd_taichi_tpu/ops/bandmat.py:
// 1798-1806), an XLA window pass of the JAX package. Per sorted fluid
// particle i, over pairs j != i valid at the START-of-step positions x
// (r2 <= h2), with x' and v' the updated positions and velocities and
// w = poly6(|x'_i - x'_j|), r = sqrt(max(d2, 1e-24)):
//   out[i] = sum_j v'_j w - v'_i sum_j w        (3 components)
// in that order, as JAX takes sum (v_j - v_i) w (reference pbf_solver.py:
// 85-96, its in-kernel race resolved by the updated positions). A pair
// valid at the start but beyond h at x' gives w = 0; a pair within h at x'
// but not valid at the start is not a pair.
//
// Bound on the card: f32 operations (a distance test and a ~30-operation
// pair term a pair, perf/bounds.py), far below what the walk of ~27 x
// occupancy candidates takes.
//
// Design: one thread per query on the queued walk (queued_walk,
// stencil.cuh) over the start positions and their cell table; the drain
// gathers x'_j and v'_j and runs the poly6 term on lanes that nearly all
// hold a pair. Hits drain in walk order: a run repeats bit for bit. Sums
// stay in registers and each output is written once, with no atomics.
#include "stencil.cuh"

constexpr int kXsphQueue = 40;  // hits a thread can hold

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pbf_xsph_kernel(const float* __restrict__ pos, const int* __restrict__ starts,
                int n, StencilParams p, SpikyPoly6 k,
                const float* __restrict__ npos, const float* __restrict__ nvel,
                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  float ux = 0.f, uy = 0.f, uz = 0.f;  // x'_i
  float vx = 0.f, vy = 0.f, vz = 0.f;  // v'_i
  if (live) {
    xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    ux = npos[3 * i], uy = npos[3 * i + 1], uz = npos[3 * i + 2];
    vx = nvel[3 * i], vy = nvel[3 * i + 1], vz = nvel[3 * i + 2];
  }

  float sw = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  queued_walk<kXsphQueue>(
      pos, n, starts, p, live, i, xi, yi, zi,
      [&](int j, float, float, float, float, bool take) {
        const float dx = ux - __ldg(npos + 3 * j);
        const float dy = uy - __ldg(npos + 3 * j + 1);
        const float dz = uz - __ldg(npos + 3 * j + 2);
        const float w = poly6_w(pair_r(dist2(dx, dy, dz)), k);
        const float tx = __ldg(nvel + 3 * j) * w;
        const float ty = __ldg(nvel + 3 * j + 1) * w;
        const float tz = __ldg(nvel + 3 * j + 2) * w;
        if (!take) return;
        sw += w;
        sx += tx;
        sy += ty;
        sz += tz;
      });
  if (!live) return;
  out[3 * i] = sx - vx * sw;
  out[3 * i + 1] = sy - vy * sw;
  out[3 * i + 2] = sz - vz * sw;
}

extern "C" int pbf_xsph_launch(const float* pos, const int* starts, int n,
                               const StencilParams* p, const SpikyPoly6* k,
                               const float* npos, const float* nvel,
                               float* out, void* stream) {
  if (n > 0) {
    pbf_xsph_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, starts, n, *p, *k, npos, nvel, out);
  }
  return (int)cudaGetLastError();
}
