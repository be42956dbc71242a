// K8 pbf_lambda: the lambda-dependent pair sum of a PBF step.
//
// Replaces lam_mv of bandmat.dense_pbf_ops (cfd_taichi_tpu/ops/bandmat.py:
// 1794-1796), an XLA window pass of the JAX package. Per sorted fluid
// particle i, over pairs j != i with r2 <= h2 at the start-of-step
// positions, with spiky_c the spiky gradient factor at r = sqrt(max(r2,
// 1e-24)):
//   out[i] = sum_j (lambda_j spiky_c) x_ij      (3 components)
// The rest of PBF's position change, lambda_i gsum + ssum, is row-constant
// (models/pbf.py).
//
// Bound on the card: f32 operations (a distance test and a ~30-operation
// pair term a pair, perf/bounds.py), far below what the walk of ~27 x
// occupancy candidates takes: matvec's case, with the spiky factor in
// place of the cubic one.
//
// Design: matvec's (queued_walk, stencil.cuh): one thread per query, a
// candidate loop that only tests and queues its hits, 8 candidates' loads
// in flight between two votes (the term is light), the gather of lambda_j
// and the pair term in the drain. Hits drain in walk order: a run repeats
// bit for bit. Sums stay in registers and each output is written once,
// with no atomics.
#include "stencil.cuh"

constexpr int kLambdaQueue = 40;  // hits a thread can hold
constexpr int kLambdaChunk = 8;   // candidates tested between two votes

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pbf_lambda_kernel(const float* __restrict__ pos,
                  const int* __restrict__ starts, int n, StencilParams p,
                  SpikyPoly6 k, const float* __restrict__ lam,
                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];

  float ox = 0.f, oy = 0.f, oz = 0.f;
  queued_walk<kLambdaQueue, kLambdaChunk>(
      pos, n, starts, p, live, i, xi, yi, zi,
      [&](int j, float dx, float dy, float dz, float r2, bool take) {
        const float lw = __ldg(lam + j) * spiky_grad_coeff(pair_r(r2), k);
        const float tx = lw * dx;
        const float ty = lw * dy;
        const float tz = lw * dz;
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

extern "C" int pbf_lambda_launch(const float* pos, const int* starts, int n,
                                 const StencilParams* p, const SpikyPoly6* k,
                                 const float* lam, float* out, void* stream) {
  if (n > 0) {
    pbf_lambda_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, starts, n, *p, *k, lam, out);
  }
  return (int)cudaGetLastError();
}
