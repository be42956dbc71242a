// K5 coef_build: the per-step pair store of the stored-coefficient engine.
//
// Replaces bandmat.build_coef_engine (cfd_taichi_tpu/ops/bandmat.py:682-768),
// a dense (QB, B, nbcap*64) window pass over block plans that writes a
// masked coefficient into every slot of every window. Here each cell-sorted
// query i walks the 27-cell stencil with the same pair test as fluid_terms
// (r2 <= h2 under -fmad=false, j != i) and writes
//   nbr[offsets[i] + t] = j,   w[offsets[i] + t] = m gc(r_ij)
// in walk order: 9 runs, ascending slot in each. offsets is the exclusive
// cumsum of fluid_terms' counts, so row i has room for exactly its pairs;
// no store reaches offsets[i+1] or beyond, so offsets that disagree with
// the walk cannot write out of bounds. bf16 storage rounds the f32 w to
// nearest even (__float2bfloat16_rn), as astype does.
//
// Bound on the card: bytes (the pair store, P x 8 bytes in f32, 0.23 GB at
// breaking_dam_1m: 73 us at 3.35 TB/s). Neither form comes near it. One
// thread per query (the form before this one) walked ~216 candidates in
// series, ran gc on every lane whenever any lane of the warp held a pair,
// and wrote its own row, so a store instruction touched 32 rows ~28 pairs
// apart: 1.9 ms at 1M on the H100 (PERF.md).
//
// Design: a group of kGroupWalk lanes per query (group_walk, stencil.cuh):
// a round tests G neighbouring candidates with one contiguous pos read,
// the group queues its hits in walk order, and the warp hands them out in
// batches, lane l of a group taking the query's next hit, number q + l:
//   nbr[q + l] = j,  w[q + l] = m gc(r),  q += taken
// so a batch's stores land contiguous within the row, in walk order (the
// order the checks hold exactly), and the square root and divisions of gc
// run on lanes that nearly all hold a pair. Groups past n walk nothing and
// store nothing. Measured at 1M on the H100 (PERF.md §6,
// perf/coef_compare.py): 0.71 ms, 2.7x faster than one thread per query.
// Of the walk before its round was trimmed (0.75 ms), the tests and
// ballots took 0.41 ms, the queue and batches 0.08, the nbr store 0.14,
// gc and the w store 0.13. A warp per cell with the candidates staged in
// shared memory, two candidates a lane a round, a deeper queue and
// lane-contiguous chunks were slower, or at most 3 % faster on the
// lattice and slower on dense cells.
#include <cuda_bf16.h>

#include "stencil.cuh"

__device__ __forceinline__ void store_w(float* w, int q, float v) {
  w[q] = v;
}

__device__ __forceinline__ void store_w(__nv_bfloat16* w, int q, float v) {
  w[q] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coef_build_kernel(const float* __restrict__ pos,
                  const int* __restrict__ starts, int n, StencilParams p,
                  float m, const int* __restrict__ offsets,
                  int* __restrict__ nbr, T* __restrict__ w) {
  const WalkGroup g = walk_group(n);
  const int i = g.i;
  int q = g.live ? __ldg(offsets + i) : 0;
  const int end = g.live ? __ldg(offsets + i + 1) : 0;
  const float xi = g.live ? pos[3 * i] : 0.f;
  const float yi = g.live ? pos[3 * i + 1] : 0.f;
  const float zi = g.live ? pos[3 * i + 2] : 0.f;
  group_walk(pos, n, starts, p, g, xi, yi, zi, [&](const Pair& k, int taken) {
    const int slot = q + g.lane;
    if (k.hit && slot < end) {
      nbr[slot] = k.j;
      store_w(w, slot, m * cubic_grad_coeff(pair_r(k.r2), p));
    }
    q += taken;
  });
}

extern "C" int coef_build_launch(const float* pos, const int* starts, int n,
                                 const StencilParams* p, float m,
                                 const int* offsets, int* nbr, void* w,
                                 int bf16, void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      coef_build_kernel<<<walk_blocks(n), kThreads, 0, s>>>(
          pos, starts, n, *p, m, offsets, nbr, (__nv_bfloat16*)w);
    } else {
      coef_build_kernel<<<walk_blocks(n), kThreads, 0, s>>>(
          pos, starts, n, *p, m, offsets, nbr, (float*)w);
    }
  }
  return (int)cudaGetLastError();
}
