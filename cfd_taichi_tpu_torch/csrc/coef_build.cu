// K5 coef_build: the per-step pair store of the stored-coefficient engine.
//
// Replaces bandmat.build_coef_engine (cfd_taichi_tpu/ops/bandmat.py:682-768),
// a dense (QB, B, nbcap*64) window pass over block plans that writes a
// masked coefficient into every slot of every window. Here one thread per
// cell-sorted query i walks the 27-cell stencil exactly as fluid_terms does
// (same pair test r2 <= h2 under -fmad=false, same j != i rule) and writes
//   nbr[offsets[i] + t] = j,   w[offsets[i] + t] = m gc(r_ij)
// in walk order: 9 runs, ascending slot in each. offsets is the exclusive
// cumsum of fluid_terms' counts, so row i has room for exactly its pairs;
// the writes also stop at offsets[i+1], so offsets that disagree cannot
// write out of bounds. bf16 storage rounds the f32 w to nearest even
// (__float2bfloat16_rn), as astype does.
// Bound on the card: the serial walk of ~27 x occupancy candidates per
// thread, as in K1, plus the stores. A thread's ~28 stores go to its own
// contiguous run of nbr and w, so the 32 threads of a warp write 32
// scattered 4-byte pieces per store (P x 8 bytes in f32, 0.23 GB at 1M).
// Measured on the H100 (PERF.md) that makes the build ~3.4x fluid_terms'
// time at 1M; staging a block's pairs for coalesced stores is left for
// later.
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  int c[3];
  cell_of(xi, yi, zi, p, c);

  int q = offsets[i];
  const int end = offsets[i + 1];
  for (int dm = -1; dm <= 1; ++dm) {
    for (int ds = -1; ds <= 1; ++ds) {
      int lo, hi;
      if (!stencil_run(c, dm, ds, starts, p, lo, hi)) continue;
      for (int j = lo; j < hi && q < end; ++j) {
        if (j == i) continue;
        const float dx = xi - __ldg(pos + 3 * j);
        const float dy = yi - __ldg(pos + 3 * j + 1);
        const float dz = zi - __ldg(pos + 3 * j + 2);
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (!(r2 <= p.h2)) continue;
        nbr[q] = j;
        store_w(w, q, m * cubic_grad_coeff(pair_r(r2), p));
        ++q;
      }
    }
  }
}

extern "C" int coef_build_launch(const float* pos, const int* starts, int n,
                                 const StencilParams* p, float m,
                                 const int* offsets, int* nbr, void* w,
                                 int bf16, void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      coef_build_kernel<<<grid_blocks(n), kThreads, 0, s>>>(
          pos, starts, n, *p, m, offsets, nbr, (__nv_bfloat16*)w);
    } else {
      coef_build_kernel<<<grid_blocks(n), kThreads, 0, s>>>(
          pos, starts, n, *p, m, offsets, nbr, (float*)w);
    }
  }
  return (int)cudaGetLastError();
}
