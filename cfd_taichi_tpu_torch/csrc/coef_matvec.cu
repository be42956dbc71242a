// K6 coef_matvec / coef_matvec_dot: the two per-iteration contractions of
// the stored-coefficient engine (ops/coef.py).
//
// Replace the three Pallas kernels of tools/perf_r5_mv3.py (the VPU
// contraction :66-69, the batched-dot contraction :72-77, and the fused
// kernel :97-125 that gathers the plane rows from a resident product table)
// and the XLA einsum they were measured against, bandmat.coef_matvec_ops
// (cfd_taichi_tpu/ops/bandmat.py:817-972). All compute
//   s[r, i] = sum_p w[p] lane_r(nbr[p])      p in [offsets[i], offsets[i+1])
// with lanes [k, x k, y k, z k] (matvec) or [vx, vy, vz, x . v] (dot), and
// finish with JAX's split over absolute coordinates:
//   matvec[i, c]  = x_ic s0 - s(1+c)
//   matvec_dot[i] = x_i s0 + y_i s1 + z_i s2 - s3
// As in the fused kernel, the lanes are formed from the source's position
// and k (or v) in registers, with no product table in memory. For a bf16
// engine each lane value is rounded to bf16 before the multiply, as the
// JAX engine rounds its product table to w's dtype (bandmat.py:913-914,
// 958-959). `lane_sums` writes the (N, 4) sums s instead of the final form.
// Bound on the card: one thread per row walks its ~28 stored pairs, and
// each pair is two dependent loads (nbr, then the source's position and k
// or v), one pair after another. The pair list is 8 bytes (f32) or 6
// (bf16) per pair, 0.23 GB at 1M, ~70 us at 3.35 TB/s; measured on the
// H100 (PERF.md) the kernels take 5-8x that, so load latency of the
// serial gather, not DRAM bandwidth, bounds them. The design's gain over
// K3 is the shorter walk (~28 stored pairs instead of ~216 candidates).
// A warp per row, tensor cores, TMA and shared-memory staging are left
// for later.
#include <cuda_bf16.h>

#include "stencil.cuh"

__device__ __forceinline__ float load_w(const float* w, int q) {
  return __ldg(w + q);
}

__device__ __forceinline__ float load_w(const __nv_bfloat16* w, int q) {
  return __bfloat162float(__ldg(w + q));
}

// A lane value in the engine's storage type.
__device__ __forceinline__ float lane(float x, const float*) { return x; }

__device__ __forceinline__ float lane(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coef_matvec_kernel(const float* __restrict__ pos, int n,
                   const int* __restrict__ offsets,
                   const int* __restrict__ nbr,
                   const T* __restrict__ w, const float* __restrict__ k,
                   float* __restrict__ out, int lane_sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  const int end = offsets[i + 1];
  for (int q = offsets[i]; q < end; ++q) {
    const int j = __ldg(nbr + q);
    const float wq = load_w(w, q);
    const float kj = __ldg(k + j);
    s0 += wq * lane(kj, w);
    s1 += wq * lane(__ldg(pos + 3 * j) * kj, w);
    s2 += wq * lane(__ldg(pos + 3 * j + 1) * kj, w);
    s3 += wq * lane(__ldg(pos + 3 * j + 2) * kj, w);
  }
  if (lane_sums) {
    out[4 * i] = s0;
    out[4 * i + 1] = s1;
    out[4 * i + 2] = s2;
    out[4 * i + 3] = s3;
    return;
  }
  out[3 * i] = pos[3 * i] * s0 - s1;
  out[3 * i + 1] = pos[3 * i + 1] * s0 - s2;
  out[3 * i + 2] = pos[3 * i + 2] * s0 - s3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coef_matvec_dot_kernel(const float* __restrict__ pos, int n,
                       const int* __restrict__ offsets,
                       const int* __restrict__ nbr, const T* __restrict__ w,
                       const float* __restrict__ v, float* __restrict__ out,
                       int lane_sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  const int end = offsets[i + 1];
  for (int q = offsets[i]; q < end; ++q) {
    const int j = __ldg(nbr + q);
    const float wq = load_w(w, q);
    const float vx = __ldg(v + 3 * j), vy = __ldg(v + 3 * j + 1),
                vz = __ldg(v + 3 * j + 2);
    const float xv = __ldg(pos + 3 * j) * vx + __ldg(pos + 3 * j + 1) * vy +
                     __ldg(pos + 3 * j + 2) * vz;
    s0 += wq * lane(vx, w);
    s1 += wq * lane(vy, w);
    s2 += wq * lane(vz, w);
    s3 += wq * lane(xv, w);
  }
  if (lane_sums) {
    out[4 * i] = s0;
    out[4 * i + 1] = s1;
    out[4 * i + 2] = s2;
    out[4 * i + 3] = s3;
    return;
  }
  out[i] = pos[3 * i] * s0 + pos[3 * i + 1] * s1 + pos[3 * i + 2] * s2 - s3;
}

extern "C" int coef_matvec_launch(const float* pos, int n, const int* offsets,
                                  const int* nbr, const void* w, int bf16,
                                  const float* k, float* out, int lane_sums,
                                  void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      coef_matvec_kernel<<<grid_blocks(n), kThreads, 0, s>>>(
          pos, n, offsets, nbr, (const __nv_bfloat16*)w, k, out, lane_sums);
    } else {
      coef_matvec_kernel<<<grid_blocks(n), kThreads, 0, s>>>(
          pos, n, offsets, nbr, (const float*)w, k, out, lane_sums);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int coef_matvec_dot_launch(const float* pos, int n,
                                      const int* offsets, const int* nbr,
                                      const void* w, int bf16, const float* v,
                                      float* out, int lane_sums,
                                      void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      coef_matvec_dot_kernel<<<grid_blocks(n), kThreads, 0, s>>>(
          pos, n, offsets, nbr, (const __nv_bfloat16*)w, v, out, lane_sums);
    } else {
      coef_matvec_dot_kernel<<<grid_blocks(n), kThreads, 0, s>>>(
          pos, n, offsets, nbr, (const float*)w, v, out, lane_sums);
    }
  }
  return (int)cudaGetLastError();
}
