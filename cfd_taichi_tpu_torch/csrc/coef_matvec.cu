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
//
// Bound on the card: bytes. Each pair is read once (nbr 4 B, w 4 B in f32
// or 2 B in bf16) and does ~11 FLOPs, about 1 FLOP per byte, so neither the
// FP32 pipes nor the tensor cores (four right-hand sides; wgmma has nothing
// to do at this intensity) set the pace. At breaking_dam_1m (28.4 M pairs)
// the arrays come to ~259 MB in f32 and ~202 MB in bf16: 77 / 60 us at
// 3.35 TB/s.
//
// Design: a group of kGroup lanes per CSR row. Lane t of a group takes
// pairs offsets[i] + t, + t + kGroup, ..., so the group reads one contiguous
// stretch of nbr and w per step, and each lane walks ~28 / kGroup pairs
// instead of ~28. A lane loads kUnroll pairs' nbr and w before it gathers
// any source, so that their dependent gathers are in flight together; it
// still adds its pairs in order. The pair list is read with streaming loads
// (__ldcs, evict first), so that one pass over it does not push the
// gathered vectors (pos, k, v: ~28 MB at 1M) out of the 50 MB L2; the pairs
// come in walk order (9 runs of ascending slots, coef_build.cu), so a
// group's gathers land on neighbouring addresses. The four partial sums are
// reduced in the group with __shfl_xor_sync and lane 0 writes the row;
// groups past the last row take part in the shuffles with zero sums and
// skip only the store. The strided partial sums and the tree reduction
// round differently from a serial sum; the checks hold the lane sums to
// 1e-5 of each lane's scale.
// Measured on the H100 at 1M (PERF.md §6; perf/coef_compare.py over copies
// of this file at each kGroup and kUnroll), the gathers, not the pair
// stream, set the time: bf16 storage, which cuts the bytes by a fifth,
// gains 1-4 %; plain __ldg instead of __ldcs changes nothing; staging the
// stream in shared memory with cp.async (a persistent grid over tiles of
// rows, two stages; not kept) is 19-25 % slower than the same groups
// without it; two pairs in flight per lane gain 6-30 % over one at kGroup
// 8-16. kGroup 8 with kUnroll 2 was the fastest pair of the sweep: 143 /
// 153 us (f32 matvec / dot), 54 / 50 % of the byte bound.
#include <cuda_bf16.h>

#include "stencil.cuh"

constexpr int kGroup = 8;    // lanes per row: a power of two <= 32
constexpr int kUnroll = 2;   // pairs a lane loads before it gathers
constexpr int kRowsPerBlock = kThreads / kGroup;
static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "kGroup must be a power of two no larger than a warp");

__device__ __forceinline__ float load_w(const float* w, int q) {
  return __ldcs(w + q);
}

__device__ __forceinline__ float load_w(const __nv_bfloat16* w, int q) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(w) + q)));
}

// A lane value in the engine's storage type.
__device__ __forceinline__ float lane(float x, float) { return x; }

__device__ __forceinline__ float lane(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum over the kGroup lanes of a group; every lane of the warp must call it.
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, kGroup);
  return x;
}

// s += w times the four lanes of source j.
template <bool kDot, typename T>
__device__ __forceinline__ void add_pair(const float* __restrict__ pos,
                                         const float* __restrict__ x, int j,
                                         float wq, float s[4]) {
  const T t{};
  if constexpr (kDot) {
    const float vx = __ldg(x + 3 * j), vy = __ldg(x + 3 * j + 1),
                vz = __ldg(x + 3 * j + 2);
    const float xv = __ldg(pos + 3 * j) * vx + __ldg(pos + 3 * j + 1) * vy +
                     __ldg(pos + 3 * j + 2) * vz;
    s[0] += wq * lane(vx, t);
    s[1] += wq * lane(vy, t);
    s[2] += wq * lane(vz, t);
    s[3] += wq * lane(xv, t);
  } else {
    const float kj = __ldg(x + j);
    s[0] += wq * lane(kj, t);
    s[1] += wq * lane(__ldg(pos + 3 * j) * kj, t);
    s[2] += wq * lane(__ldg(pos + 3 * j + 1) * kj, t);
    s[3] += wq * lane(__ldg(pos + 3 * j + 2) * kj, t);
  }
}

// One row per group of kGroup lanes. kDot picks coef_matvec_dot's lanes and
// final form over coef_matvec's; x is k (N,) or v (N, 3).
template <bool kDot, typename T>
__device__ __forceinline__ void contract(const float* __restrict__ pos, int n,
                                         const int* __restrict__ offsets,
                                         const int* __restrict__ nbr,
                                         const T* __restrict__ w,
                                         const float* __restrict__ x,
                                         float* __restrict__ out,
                                         int lane_sums) {
  const int g = threadIdx.x & (kGroup - 1);
  const int i = blockIdx.x * kRowsPerBlock + threadIdx.x / kGroup;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < n) {
    const int end = __ldg(offsets + i + 1);
    for (int q0 = __ldg(offsets + i) + g; q0 < end;
         q0 += kGroup * kUnroll) {
      int j[kUnroll];
      float wq[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * kGroup;
        j[u] = q < end ? __ldcs(nbr + q) : -1;
        wq[u] = q < end ? load_w(w, q) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j[u] >= 0) add_pair<kDot, T>(pos, x, j[u], wq[u], s);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r] = group_sum(s[r]);
  if (i >= n || g != 0) return;
  if (lane_sums) {
#pragma unroll
    for (int r = 0; r < 4; ++r) out[4 * i + r] = s[r];
  } else if constexpr (kDot) {
    out[i] = pos[3 * i] * s[0] + pos[3 * i + 1] * s[1] +
             pos[3 * i + 2] * s[2] - s[3];
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * i + c] = pos[3 * i + c] * s[0] - s[1 + c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coef_matvec_kernel(const float* __restrict__ pos, int n,
                   const int* __restrict__ offsets,
                   const int* __restrict__ nbr, const T* __restrict__ w,
                   const float* __restrict__ k, float* __restrict__ out,
                   int lane_sums) {
  contract<false>(pos, n, offsets, nbr, w, k, out, lane_sums);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coef_matvec_dot_kernel(const float* __restrict__ pos, int n,
                       const int* __restrict__ offsets,
                       const int* __restrict__ nbr, const T* __restrict__ w,
                       const float* __restrict__ v, float* __restrict__ out,
                       int lane_sums) {
  contract<true>(pos, n, offsets, nbr, w, v, out, lane_sums);
}

template <bool kDot, typename T>
int launch(const float* pos, int n, const int* offsets, const int* nbr,
           const void* w, const float* x, float* out, int lane_sums,
           void* stream) {
  const auto kernel =
      kDot ? coef_matvec_dot_kernel<T> : coef_matvec_kernel<T>;
  if (n > 0) {
    const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        pos, n, offsets, nbr, (const T*)w, x, out, lane_sums);
  }
  return (int)cudaGetLastError();
}

extern "C" int coef_matvec_launch(const float* pos, int n, const int* offsets,
                                  const int* nbr, const void* w, int bf16,
                                  const float* k, float* out, int lane_sums,
                                  void* stream) {
  return bf16 ? launch<false, __nv_bfloat16>(pos, n, offsets, nbr, w, k, out,
                                             lane_sums, stream)
              : launch<false, float>(pos, n, offsets, nbr, w, k, out,
                                     lane_sums, stream);
}

extern "C" int coef_matvec_dot_launch(const float* pos, int n,
                                      const int* offsets, const int* nbr,
                                      const void* w, int bf16, const float* v,
                                      float* out, int lane_sums,
                                      void* stream) {
  return bf16 ? launch<true, __nv_bfloat16>(pos, n, offsets, nbr, w, v, out,
                                            lane_sums, stream)
              : launch<true, float>(pos, n, offsets, nbr, w, v, out,
                                    lane_sums, stream);
}
