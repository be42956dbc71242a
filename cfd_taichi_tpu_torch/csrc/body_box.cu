// R5 body_box: the body's gate, made once a coupled step.
//
// The fluid side's walks of the body (rigid_contact_dot, rigid_viscosity,
// pcisph_predict_rho's body walk) take only warps with a query inside the
// box of the body's Nr positions grown by g = f32(h (1 + 2^-10)) + 2^-20
// max(|lo|, |hi|) on each axis (stencil.make_body_box, whose note says why
// that margin holds every query with a pair). It stands in for
// rigid_dense.build_rigid_windows (cfd_taichi_tpu/ops/rigid_dense.py:
// 63-106), which selects the fluid groups with a rigid neighbour. Out:
//   box = [lo - g, hi + g]   (2, 3) f32, lo / hi the axis min / max.
// Min and max are exact in any order and g is one product and one sum
// (-fmad=false), so the box is the plain version's, bit for bit.
//
// Bound on the card: the body's positions in, six floats out (perf/
// bounds.py), well under a microsecond even at 40k particles; a launch
// costs more. The plain version's eight small PyTorch kernels took ~15
// device us a step at 3,200 particles and ~45 at 39,146 (two reductions
// along the short axis among them; PERF.md section 6).
//
// Design: one block, so that no partial extremes cross blocks: each
// thread folds every kBoxThreads-th particle into six running extremes,
// kBoxUnroll particles' loads in flight at a time, then the block folds
// the threads' by warp shuffles and shared memory, and thread 0 grows the
// box and writes it.
#include "stencil.cuh"

constexpr int kBoxThreads = 1024;
constexpr int kBoxUnroll = 8;  // particles a thread loads at a time

// This lane's six extremes (lo x, y, z, hi x, y, z) folded over its warp.
__device__ __forceinline__ void warp_extremes(float e[6]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      e[a] = fminf(e[a], __shfl_xor_sync(kFullWarp, e[a], off));
      e[a + 3] = fmaxf(e[a + 3], __shfl_xor_sync(kFullWarp, e[a + 3], off));
    }
  }
}

__global__ void __launch_bounds__(kBoxThreads)
body_box_kernel(const float* __restrict__ rpos, int nr, float grow_h,
                float slack, float* __restrict__ box) {
  const float inf = __int_as_float(0x7f800000);
  float e[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int i0 = threadIdx.x; i0 < nr; i0 += kBoxUnroll * kBoxThreads) {
#pragma unroll
    for (int u = 0; u < kBoxUnroll; ++u) {
      const int i = i0 + u * kBoxThreads;
      if (i < nr) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float x = __ldg(rpos + 3 * i + a);
          e[a] = fminf(e[a], x);
          e[a + 3] = fmaxf(e[a + 3], x);
        }
      }
    }
  }
  __shared__ float warps[kBoxThreads / 32][6];
  warp_extremes(e);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) warps[warp][a] = e[a];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int a = 0; a < 6; ++a) e[a] = warps[lane][a];
  warp_extremes(e);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float g = grow_h + fmaxf(fabsf(e[a]), fabsf(e[a + 3])) * slack;
      box[a] = e[a] - g;
      box[a + 3] = e[a + 3] + g;
    }
  }
}

extern "C" int body_box_launch(const float* rpos, int nr, float grow_h,
                               float slack, float* box, void* stream) {
  if (nr > 0) {
    body_box_kernel<<<1, kBoxThreads, 0, (cudaStream_t)stream>>>(
        rpos, nr, grow_h, slack, box);
  }
  return (int)cudaGetLastError();
}
