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
// Design: one block of kBoxThreads up to kBoxOneBlock particles, and
// above that a thread-block cluster of up to kBoxCluster blocks, one for
// every kBoxThreads x kBoxUnroll particles (box_blocks), so that the read
// of a large body is spread over as many SMs: the first form, one block of
// 1024 threads, took 4.96 us on the 1M block's 39,146 voxels against 2.26
// on the 30k block's 3,200 (PERF.md section 6), the whole read through one
// SM, while a cluster's launch and barriers cost some 0.7-1.5 us more than
// a block's: 3.44 us for a cluster of two on 8,193 particles against 2.71
// for one block of 512 threads. The grid is the cluster. Block b of c folds its slice of the particles (box_slice: the
// b-th of c nearly equal runs) into six running extremes, each thread
// every kBoxThreads-th particle with kBoxUnroll particles' loads in flight
// at a time; the block folds its threads' by warp shuffles and shared
// memory. After a cluster barrier, block 0 reads the other blocks' six
// extremes from their shared memory (distributed shared memory,
// map_shared_rank), folds them, grows the box and writes it; a second
// barrier keeps every block's shared memory alive until then. One block
// is launched without a cluster and takes no cluster barrier. No atomics
// and no counter: a launch inside a captured CUDA graph is as legal as any
// other, and min and max are exact in any order, so the box keeps its bits
// however it is cut.
#include <cooperative_groups.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

constexpr int kBoxThreads = 512;
constexpr int kBoxUnroll = 8;        // particles a thread loads at a time
constexpr int kBoxOneBlock = 16384;  // most particles one block takes
constexpr int kBoxCluster = 16;  // most blocks a cluster (over 8: non-portable)

// The blocks that fold a body of nr > 0 particles: one up to kBoxOneBlock,
// else a cluster of one for each kBoxThreads x kBoxUnroll, at most
// kBoxCluster.
inline int box_blocks(int nr) {
  if (nr <= kBoxOneBlock) return 1;
  constexpr int per = kBoxThreads * kBoxUnroll;
  return min(kBoxCluster, (nr + per - 1) / per);
}

// Block b's slice [lo, hi) of nr particles cut among c blocks.
__device__ __forceinline__ void box_slice(int nr, int c, int b, int& lo,
                                          int& hi) {
  const int per = (nr + c - 1) / c;
  lo = min(b * per, nr);
  hi = min(lo + per, nr);
}

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

// The box of the six extremes e (on lane 0), written by lane 0.
__device__ __forceinline__ void write_box(const float e[6], float grow_h,
                                          float slack,
                                          float* __restrict__ box) {
  if ((threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g = grow_h + fmaxf(fabsf(e[a]), fabsf(e[a + 3])) * slack;
    box[a] = e[a] - g;
    box[a + 3] = e[a + 3] + g;
  }
}

__global__ void __launch_bounds__(kBoxThreads)
body_box_kernel(const float* __restrict__ rpos, int nr, float grow_h,
                float slack, float* __restrict__ box) {
  const int blocks = gridDim.x, rank = blockIdx.x;  // the grid: one cluster
  int lo, hi;
  box_slice(nr, blocks, rank, lo, hi);
  const float inf = __int_as_float(0x7f800000);
  float e[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int i0 = lo + threadIdx.x; i0 < hi; i0 += kBoxUnroll * kBoxThreads) {
#pragma unroll
    for (int u = 0; u < kBoxUnroll; ++u) {
      const int i = i0 + u * kBoxThreads;
      if (i < hi) {
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
  __shared__ float folded[6];  // the block's extremes, read by block 0
  warp_extremes(e);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) warps[warp][a] = e[a];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a)
      e[a] = lane < kBoxThreads / 32 ? warps[lane][a] : (a < 3 ? inf : -inf);
    warp_extremes(e);
    if (blocks == 1) {
      write_box(e, grow_h, slack, box);
      return;
    }
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 6; ++a) folded[a] = e[a];
    }
  }
  if (blocks == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's extremes in its shared memory
  if (rank == 0 && warp == 0) {
    // lane b folds block b's extremes
    const float* other =
        lane < blocks ? cluster.map_shared_rank(&folded[0], lane) : nullptr;
#pragma unroll
    for (int a = 0; a < 6; ++a)
      e[a] = other ? other[a] : (a < 3 ? inf : -inf);
    warp_extremes(e);
    write_box(e, grow_h, slack, box);
  }
  cluster.sync();  // block 0 is done with the others' shared memory
}

extern "C" int body_box_launch(const float* rpos, int nr, float grow_h,
                               float slack, float* box, void* stream) {
  if (nr <= 0) return (int)cudaGetLastError();
  const int blocks = box_blocks(nr);
  if (blocks == 1) {
    body_box_kernel<<<1, kBoxThreads, 0, (cudaStream_t)stream>>>(
        rpos, nr, grow_h, slack, box);
    return (int)cudaGetLastError();
  }
  if (blocks > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        body_box_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBoxThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, body_box_kernel, rpos, nr, grow_h, slack, box);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The blocks that fold a body of nr > 0 particles, for a run to print.
extern "C" int body_box_blocks(int nr) { return box_blocks(nr); }
