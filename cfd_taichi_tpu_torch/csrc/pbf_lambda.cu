// K8 pbf_lambda: the lambda-dependent pair sum of a PBF step, streamed over
// the step's stored pair list.
//
// Replaces lam_mv of bandmat.dense_pbf_ops (cfd_taichi_tpu/ops/bandmat.py:
// 1794-1796), an XLA window pass of the JAX package. Per sorted fluid
// particle i, over pairs j != i with r2 <= h2 at the start-of-step
// positions x, with spiky_c the spiky gradient factor at r = sqrt(max(r2,
// 1e-24)):
//   out[i] = sum_j (lambda_j spiky_c) x_ij      (3 components)
// The rest of PBF's position change, lambda_i gsum + ssum, is row-constant
// (models/pbf.py).
//
// The pair set is the one pbf_terms walks at the same positions earlier in
// the step, and pbf_terms stores it (pbf_terms.cu): row i's t-th pair is
// nbr[base[i] + kListStride t], t < cnt[i], in walk order. So no candidate
// is tested here: the kernel streams each row and gathers x_j (12 B) and
// lambda_j (4 B) a pair.
//
// Bound on the card: f32 operations (a distance test and a ~30-operation
// pair term a pair, perf/bounds.py) for the function; the bytes the stream
// must read (nbr 4 B a pair, base, cnt, x, lambda and the output) bound
// this design (perf/bounds.py: stream bytes), ~45 us at 1M. The gathers are
// served from L2 (16 MB of x and lambda at 1M), so load latency sets the
// time, and the loads a lane has in flight decide it.
//
// Design: stream_rows (stencil.cuh), the shape of the predicted density's
// stream form (pcisph_predict.cu): kLambdaGroup lanes a row, kLambdaAhead
// nbr loads ahead of their gathers, shuffle sums, each output written once
// with no atomics. One lane a row adds the terms in walk order, bit for bit
// as the walk that this kernel replaced. Measured on an H100 (PERF.md
// section 6, perf/coef_compare.py --kernel pbf): with a warp's rows
// interleaved in the list, one lane a row with 16 pairs ahead took 98.7
// us at 1M (10.7 at 30k, 254 on the clustered cloud), with 8 ahead 101.6-
// 102.9 (13.3, 312), with 4 ahead 101.0 (15.6, 374); 2 lanes with 8 ahead
// 102.2, 4 lanes 129.5, 8 lanes with 4 ahead 192.2; with each row's pairs
// a run of their own (nbr[base[i] + t]), 4 lanes with 8 ahead 122.0 and
// one lane 179.5: the interleaved list gives one lane's 32 rows whole
// lines to read.
#include "stencil.cuh"

constexpr int kLambdaGroup = 1;  // lanes per row
constexpr int kLambdaAhead = 16;  // pairs a lane loads ahead

struct LambdaStream {
  const float* pos;
  const float* lam;
  SpikyPoly6 k;
  float* out;

  struct Row {
    float x, y, z;  // x_i
  };
  struct Sums {
    float x, y, z;
  };

  __device__ __forceinline__ Row load(int i) const {
    return {__ldg(pos + 3 * i), __ldg(pos + 3 * i + 1),
            __ldg(pos + 3 * i + 2)};
  }
  __device__ __forceinline__ static Row shfl(const Row& r, int src) {
    return {__shfl_sync(kFullWarp, r.x, src), __shfl_sync(kFullWarp, r.y, src),
            __shfl_sync(kFullWarp, r.z, src)};
  }
  __device__ __forceinline__ void add(Sums& s, const Row& r, int j) const {
    const float dx = r.x - __ldg(pos + 3 * j);
    const float dy = r.y - __ldg(pos + 3 * j + 1);
    const float dz = r.z - __ldg(pos + 3 * j + 2);
    const float lw =
        __ldg(lam + j) * spiky_grad_coeff(pair_r(dist2(dx, dy, dz)), k);
    s.x += lw * dx;
    s.y += lw * dy;
    s.z += lw * dz;
  }
  template <int kG>
  __device__ __forceinline__ static Sums reduce(const Sums& s) {
    return {lane_group_sum<kG>(s.x), lane_group_sum<kG>(s.y),
            lane_group_sum<kG>(s.z)};
  }
  __device__ __forceinline__ void store(int i, const Row&,
                                        const Sums& s) const {
    out[3 * i] = s.x;
    out[3 * i + 1] = s.y;
    out[3 * i + 2] = s.z;
  }
};

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pbf_lambda_kernel(int n, const int* __restrict__ base,
                  const int* __restrict__ cnt, const int* __restrict__ nbr,
                  LambdaStream s) {
  stream_rows<kLambdaGroup, kLambdaAhead>(n, base, cnt, nbr, s);
}

extern "C" int pbf_lambda_launch(const float* pos, int n, const int* base,
                                 const int* cnt, const int* nbr,
                                 const SpikyPoly6* k, const float* lam,
                                 float* out, void* stream) {
  if (n > 0) {
    pbf_lambda_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        n, base, cnt, nbr, LambdaStream{pos, lam, *k, out});
  }
  return (int)cudaGetLastError();
}
