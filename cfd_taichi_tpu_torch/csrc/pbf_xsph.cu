// K9 pbf_xsph: PBF's XSPH velocity sum at the updated positions, streamed
// over the step's stored pair list.
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
// The pair set is the one pbf_terms walks at x earlier in the step, and
// pbf_terms stores it (pbf_terms.cu): row i's t-th pair is nbr[base[i] +
// kListStride t], t < cnt[i], in walk order. So x is not read here: the
// kernel streams each row and gathers x'_j and v'_j (24 B) a pair.
//
// Bound on the card: f32 operations (a ~32-operation pair term a pair,
// perf/bounds.py) for the function; the bytes the stream must read (nbr
// 4 B a pair, base, cnt, x', v' and the output) bound this design
// (perf/bounds.py: stream bytes), ~48 us at 1M. The gathers are served from
// L2 (24 MB of x' and v' at 1M), so load latency sets the time.
//
// Design: stream_rows (stencil.cuh), as pbf_lambda.cu: kXsphGroup lanes a
// row, kXsphAhead nbr loads ahead of their gathers, shuffle sums, each
// output written once with no atomics. One lane a row adds the terms in
// walk order, bit for bit as the walk that this kernel replaced. Measured
// on an H100 at 1M (perf/coef_compare.py --kernel pbf), the list
// interleaved: one lane a row with 8 pairs ahead 139.4-140.9 us, with 4
// ahead 142.7, with 16 ahead 145.0; 2 lanes with 8 ahead 132.3 (6 % less,
// not bit for bit: kept to one lane), 4 lanes 155.9, 8 lanes with 4 ahead
// 217.1.
#include "stencil.cuh"

constexpr int kXsphGroup = 1;  // lanes per row
constexpr int kXsphAhead = 8;  // pairs a lane loads ahead

struct XsphStream {
  const float* npos;
  const float* nvel;
  SpikyPoly6 k;
  float* out;

  struct Row {
    float x, y, z;     // x'_i
    float vx, vy, vz;  // v'_i
  };
  struct Sums {
    float w, x, y, z;  // sum w, sum v'_j w
  };

  __device__ __forceinline__ Row load(int i) const {
    return {__ldg(npos + 3 * i), __ldg(npos + 3 * i + 1),
            __ldg(npos + 3 * i + 2), __ldg(nvel + 3 * i),
            __ldg(nvel + 3 * i + 1), __ldg(nvel + 3 * i + 2)};
  }
  __device__ __forceinline__ static Row shfl(const Row& r, int src) {
    return {__shfl_sync(kFullWarp, r.x, src), __shfl_sync(kFullWarp, r.y, src),
            __shfl_sync(kFullWarp, r.z, src),
            __shfl_sync(kFullWarp, r.vx, src),
            __shfl_sync(kFullWarp, r.vy, src),
            __shfl_sync(kFullWarp, r.vz, src)};
  }
  __device__ __forceinline__ void add(Sums& s, const Row& r, int j) const {
    const float dx = r.x - __ldg(npos + 3 * j);
    const float dy = r.y - __ldg(npos + 3 * j + 1);
    const float dz = r.z - __ldg(npos + 3 * j + 2);
    const float w = poly6_w(pair_r(dist2(dx, dy, dz)), k);
    s.w += w;
    s.x += __ldg(nvel + 3 * j) * w;
    s.y += __ldg(nvel + 3 * j + 1) * w;
    s.z += __ldg(nvel + 3 * j + 2) * w;
  }
  template <int kG>
  __device__ __forceinline__ static Sums reduce(const Sums& s) {
    return {lane_group_sum<kG>(s.w), lane_group_sum<kG>(s.x),
            lane_group_sum<kG>(s.y), lane_group_sum<kG>(s.z)};
  }
  __device__ __forceinline__ void store(int i, const Row& r,
                                        const Sums& s) const {
    out[3 * i] = s.x - r.vx * s.w;
    out[3 * i + 1] = s.y - r.vy * s.w;
    out[3 * i + 2] = s.z - r.vz * s.w;
  }
};

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pbf_xsph_kernel(int n, const int* __restrict__ base,
                const int* __restrict__ cnt, const int* __restrict__ nbr,
                XsphStream s) {
  stream_rows<kXsphGroup, kXsphAhead>(n, base, cnt, nbr, s);
}

extern "C" int pbf_xsph_launch(int n, const int* base, const int* cnt,
                               const int* nbr, const SpikyPoly6* k,
                               const float* npos, const float* nvel,
                               float* out, void* stream) {
  if (n > 0) {
    pbf_xsph_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        n, base, cnt, nbr, XsphStream{npos, nvel, *k, out});
  }
  return (int)cudaGetLastError();
}
