// Shared pieces of the CSR-stencil pair kernels (ops/stencil.py).
//
// A query particle finds its cell (floor(x * 1/h), clamped into the grid
// like cfd_taichi_tpu/ops/neighbors.py:98-108), then visits the 27-cell
// stencil as 9 contiguous runs of the source CSR table: the fast axis has
// stride 1, so the three cells of one stencil row are adjacent in the
// sorted order. fluid_terms, boundary_terms, matvec, matvec_dot,
// wcsph_forces, pcisph_predict_rho, pbf_terms, pbf_lambda and pbf_xsph run
// one thread per cell-sorted query that queues its hits and takes the pair
// term out of the candidate loop (queued_walk_of below); coef_build and
// viscosity run a group of kGroupWalk lanes per query (group_walk below).
// Sums stay in f32 registers and each query's row is written by its own
// thread or group, so there are no atomics and every run gives
// bit-identical results.
//
// Built with -fmad=false: r2 = dx*dx + dy*dy + dz*dz must round like the
// plain PyTorch and JAX versions, because the seed lattice has many pairs
// at exactly r == h whose inclusion (and the integer neighbour count that
// gates DFSPH's < 20-neighbour skip) an FMA could flip.
#pragma once

#include <cuda_runtime.h>

// Layout mirrors ops/_build.py:StencilParams (ctypes): 9 ints, 7 floats.
struct StencilParams {
  int dims[3];     // cells per axis
  int strides[3];  // linearization strides; strides[fast] == 1
  int fast, mid, slow;
  float inv_cell;  // f32(1 / h)
  float h;         // support radius
  float h2;        // f32(h) * f32(h)
  float kw;        // f32(8 / (pi h^3))
  float kw2;       // f32(2 * 8 / (pi h^3))
  float kg6;       // f32(6 * 48 / (pi h^3))
  float kgm6;      // f32(-6 * 48 / (pi h^3))
};

__device__ __forceinline__ void cell_of(float x, float y, float z,
                                        const StencilParams& p, int c[3]) {
  const float v[3] = {x, y, z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int ci = (int)floorf(v[a] * p.inv_cell);
    c[a] = min(max(ci, 0), p.dims[a] - 1);
  }
}

// Source range [lo, hi) of stencil row (dm, ds) around cell c, where dm and
// ds step the mid and slow axes. Returns false when the row leaves the grid.
__device__ __forceinline__ bool stencil_run(const int c[3], int dm, int ds,
                                            const int* __restrict__ starts,
                                            const StencilParams& p, int& lo,
                                            int& hi) {
  const int cm = c[p.mid] + dm;
  const int cs = c[p.slow] + ds;
  if (cm < 0 || cm >= p.dims[p.mid] || cs < 0 || cs >= p.dims[p.slow])
    return false;
  const int base = cm * p.strides[p.mid] + cs * p.strides[p.slow];
  const int f0 = max(c[p.fast] - 1, 0);
  const int f1 = min(c[p.fast] + 1, p.dims[p.fast] - 1);
  lo = __ldg(starts + base + f0);
  hi = __ldg(starts + base + f1 + 1);
  return true;
}

// Cubic spline W (cfd_taichi_tpu/ops/smoothing.py:23-38).
__device__ __forceinline__ float cubic_w(float r, const StencilParams& p) {
  const float q = r / p.h;
  const float q2 = q * q;
  const float q3 = q2 * q;
  const float near_w = p.kw * (6.0f * (q3 - q2) + 1.0f);
  const float omq = 1.0f - q;
  const float far_w = p.kw2 * omq * omq * omq;
  const float w = (q <= 0.5f) ? near_w : far_w;
  return (q <= 1.0f) ? w : 0.0f;
}

// cubic_w with q = r * inv_h, inv_h = f32(1) / f32(h): the product XLA
// makes of JAX's r / h (ops/smoothing.py:cubic_w_mul).
__device__ __forceinline__ float cubic_w_mul(float r, const StencilParams& p,
                                             float inv_h) {
  const float q = r * inv_h;
  const float q2 = q * q;
  const float q3 = q2 * q;
  const float near_w = p.kw * (6.0f * (q3 - q2) + 1.0f);
  const float omq = 1.0f - q;
  const float far_w = p.kw2 * omq * omq * omq;
  const float w = (q <= 0.5f) ? near_w : far_w;
  return (q <= 1.0f) ? w : 0.0f;
}

// Gradient factor c(r), grad W = c(r) * x_ij, with the 1e-5 < q guard
// (cfd_taichi_tpu/ops/smoothing.py:65-76).
__device__ __forceinline__ float cubic_grad_coeff(float r,
                                                  const StencilParams& p) {
  const float q = r / p.h;
  const float near_g = p.kg6 * (3.0f * q * q - 2.0f * q);
  const float omq = 1.0f - q;
  const float far_g = p.kgm6 * omq * omq;
  float coeff = (q <= 0.5f) ? near_g : far_g;
  coeff = (q > 1e-5f && q <= 1.0f) ? coeff : 0.0f;
  return coeff / (p.h * fmaxf(r, 1e-12f));
}

// Constants of PBF's spiky and poly6 kernels, f32 on the host
// (ops/smoothing.py:SpikyPoly6Constants, whose note says why they are
// reciprocals); layout mirrors ops/_build.py:SpikyPoly6 (ctypes), 4 floats.
struct SpikyPoly6 {
  float inv_h;     // f32(1) / f32(h)
  float inv_pih4;  // f32(1) / f32(pi h^4)
  float inv_pih3;  // f32(1) / f32(pi h^3)
  float kp6;       // f32(315 / (64 pi h^3))
};

// Spiky gradient factor c(r), grad W = c(r) * x_ij, zero unless 0 < q <= 1
// (cfd_taichi_tpu/ops/smoothing.py:79-87).
__device__ __forceinline__ float spiky_grad_coeff(float r,
                                                  const SpikyPoly6& k) {
  const float q = r * k.inv_h;
  const float omq = 1.0f - q;
  float coeff = -45.0f * omq * omq * k.inv_pih4;
  coeff = (q > 0.0f && q <= 1.0f) ? coeff : 0.0f;
  return coeff / fmaxf(r, 1e-12f);
}

// Spiky W = 15 (1-q)^3 / (pi h^3), q <= 1 (smoothing.py:90-95).
__device__ __forceinline__ float spiky_w(float r, const SpikyPoly6& k) {
  const float q = r * k.inv_h;
  const float omq = 1.0f - q;
  const float w = 15.0f * omq * omq * omq * k.inv_pih3;
  return (q <= 1.0f) ? w : 0.0f;
}

// Poly6 W = 315 / (64 pi h^3) (1-q^2)^3, q <= 1 (smoothing.py:109-115).
__device__ __forceinline__ float poly6_w(float r, const SpikyPoly6& k) {
  const float q = r * k.inv_h;
  const float t = 1.0f - q * q;
  const float w = k.kp6 * t * t * t;
  return (q <= 1.0f) ? w : 0.0f;
}

__device__ __forceinline__ float pair_r(float r2) {
  return sqrtf(fmaxf(r2, 1e-24f));
}

constexpr int kThreads = 128;
constexpr unsigned kFullWarp = 0xffffffffu;

inline int grid_blocks(int n) { return (n + kThreads - 1) / kThreads; }

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return dx * dx + dy * dy + dz * dz;
}

// ---------------------------------------------------------------------------
// The queued walk: one thread per query, the pair term out of the
// candidate loop.
//
// About one candidate in eight is a pair, so with 32 lanes nearly every
// candidate is a pair on some lane: a pair term behind `if (r2 <= h2)` in
// the candidate loop is run by the warp about once a candidate, seven
// or eight times more often than pairs exist. Here the candidate loop
// only tests: kChunk candidates at a time, their pos loads clamped and
// independent, so all of them are in flight together, and a hit's source
// slot j goes into a queue of the thread's own in shared memory
// (queue[depth][thread]: a warp's lanes fall in 32 different banks
// whatever their depths). After a chunk the warp votes: when some lane
// could not take another chunk's hits, every lane drains its queue through
// the caller's pair function, the warp looping as often as its fullest
// lane holds hits. The warp then runs the pair term about (most hits on
// a lane) times a drain, not once a candidate, and no ballot, rank or
// exchange between lanes is needed: the queue is private.
//
// A thread's hits leave the queue in the order they went in, the walk
// order (dm outer, ds inner, ascending j), so its sums are added exactly
// as a thread that ran the pair term in the candidate loop would add them:
// the results are bit-equal to that form's.
//
// The whole warp walks together: a run takes the most chunks any lane of
// the warp needs, so every lane reaches every vote. A lane whose candidate
// lies past its run's end, is the query itself, or which has no query
// (live == false) takes part with hit = false. (So a stencil row that one
// lane could skip, being farther than h from its query, saves nothing
// unless all 32 lanes skip it: measured, no gain.)
//
// The constants, as measured on an NVIDIA H100 80GB HBM3 (PERF.md section
// 6). A queue that holds a lattice query's ~28-45 pairs drains about
// once, at the end, on lanes that are mostly full; a shorter one drains
// mid-walk on part-filled lanes: fluid_terms at breaking_dam_1m took 484
// us at 32 hits a thread, 413 at 40, 414 at 48. Left alone, ptxas cuts
// the registers to what the shared memory's block count allows (40 at 13
// blocks) and then cannot keep a chunk's loads in flight: 8 blocks an SM
// give it up to 64 (27 against 38 us at 30k particles, where a walk
// waits on its loads). Chunks of 6 waste fewer slots behind the warp's
// longest run of ~24-27 candidates than chunks of 8 (413 against 424 us);
// two terms a drain turn hide a little of each other's latency (3 %).
// matvec and matvec_dot, whose pair term is lighter, take chunks of 8
// (kWalkChunk; matvec.cu says what they measured).
// ---------------------------------------------------------------------------

constexpr int kChunk = 6;        // candidates tested between two votes
constexpr int kDrainUnroll = 2;  // hits a thread's drain turn works on
constexpr int kQueuedBlocks = 8;  // blocks an SM must hold: caps registers

// Sources of the queued walk. src(j) gives source j's record: .x, .y, .z
// are its position, and the walk hands the record to the pair function
// beside x_ij, so that whatever else it holds is not loaded again.
struct XyzRows {  // (ns, 3) f32 rows: three scalar loads a source
  const float* pos;
  struct Record {
    float x, y, z;
  };
  __device__ __forceinline__ Record operator()(int j) const {
    return {__ldg(pos + 3 * j), __ldg(pos + 3 * j + 1), __ldg(pos + 3 * j + 2)};
  }
};

struct Float4Rows {  // (ns, 4) f32 records, 16-byte aligned: one 16-byte load
  const float4* rec;
  using Record = float4;
  __device__ __forceinline__ float4 operator()(int j) const {
    return __ldg(rec + j);
  }
};

// Walk the query at (xi, yi, zi) (any values where !live) over the 27-cell
// stencil of the cell-sorted sources src(0..ns) with CSR table starts.
// Every lane of the warp must call it. pair(j, rec, dx, dy, dz, r2, take)
// is called with take = true once per source j within h, in walk order,
// and with take = false (on source 0) where a drain turn has no hit left
// for the lane: it computes its terms in either case, so that the turn's
// kUnroll terms overlap, and adds them only under take. rec is src(j).
// self is the query's own slot where the sources are the queries, else
// -1. kQueueDepth is the hits a thread can hold, 4 bytes each in shared
// memory; kWalkChunk the candidates tested between two votes; kUnroll the
// hits a thread's drain turn works on.
template <int kQueueDepth, int kWalkChunk, int kUnroll, typename Source,
          typename PairFn>
__device__ __forceinline__ void queued_walk_of(const Source& src, int ns,
                                               const int* __restrict__ starts,
                                               const StencilParams& p,
                                               bool live, int self, float xi,
                                               float yi, float zi,
                                               PairFn&& pair) {
  static_assert(kWalkChunk >= 1 && kWalkChunk < kQueueDepth,
                "a queue must take a chunk's hits after a vote let it pass");
  __shared__ int queue[kQueueDepth * kThreads];
  int* const q = queue + threadIdx.x;
  const float h2 = p.h2;
  int held = 0;

  auto drain = [&]() {
    const int most = __reduce_max_sync(kFullWarp, held);
    for (int d = 0; d < most; d += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool take = d + u < held;
        const int j = take ? q[(d + u) * kThreads] : 0;
        const auto s = src(j);
        const float dx = xi - s.x;
        const float dy = yi - s.y;
        const float dz = zi - s.z;
        pair(j, s, dx, dy, dz, dist2(dx, dy, dz), take);
      }
    }
    held = 0;
  };

  int c[3];
  cell_of(xi, yi, zi, p, c);
  for (int dm = -1; dm <= 1; ++dm) {
    for (int ds = -1; ds <= 1; ++ds) {
      int lo = 0, hi = 0;
      if (!live || !stencil_run(c, dm, ds, starts, p, lo, hi)) lo = hi = 0;
      const int most = __reduce_max_sync(kFullWarp, hi - lo);
      for (int t = 0; t < most; t += kWalkChunk) {
#pragma unroll
        for (int u = 0; u < kWalkChunk; ++u) {
          const int j = lo + t + u;
          const int jl = min(j, ns - 1);
          const auto s = src(jl);
          const float dx = xi - s.x;
          const float dy = yi - s.y;
          const float dz = zi - s.z;
          const bool hit = (j < hi) & (j != self) & (dist2(dx, dy, dz) <= h2);
          if (hit) q[held * kThreads] = j;
          held += hit;
        }
        if (__any_sync(kFullWarp, held > kQueueDepth - kWalkChunk)) drain();
      }
    }
  }
  drain();
}

// queued_walk_of over (ns, 3) f32 positions spos, with kDrainUnroll hits a
// drain turn; pair(j, dx, dy, dz, r2, take) as above, without the record.
template <int kQueueDepth, int kWalkChunk = kChunk, typename PairFn>
__device__ __forceinline__ void queued_walk(const float* __restrict__ spos,
                                            int ns,
                                            const int* __restrict__ starts,
                                            const StencilParams& p, bool live,
                                            int self, float xi, float yi,
                                            float zi, PairFn&& pair) {
  queued_walk_of<kQueueDepth, kWalkChunk, kDrainUnroll>(
      XyzRows{spos}, ns, starts, p, live, self, xi, yi, zi,
      [&](int j, const XyzRows::Record&, float dx, float dy, float dz,
          float r2, bool take) { pair(j, dx, dy, dz, r2, take); });
}

// ---------------------------------------------------------------------------
// The group walk: kGroupWalk consecutive lanes of a warp share one query.
//
// Lane l of a round tests candidate lo + round * G + l of the run [lo, hi),
// so the group's pos loads are one contiguous 12 G-byte read and G
// candidates are in flight a round, not one as in a thread's serial walk.
//
// About one candidate in eight is a pair, and a pair's term (a square
// root, divisions, more loads, a store) costs several times a distance
// test. Run where its test found it, the term would take the issue slots of
// a whole warp for the one or two lanes of a round that hold a pair. So a
// group queues its hits in a ring in shared memory, in walk order, and the
// warp hands them to the caller's pair function in batches: whenever a
// group of the warp holds G hits, every group passes its oldest min(held,
// G) to its lanes 0, 1, ..., and once more at the end.
//
// The runs come in the one-thread order (dm outer, ds inner, ascending j),
// ascending lanes of a round hold ascending j, and a ballot ranks a round's
// hits, so a group's hits reach the pair function in walk order: the
// query's hit number done + l on lane l (coef_build's slots).
//
// The whole warp walks together: for each of the 9 runs it takes the most
// rounds any of its groups needs, so every lane reaches every ballot, vote
// and batch. A lane whose candidate lies past its run's end, is the query
// itself, or belongs to a group past n takes part with hit = false.
// ---------------------------------------------------------------------------

constexpr int kGroupWalk = 8;  // lanes per query: a power of two <= 32
static_assert(kGroupWalk >= 1 && kGroupWalk <= 32 &&
                  (kGroupWalk & (kGroupWalk - 1)) == 0,
              "kGroupWalk must be a power of two no larger than a warp");
constexpr int kQueriesPerBlock = kThreads / kGroupWalk;

inline int walk_blocks(int n) {
  return (n + kQueriesPerBlock - 1) / kQueriesPerBlock;
}

struct WalkGroup {
  int i;          // the group's cell-sorted query
  bool live;      // i < n: the group has a query
  int lane;       // 0 .. kGroupWalk - 1
  unsigned mask;  // the group's lanes within its warp
};

__device__ __forceinline__ WalkGroup walk_group(int n) {
  WalkGroup g;
  g.i = blockIdx.x * kQueriesPerBlock + threadIdx.x / kGroupWalk;
  g.live = g.i < n;
  g.lane = threadIdx.x & (kGroupWalk - 1);
  const int base = (threadIdx.x & 31) & ~(kGroupWalk - 1);
  g.mask = kGroupWalk == 32 ? 0xffffffffu
                            : ((1u << kGroupWalk) - 1u) << base;
  return g;
}

// Sum of x over the group's lanes, on every lane of the group.
__device__ __forceinline__ float walk_sum(float x, const WalkGroup& g) {
#pragma unroll
  for (int off = kGroupWalk / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(g.mask, x, off, kGroupWalk);
  return x;
}

// A pair handed to the pair function: its source slot j, x_ij and r2, and
// whether the lane holds one (hit).
struct Pair {
  int j;
  bool hit;
  float dx, dy, dz, r2;
};

// A queued hit: 16 bytes, one shared-memory store and one load.
struct alignas(16) QueuedHit {
  int j;
  float dx, dy, dz;
};

// Walk query g.i (at xi, yi, zi; any values where !g.live) over the
// 27-cell stencil. Every lane of the warp must call it. pairs(const Pair&,
// int taken) runs on every lane of the warp together, once per batch: lane
// l of a group holds the group's hit number done + l, for l < taken (its
// hit is false beyond), where done is the hits of earlier batches. n is
// the number of sources: loads past a run's end read source n - 1.
template <typename Pairs>
__device__ __forceinline__ void group_walk(const float* __restrict__ pos,
                                           int n,
                                           const int* __restrict__ starts,
                                           const StencilParams& p,
                                           const WalkGroup& g, float xi,
                                           float yi, float zi, Pairs&& pairs) {
  constexpr int kRing = 2 * kGroupWalk;  // held < G before a round
  __shared__ QueuedHit rings[kQueriesPerBlock * kRing];
  const int ring0 = (threadIdx.x / kGroupWalk) * kRing;
  const unsigned lane_bit = 1u << (threadIdx.x & 31);
  const unsigned below = g.mask & (lane_bit - 1u);  // the group's lower lanes
  const float h2 = p.h2;
  int head = 0, held = 0;  // the oldest queued hit's ring slot; hits queued

  // Hand the oldest min(held, G) hits of every group to its lanes.
  auto batch = [&]() {
    __syncwarp();
    const int taken = min(held, kGroupWalk);
    const QueuedHit q = rings[ring0 + ((head + g.lane) & (kRing - 1))];
    __syncwarp();
    head += taken;
    held -= taken;
    pairs(Pair{q.j, g.lane < taken, q.dx, q.dy, q.dz,
               dist2(q.dx, q.dy, q.dz)},
          taken);
  };

  int c[3];
  cell_of(xi, yi, zi, p, c);
  for (int dm = -1; dm <= 1; ++dm) {
    for (int ds = -1; ds <= 1; ++ds) {
      int lo = 0, hi = 0;
      if (!g.live || !stencil_run(c, dm, ds, starts, p, lo, hi)) lo = hi = 0;
      const int rounds = __reduce_max_sync(
          0xffffffffu, (hi - lo + kGroupWalk - 1) / kGroupWalk);
      int j = lo + g.lane;
      for (int t = 0; t < rounds; ++t, j += kGroupWalk) {
        const int jl = min(j, n - 1);
        const float dx = xi - __ldg(pos + 3 * jl);
        const float dy = yi - __ldg(pos + 3 * jl + 1);
        const float dz = zi - __ldg(pos + 3 * jl + 2);
        const bool hit = (j < hi) & (j != g.i) & (dist2(dx, dy, dz) <= h2);
        // The warp votes at once; a group counts its own lanes' bits.
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (hit)
          rings[ring0 + ((head + held + __popc(ballot & below)) &
                         (kRing - 1))] = QueuedHit{j, dx, dy, dz};
        held += __popc(ballot & g.mask);
        if (__any_sync(0xffffffffu, held >= kGroupWalk)) batch();
      }
    }
  }
  if (__any_sync(0xffffffffu, held > 0)) batch();
}
