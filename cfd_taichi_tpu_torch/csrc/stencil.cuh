// Shared pieces of the CSR-stencil pair kernels (ops/stencil.py).
//
// A query particle finds its cell (floor(x * 1/h), clamped into the grid
// like cfd_taichi_tpu/ops/neighbors.py:98-108), then visits the 27-cell
// stencil as 9 contiguous runs of the source CSR table: the fast axis has
// stride 1, so the three cells of one stencil row are adjacent in the
// sorted order. fluid_terms, boundary_terms, matvec, matvec_dot,
// wcsph_forces, pcisph_predict_rho, pbf_terms and the fluid-rigid kernels
// rigid_terms, rigid_contact_dot, rigid_viscosity and rigid_side_list run
// one thread per query that queues its hits and takes the pair term out of
// the candidate loop (queued_walk_of below); coef_build and viscosity run
// a group of kGroupWalk lanes per query (group_walk below), and the
// reaction's walk, rigid_side_force, a group of lanes per body particle
// that hands its hits out in walk order (ordered_group_walk below).
// pbf_lambda, pbf_xsph and rigid_side_force_list walk no stencil: they
// stream a pair list that a walk stored once a step (stream_rows below).
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

// Layout mirrors ops/_build.py:StencilParams (ctypes): 9 ints, 8 floats.
// inv_h comes last, so that a kernel built against an older copy of this
// header (perf/coef_compare.py's variants) reads the fields it knows.
struct StencilParams {
  int dims[3];     // cells per axis
  int strides[3];  // linearization strides; strides[fast] == 1
  int fast, mid, slow;
  float inv_cell;  // f32(1 / cell size): the grid's, not the kernel's
  float h;         // support radius
  float h2;        // f32(h) * f32(h)
  float kw;        // f32(8 / (pi h^3))
  float kw2;       // f32(2 * 8 / (pi h^3))
  float kg6;       // f32(6 * 48 / (pi h^3))
  float kgm6;      // f32(-6 * 48 / (pi h^3))
  float inv_h;     // f32(1) / f32(h), the cubic kernel's q = r * inv_h
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

// Cubic spline W (cfd_taichi_tpu/ops/smoothing.py:23-38), q = r * inv_h
// with inv_h = f32(1) / f32(h): the product XLA makes of JAX's jitted r / h
// (ops/smoothing.py's note).
__device__ __forceinline__ float cubic_w(float r, const StencilParams& p) {
  const float q = r * p.inv_h;
  const float q2 = q * q;
  const float q3 = q2 * q;
  const float near_w = p.kw * (6.0f * (q3 - q2) + 1.0f);
  const float omq = 1.0f - q;
  const float far_w = p.kw2 * omq * omq * omq;
  const float w = (q <= 0.5f) ? near_w : far_w;
  return (q <= 1.0f) ? w : 0.0f;
}

// Gradient factor c(r), grad W = c(r) * x_ij, with the 1e-5 < q guard
// (cfd_taichi_tpu/ops/smoothing.py:65-76), q = r * inv_h as in cubic_w;
// the division by h max(r, 1e-12) stays a division, as in JAX.
__device__ __forceinline__ float cubic_grad_coeff(float r,
                                                  const StencilParams& p) {
  const float q = r * p.inv_h;
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

// Whether (x, y, z) lies inside the body's gate rbox (lo x, y, z, hi x, y,
// z; stencil.make_body_box: the body's box grown by a little more than h).
// A query outside it has no pair with the body, so a walk of the body's
// table from it finds nothing: the kernels that walk the body let a warp
// walk only where one of its lanes is inside.
__device__ __forceinline__ bool in_body_box(const float* __restrict__ rbox,
                                            float x, float y, float z) {
  return x >= __ldg(rbox) && y >= __ldg(rbox + 1) && z >= __ldg(rbox + 2) &&
         x <= __ldg(rbox + 3) && y <= __ldg(rbox + 4) &&
         z <= __ldg(rbox + 5);
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
// -1. queue is the block's kQueueDepth x kThreads ints of shared memory
// (queue[depth][thread]), empty on entry and on return, so that two walks
// of one kernel may share it. kWalkChunk is the candidates tested between
// two votes; kUnroll the hits a thread's drain turn works on.
template <int kQueueDepth, int kWalkChunk, int kUnroll, typename Source,
          typename PairFn>
__device__ __forceinline__ void queued_walk_in(int* queue, const Source& src,
                                               int ns,
                                               const int* __restrict__ starts,
                                               const StencilParams& p,
                                               bool live, int self, float xi,
                                               float yi, float zi,
                                               PairFn&& pair) {
  static_assert(kWalkChunk >= 1 && kWalkChunk < kQueueDepth,
                "a queue must take a chunk's hits after a vote let it pass");
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

// queued_walk_in with a queue of its own.
template <int kQueueDepth, int kWalkChunk, int kUnroll, typename Source,
          typename PairFn>
__device__ __forceinline__ void queued_walk_of(const Source& src, int ns,
                                               const int* __restrict__ starts,
                                               const StencilParams& p,
                                               bool live, int self, float xi,
                                               float yi, float zi,
                                               PairFn&& pair) {
  __shared__ int queue[kQueueDepth * kThreads];
  queued_walk_in<kQueueDepth, kWalkChunk, kUnroll>(
      queue, src, ns, starts, p, live, self, xi, yi, zi, pair);
}

// ---------------------------------------------------------------------------
// The stream of a stored pair list: a group of kGroup lanes a row.
//
// Row i's records are nbr[base[i] + kListStride t], t = 0, ..., cnt[i] - 1,
// in the walk's order: a source index (pbf_terms.cu stores them so) or a
// record of the stream's type Rec (rigid_side_force.cu's int4 of a fluid
// index and a pair vector). The 32 rows of a warp interleave: base[i] is
// the warp's base plus the row's lane (ops/stencil.py: pair_rows), so that
// pair t of the warp's rows lies in one 128-byte line (four of int4). A walk's drain, which hands each lane its t-th hit in
// turn t, then stores whole lines a warp, and a stream that takes a few
// rows' t-th pairs at once reads whole sectors.
//
// A warp takes its 32 rows, the rows of its lanes, 32 / kGroup at a time.
// Each lane first loads its own row's bounds and values (Stream::load),
// coalesced, and a group takes them by shuffle (Stream::shfl), so that a
// row's stream waits on no other load. Lane g of a group takes pairs g,
// g + G, ..., with kAhead record loads (streaming, __ldcs: the list is read
// once) in flight ahead of their gathers; Stream::add adds a pair's terms
// into the lane's sums, the group's partial sums are reduced with
// __shfl_xor_sync (Stream::reduce) and the group's lane 0 writes the row's
// output once (Stream::store). With kGroup = 1 a thread adds its row's
// terms in pair order, which is the order a walk that adds them as it
// finds them takes; a group of kGroup > 1 adds strided partial sums, which
// round differently. A run repeats bit for bit: nothing is added by
// atomics.
// ---------------------------------------------------------------------------

constexpr int kListStride = 32;  // slots between a row's pairs in the list

// Sum of x over the kG lanes of a group; every lane of the warp must call
// it.
template <int kG>
__device__ __forceinline__ float lane_group_sum(float x) {
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullWarp, x, off, kG);
  return x;
}

template <int kGroup, int kAhead, typename Stream, typename Rec>
__device__ __forceinline__ void stream_rows(int n,
                                            const int* __restrict__ base,
                                            const int* __restrict__ cnt,
                                            const Rec* __restrict__ nbr,
                                            const Stream& s) {
  static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
                "kGroup must be a power of two no larger than a warp");
  static_assert(kAhead >= 1, "kAhead: at least one pair a lane");
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kThreads + threadIdx.x;  // lane t's row
  const int row0 = i - lane;                          // the warp's first
  int lo_t = 0, cnt_t = 0;
  typename Stream::Row own{};
  if (i < n) {
    lo_t = __ldg(base + i);
    cnt_t = __ldg(cnt + i);
    own = s.load(i);
  }
  const int g = lane & (kGroup - 1);
  // Rows past n hold no pairs: their groups only join the shuffles.
  for (int k = lane / kGroup; k < 32; k += 32 / kGroup) {
    const Rec* const pairs = nbr + __shfl_sync(kFullWarp, lo_t, k);
    const int end = __shfl_sync(kFullWarp, cnt_t, k);
    const typename Stream::Row row = Stream::shfl(own, k);
    typename Stream::Sums sum{};
    for (int t0 = g; t0 < end; t0 += kGroup * kAhead) {
      Rec j[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int t = t0 + u * kGroup;
        j[u] = t < end ? __ldcs(pairs + kListStride * t) : Rec{};
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (t0 + u * kGroup < end) s.add(sum, row, j[u]);
    }
    sum = Stream::template reduce<kGroup>(sum);
    if (g == 0 && row0 + k < n) s.store(row0 + k, row, sum);
  }
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

// ---------------------------------------------------------------------------
// The ordered group walk: kG consecutive lanes share one query, and hand
// its hits to the caller in walk order, one a lane a batch.
//
// A variant of the group walk above for a query set that is too small to
// fill the card: rigid_side_force's walk of the fluid from each body
// particle, a few thousand queries, where one thread a query leaves each
// warp a chain of dependent loads (the 9 runs' bounds, then a vote after
// each chunk of candidates) that nothing else hides. Here:
//
// * the group loads the 9 runs' bounds at once (lane l those of runs l,
//   l + kG, ...) and takes each run's by shuffle: one wait, not nine;
// * each round loads the next round's candidates (the next run's first,
//   past the last round of a run) before it ranks its own hits and hands
//   out batches: the loads wait under that work, not after it;
// * a round tests kC candidates a lane, kC kG a group (lane l the
//   candidates lo + t kC kG + c kG + l, c < kC): the group's loads of a
//   round are kC contiguous 12 kG-byte reads, all in flight together;
// * a ballot ranks each c's hits, ascending lanes holding ascending j, and
//   the group queues them in a ring in shared memory in walk order (the
//   runs in the one-thread order, dm outer, ds inner, ascending j);
// * whenever a group of the warp holds kG hits, every group hands its
//   oldest min(held, kG) to its lanes, lane l taking hit done + l, and once
//   more at the end;
// * no query is its own source: the sources are another set.
//
// batch(const Pair& h, int taken) runs on every lane of the warp together;
// h.hit says whether the lane holds hit done + l (false beyond taken; j is
// then 0). A caller that adds the batch's terms into its sum in lane order
// (shuffles into every lane of the group) adds them as a thread that walks
// alone adds them as it finds them: its sums keep that walk's bits, where
// walk_sum's tree would not.
//
// The whole warp walks together: each run takes the most rounds any of
// its groups needs. A lane whose candidate lies past its run's end, or
// whose group has no query (live == false), takes part with hit = false.
// ---------------------------------------------------------------------------

template <int kG>
struct LaneGroup {
  int q;          // the group's query
  bool live;      // q < n: the group has a query
  int lane;       // 0 .. kG - 1
  int base;       // the group's first lane within its warp
  unsigned mask;  // the group's lanes within its warp
};

template <int kG>
__device__ __forceinline__ LaneGroup<kG> lane_group(int n) {
  static_assert(kG >= 1 && kG <= 32 && (kG & (kG - 1)) == 0,
                "a lane group is a power of two no larger than a warp");
  LaneGroup<kG> g;
  g.q = blockIdx.x * (kThreads / kG) + threadIdx.x / kG;
  g.live = g.q < n;
  g.lane = threadIdx.x & (kG - 1);
  g.base = (threadIdx.x & 31) & ~(kG - 1);
  g.mask = ((2u << (kG - 1)) - 1u) << g.base;  // kG = 32: every lane
  return g;
}

// Blocks of kThreads lanes for n queries of kG lanes each.
template <int kG>
inline int lane_group_blocks(int n) {
  const int per_block = kThreads / kG;
  return (n + per_block - 1) / per_block;
}

__host__ __device__ constexpr int pow2_at_least(int x, int p = 1) {
  return p >= x ? p : pow2_at_least(x, 2 * p);
}

template <int kG, int kC, typename Batch>
__device__ __forceinline__ void ordered_group_walk(
    const float* __restrict__ pos, int ns, const int* __restrict__ starts,
    const StencilParams& p, const LaneGroup<kG>& g, float xi, float yi,
    float zi, Batch&& batch) {
  static_assert(kC >= 1, "a lane tests a candidate or more a round");
  // held < kG before a round, which adds at most kC kG
  constexpr int kRing = pow2_at_least((1 + kC) * kG);
  constexpr int kSlots = (9 + kG - 1) / kG;  // runs whose bounds a lane holds
  __shared__ QueuedHit rings[(kThreads / kG) * kRing];
  QueuedHit* const ring = rings + (threadIdx.x / kG) * kRing;
  const unsigned below = g.mask & ((1u << (threadIdx.x & 31)) - 1u);
  const float h2 = p.h2;
  int head = 0, held = 0;  // the oldest queued hit's ring slot; hits queued

  auto hand = [&]() {
    __syncwarp();
    const int taken = min(held, kG);
    const QueuedHit q = ring[(head + g.lane) & (kRing - 1)];
    __syncwarp();
    head += taken;
    held -= taken;
    const bool hit = g.lane < taken;
    batch(Pair{hit ? q.j : 0, hit, q.dx, q.dy, q.dz,
               dist2(q.dx, q.dy, q.dz)},
          taken);
  };

  int c[3];
  cell_of(xi, yi, zi, p, c);
  int lo_s[kSlots], hi_s[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = g.lane + k * kG;
    lo_s[k] = hi_s[k] = 0;
    int lo, hi;
    if (g.live && r < 9 && stencil_run(c, r / 3 - 1, r % 3 - 1, starts, p,
                                       lo, hi))
      lo_s[k] = lo, hi_s[k] = hi;
  }
  // Run r's bounds from the lane that loaded them (every lane calls it).
  auto run_bounds = [&](int r, int& lo, int& hi) {
    int mine_lo = lo_s[0], mine_hi = hi_s[0];
#pragma unroll
    for (int k = 1; k < kSlots; ++k)
      if (r / kG == k) mine_lo = lo_s[k], mine_hi = hi_s[k];
    lo = __shfl_sync(kFullWarp, mine_lo, r % kG, kG);
    hi = __shfl_sync(kFullWarp, mine_hi, r % kG, kG);
  };
  // The first run from r on that a group of the warp walks, with its
  // bounds and the rounds the warp takes over it; 9 where none is left.
  auto next_run = [&](int r, int& lo, int& hi, int& rounds) {
    for (; r < 9; ++r) {
      run_bounds(r, lo, hi);
      rounds = __reduce_max_sync(kFullWarp,
                                 (hi - lo + kC * kG - 1) / (kC * kG));
      if (rounds > 0) break;
    }
    return r;
  };
  // The positions of the lane's candidates of round t of the run from lo.
  auto load = [&](int lo, int t, float (&x)[kC], float (&y)[kC],
                  float (&z)[kC]) {
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int jl = min(lo + (t * kC + k) * kG + g.lane, ns - 1);
      x[k] = __ldg(pos + 3 * jl);
      y[k] = __ldg(pos + 3 * jl + 1);
      z[k] = __ldg(pos + 3 * jl + 2);
    }
  };

  // The steps (run r, round t) in walk order; each loads the next step's
  // candidates before it ranks its own hits and hands batches out, so that
  // those loads wait under its work.
  int lo = 0, hi = 0, rounds = 0, t = 0;
  int r = next_run(0, lo, hi, rounds);
  float px[kC], py[kC], pz[kC];
  if (r < 9) load(lo, 0, px, py, pz);
  while (r < 9) {
    int nlo = lo, nhi = hi, nrounds = rounds, nt = t + 1, nr = r;
    if (nt == rounds) {
      nt = 0;
      nr = next_run(r + 1, nlo, nhi, nrounds);
    }
    float qx[kC] = {}, qy[kC] = {}, qz[kC] = {};
    if (nr < 9) load(nlo, nt, qx, qy, qz);
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int j = lo + (t * kC + k) * kG + g.lane;
      const float dx = xi - px[k];
      const float dy = yi - py[k];
      const float dz = zi - pz[k];
      const bool hit = (j < hi) & (dist2(dx, dy, dz) <= h2);
      const unsigned ballot = __ballot_sync(kFullWarp, hit);
      if (hit)
        ring[(head + held + __popc(ballot & below)) & (kRing - 1)] =
            QueuedHit{j, dx, dy, dz};
      held += __popc(ballot & g.mask);
    }
    while (__any_sync(kFullWarp, held >= kG)) hand();
    r = nr, t = nt, lo = nlo, hi = nhi, rounds = nrounds;
#pragma unroll
    for (int k = 0; k < kC; ++k) px[k] = qx[k], py[k] = qy[k], pz[k] = qz[k];
  }
  while (__any_sync(kFullWarp, held > 0)) hand();
}
