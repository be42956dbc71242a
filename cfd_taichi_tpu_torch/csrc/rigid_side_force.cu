// R4 rigid_side_force: the fluid's reaction on each rigid particle in a
// two-way coupled step, in two forms:
//
// * the walk (rigid_side_force_kernel): once a step of IISPH and WCSPH,
//   which charge the reaction once;
// * the list (rigid_side_rows_kernel, then rigid_side_list_kernel, once a
//   step) and its stream (rigid_side_force_list_kernel, once a density
//   iteration of DFSPH and an iteration of PCISPH), where the loop charges
//   it many times over the same start-of-step geometry.
//
// Replaces rigid_dense.build_rigid_side + rigid_side_force (cfd_taichi_tpu/
// ops/rigid_dense.py:255-292), the JAX package's compact (Nr, Kf) list of
// each rigid particle's fluid neighbours and its per-iteration gather,
// which charge each fluid-rigid pair once from the rigid side (the
// reference scatters with atomics, dfsph_solver.py:204-212). Per rigid
// particle j in original order, over the cell-sorted fluid i of the step's
// CSR table with |x_i - x_j|^2 <= h2 and r = |x_i - x_j| <= h
// (rigid_dense.py:272):
//   out_j = force_j + sum_i (rho0 V_j c(r)) (x_i - x_j) u_i
// with c the cubic gradient factor at q = r * f32(1/h) (cubic_grad_coeff)
// and u the per-fluid scalar the solver hands in: k / rho m (DFSPH), p m /
// rho^2 (PCISPH, IISPH) or p' m (WCSPH).
//
// Bound on the card: bytes, the fluid's u and the rigid rows (perf/
// bounds.py), under a microsecond for 10^4 rigid particles. The walk of
// ~27 x occupancy fluid candidates per rigid particle and its launch set
// the walk's time; the stream's bound is the list it reads (16 B a pair)
// and the u it gathers, and the latency of those two dependent loads sets
// its time.
//
// The walk: a group of kSideWalkGroup lanes per rigid particle on the
// ordered group walk (ordered_group_walk, stencil.cuh) over the fluid's
// table; nothing per pair is stored. A body of a few thousand particles
// leaves one thread a particle too few warps to hide a warp's chain of
// waits (the 9 runs' bounds, a vote after each chunk of candidates, the
// drain): the first form took 22.1 us at 30k, all of it that chain. The
// group loads the 9 runs' bounds at once, tests kSideWalkChunk candidates
// a lane a round with the next round's loads in flight, and hands its hits
// out in walk order; every lane of the group adds each batch's terms
// ((-dx) coeff) u_i in that order (SideWalk: shuffles, not walk_sum's
// tree), so its sum rounds as a thread that walks alone rounds it, built
// with -fmad=false: the walk is bit-equal to the first form's one-thread
// walk and to the stream below. A group owns its particle's sum, so there
// are no atomics: a run repeats bit for bit, and the card can be held to
// the CPU. The voxels come in the mesh's lattice order, so neighbouring
// groups walk neighbouring cells.
// Measured on an H100 80GB HBM3 at 700 W (perf/coef_compare.py --kernel
// rigid_side, device us at 1M / 30k / the half-immersed torus; the first
// form 29.6-29.9 / 22.2-22.4 / 16.2-17.1), lanes x candidates a lane a
// round: 16 x 2 22.9-23.1 / 6.5 / 4.6-4.7 (kept), 8 x 2 19.8-20.0 / 7.9 /
// 6.8, 8 x 4 20.7 / 7.7 / 6.4, 16 x 1 22.9 / 7.1 / 5.4, 32 x 1 35.6 / 8.3
// / 4.5, 4 x 4 20.4 / 11.2 / 9.7, 8 x 1 22.2 / 9.7 / 8.2; without the next
// round's loads in flight 16 x 2 22.5-22.7 / 6.5-6.6 / 5.0, 8 x 1 22.5 /
// 11.0 / 9.3; 16 x 2 with 2 hits a lane a batch 34.6 / 7.8 / 5.7, with 16
// blocks an SM (32 registers) 27.1 / 7.4 / 5.4; the 9 runs walked as one
// list of candidates (63-64 registers) 27.9 / 7.4 / 5.8, 8 x 4 that way
// 110.3 (spills). At 1M the 39k particles' groups take ~4 waves of
// resident blocks, each as long as its slowest warp's chain.
//
// The list: the same ordered group walk, kSideListGroup lanes a rigid
// particle and kSideListChunk candidates a lane a round, storing each pair
// it charges in walk order, as the JAX package hoists the pair vectors
// once a step: rec[base_j + kListStride t] = (i, g) for its t-th pair in
// walk order, g = (x_i - x_j) rho0 V_j c(r) as three f32 bit patterns, and
// cnt_j. Each lane computes g of the hit it holds (SideStore: the walk's
// coeff, so the same bits); a ballot ranks the group's charged hits, and
// the hit of rank q goes to slot found + q. Hits come in walk order (hit
// done + l on lane l), so the records and their order are those of a
// thread that walks alone. A warp's 32 rows interleave, as pbf_terms'
// (stencil.cuh, stream_rows), each with room for the largest fluid stencil
// count of its warp's rows, which rigid_side_rows_kernel finds before the
// walk from the CSR offsets at the body's own cells; the pairs are a
// subset of those candidates, so no row overflows it. A group's stores
// land 512 B apart (one row's slots), where the one-thread form's drain
// wrote one 512-byte run a warp: the list is small (~1 MB at 1M).
// Measured on an H100 80GB HBM3 at 700 W (perf/coef_compare.py --kernel
// rigid_side, device us at 1M / 30k / the half-immersed torus; the first
// form, one thread a rigid particle on the queued walk, 27.26-27.33 /
// 21.16-21.30 / 15.55-15.70 in the same calls), lanes x candidates a lane
// a round: 16 x 2 21.83-22.27 / 5.98-6.07 / 4.03-4.08 (kept), 8 x 2 20.50
// / 7.06 / 5.88, 16 x 1 22.21 / 6.75 / 5.10, 8 x 1 21.39 / 9.12 / 7.45. At
// 1M the 39k groups take several waves of resident blocks, as the walk's.
//
// The stream: stream_rows (stencil.cuh) over the int4 records, kSideGroup
// lanes a row, kSideAhead records (one 16-byte streaming load each) in
// flight ahead of their gathers. It gathers the solver's per-fluid value
// and forms u_i = value_i * scale there (DFSPH: k / rho and m, which the
// density loop then need not multiply over all N rows before each launch;
// PCISPH: its u and 1), and u_i = 0 where a rank does not own row i, as
// torch's where(owned, u, 0) gives (the mask a template argument: a
// branch on a null mask in the pair loop cost 1.8-2.1 us a launch). With
// one lane a row a thread adds g u in walk order, so that, built with
// -fmad=false, u (one rounding, as torch's value * scale), the stored g,
// its product with u and the sum round exactly as the walk's ((-dx) *
// coeff) * ui of the same u: the stream is bit-equal to the walk. Most
// rows are short (1.6 pairs a row on the 1M block's body, 4.9 on the 30k
// one's: only the body's skin has fluid near), so a row's few dependent
// loads and the launch set the time: 5.44 / 5.10 / 4.28 us a launch of k
// and m, where the stream of u took 5.62 / 5.04 / 4.28 and torch's u = k m
// before it 2.1 / 1.2 / 1.2 more. The row's force loaded at the entry with
// its bounds (the store then waits only on the sums) took 7.33 / 6.20 /
// 5.13, and 7.94 / 7.09 / 6.22 with 2 records ahead: it is read at the
// store. Measured on an H100 (perf/coef_compare.py --kernel rigid_side,
// device us at 1M / 30k / the half-immersed torus), the stream of u alone
// before the scale: one lane with 1 record ahead
// 5.75 / 5.15 / 4.26, 2 ahead 6.65 / 6.10 / 5.00, 4 ahead 6.63-6.91 /
// 5.94-5.95 / 5.15-5.21, 8 ahead 7.18-7.93 / 5.63-6.98 / 5.56-5.83, 16
// ahead 9.10 / 8.39 / 6.90; 2 lanes with 8 ahead 6.58-6.71 / 6.36-6.39 /
// 5.33-5.38 and 4 lanes with 4 ahead 8.75 / 7.96 / 7.68, neither bit-equal
// to the walk. Kept: one lane, 1 ahead.
#include "stencil.cuh"

constexpr int kSideWalkGroup = 16;  // the walk: lanes a rigid particle
constexpr int kSideWalkChunk = 2;  // the walk: candidates a lane tests a round
constexpr int kSideListGroup = 16;  // the list: lanes a rigid particle
constexpr int kSideListChunk = 2;  // the list: candidates a lane tests a round
constexpr int kSideGroup = 1;   // stream: lanes per row
constexpr int kSideAhead = 1;   // stream: records a lane loads ahead

// The pair term's factor: rho0 V_j c(r) of a pair at r, and whether the
// reaction charges the pair (r <= h as well as r2 <= h2).
struct SidePair {
  const StencilParams* p;
  float coeff_v;  // rho0 V_j of the query

  __device__ __forceinline__ float coeff(float r2, bool take,
                                         bool& charged) const {
    const float r = pair_r(r2);
    charged = take && r <= p->h;
    return coeff_v * cubic_grad_coeff(r, *p);
  }
};

// The walk's sums of one rigid particle, kept alike on every lane of its
// group: a batch's terms ((-dx) coeff) u_i, each on the lane that holds
// its hit, are added in walk order (hit done + l: lane order), each term
// whose pair the reaction charges, by shuffles into every lane.
template <int kG>
struct SideWalk {
  const float* u;
  SidePair k;
  int base;  // the group's first lane within its warp
  float fx, fy, fz;

  __device__ __forceinline__ void operator()(const Pair& h, int) {
    // dx is the query (rigid) minus the source (fluid): x_i - x_j = -dx.
    bool charged;
    const float coeff = k.coeff(h.r2, h.hit, charged);
    const float ui = __ldg(u + h.j);
    const float tx = ((-h.dx) * coeff) * ui;
    const float ty = ((-h.dy) * coeff) * ui;
    const float tz = ((-h.dz) * coeff) * ui;
    const unsigned add = __ballot_sync(kFullWarp, charged) >> base;
#pragma unroll
    for (int l = 0; l < kG; ++l) {
      const float ax = __shfl_sync(kFullWarp, tx, l, kG);
      const float ay = __shfl_sync(kFullWarp, ty, l, kG);
      const float az = __shfl_sync(kFullWarp, tz, l, kG);
      if ((add >> l) & 1u) {
        fx += ax;
        fy += ay;
        fz += az;
      }
    }
  }
};

// The list's stores of one rigid particle: a batch's hits (hit done + l on
// lane l, in walk order) on the group's lanes, each charged pair ranked
// among the group's by a ballot and stored at slot found + its rank.
template <int kG>
struct SideStore {
  SidePair k;
  int4* row;  // the query's row of the list
  int base;   // the group's first lane within its warp
  int lane;   // the lane within its group
  int found;  // pairs stored so far

  __device__ __forceinline__ void operator()(const Pair& h, int) {
    // dx is the query (rigid) minus the source (fluid): x_i - x_j = -dx.
    bool charged;
    const float coeff = k.coeff(h.r2, h.hit, charged);
    const unsigned add = (__ballot_sync(kFullWarp, charged) >> base) &
                         ((2u << (kG - 1)) - 1u);  // kG = 32: every bit
    if (charged)
      row[kListStride * (found + __popc(add & ((1u << lane) - 1u)))] =
          make_int4(h.j, __float_as_int((-h.dx) * coeff),
                    __float_as_int((-h.dy) * coeff),
                    __float_as_int((-h.dz) * coeff));
    found += __popc(add);
  }
};

// The stream's row j: out_j = force_j + sum_t g_t u[i_t], u_i = value_i
// scale (with kOwned, 0 where owned[i] is 0). The mask is a template
// argument, not a branch on a null pointer in the pair loop.
template <bool kOwned>
struct SideStream {
  const float* value;
  float scale;
  const unsigned char* owned;  // a rank's rows (torch bool); kOwned only
  const float* force;
  float* out;

  struct Row {};
  struct Sums {
    float x, y, z;
  };

  __device__ __forceinline__ Row load(int) const { return {}; }
  __device__ __forceinline__ static Row shfl(const Row& r, int) { return r; }
  __device__ __forceinline__ void add(Sums& s, const Row&,
                                      const int4& q) const {
    float ui = __ldg(value + q.x) * scale;
    if (kOwned && !__ldg(owned + q.x)) ui = 0.f;
    s.x += __int_as_float(q.y) * ui;
    s.y += __int_as_float(q.z) * ui;
    s.z += __int_as_float(q.w) * ui;
  }
  template <int kG>
  __device__ __forceinline__ static Sums reduce(const Sums& s) {
    return {lane_group_sum<kG>(s.x), lane_group_sum<kG>(s.y),
            lane_group_sum<kG>(s.z)};
  }
  __device__ __forceinline__ void store(int j, const Row&,
                                        const Sums& s) const {
    out[3 * j] = __ldg(force + 3 * j) + s.x;
    out[3 * j + 1] = __ldg(force + 3 * j + 1) + s.y;
    out[3 * j + 2] = __ldg(force + 3 * j + 2) + s.z;
  }
};

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
rigid_side_force_kernel(const float* __restrict__ rpos,
                        const float* __restrict__ rvol, int nr,
                        const float* __restrict__ pos,
                        const int* __restrict__ starts, int n,
                        StencilParams p, float rho0,
                        const float* __restrict__ u,
                        const float* __restrict__ force,
                        float* __restrict__ out) {
  const LaneGroup<kSideWalkGroup> g = lane_group<kSideWalkGroup>(nr);
  const int j = g.q;
  float xj = 0.f, yj = 0.f, zj = 0.f;
  SideWalk<kSideWalkGroup> acc{u, {&p, 0.f}, g.base, 0.f, 0.f, 0.f};
  if (g.live) {
    xj = rpos[3 * j], yj = rpos[3 * j + 1], zj = rpos[3 * j + 2];
    acc.k.coeff_v = rho0 * rvol[j];
  }
  ordered_group_walk<kSideWalkGroup, kSideWalkChunk>(pos, n, starts, p, g,
                                                     xj, yj, zj, acc);
  if (g.live && g.lane == 0) {
    out[3 * j] = force[3 * j] + acc.fx;
    out[3 * j + 1] = force[3 * j + 1] + acc.fy;
    out[3 * j + 2] = force[3 * j + 2] + acc.fz;
  }
}

// The list's rows: room[w + 1] = the largest candidate count (the fluid
// in the 27-cell stencil of the row's cell, from the CSR offsets alone) of
// warp w's kListStride rows, room[0] = 0; their running sum is each warp's
// first slot over kListStride (ops/rigid.py: side_rows).
__global__ void __launch_bounds__(kThreads)
rigid_side_rows_kernel(const float* __restrict__ rpos, int nr,
                       const int* __restrict__ starts, StencilParams p,
                       long long* __restrict__ room) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  int cand = 0;
  if (j < nr) {
    int c[3];
    cell_of(rpos[3 * j], rpos[3 * j + 1], rpos[3 * j + 2], p, c);
    for (int dm = -1; dm <= 1; ++dm)
      for (int ds = -1; ds <= 1; ++ds) {
        int lo, hi;
        if (stencil_run(c, dm, ds, starts, p, lo, hi)) cand += hi - lo;
      }
  }
  cand = __reduce_max_sync(kFullWarp, cand);
  if (j < nr && (j & (kListStride - 1)) == 0) room[j / kListStride + 1] = cand;
  if (j == 0) room[0] = 0;
}

// The walk of each row j (a group of kSideListGroup lanes), storing its
// pairs from slot base_j = kListStride offs[j / kListStride] + j's lane in
// its warp of rows (offs: the running sum of the rows' room), and base_j
// and cnt_j.
__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
rigid_side_list_kernel(const float* __restrict__ rpos,
                       const float* __restrict__ rvol, int nr,
                       const float* __restrict__ pos,
                       const int* __restrict__ starts, int n,
                       StencilParams p, float rho0,
                       const long long* __restrict__ offs,
                       int* __restrict__ base, int* __restrict__ cnt,
                       int4* __restrict__ rec) {
  const LaneGroup<kSideListGroup> g = lane_group<kSideListGroup>(nr);
  const int j = g.q;
  float xj = 0.f, yj = 0.f, zj = 0.f;
  SideStore<kSideListGroup> store{{&p, 0.f}, rec, g.base, g.lane, 0};
  if (g.live) {
    xj = rpos[3 * j], yj = rpos[3 * j + 1], zj = rpos[3 * j + 2];
    store.k.coeff_v = rho0 * rvol[j];
    const int b = kListStride * (int)__ldg(offs + j / kListStride) +
                  (j & (kListStride - 1));
    if (g.lane == 0) base[j] = b;
    store.row += b;
  }
  ordered_group_walk<kSideListGroup, kSideListChunk>(pos, n, starts, p, g,
                                                     xj, yj, zj, store);
  if (g.live && g.lane == 0) cnt[j] = store.found;
}

template <bool kOwned>
__global__ void __launch_bounds__(kThreads)
rigid_side_force_list_kernel(int nr, const int* __restrict__ base,
                             const int* __restrict__ cnt,
                             const int4* __restrict__ rec,
                             SideStream<kOwned> s) {
  stream_rows<kSideGroup, kSideAhead>(nr, base, cnt, rec, s);
}

extern "C" int rigid_side_force_launch(const float* rpos, const float* rvol,
                                       int nr, const float* pos,
                                       const int* starts, int n,
                                       const StencilParams* p,
                                       float rho0, const float* u,
                                       const float* force, float* out,
                                       void* stream) {
  if (nr > 0) {
    rigid_side_force_kernel<<<lane_group_blocks<kSideWalkGroup>(nr),
                              kThreads, 0, (cudaStream_t)stream>>>(
        rpos, rvol, nr, pos, starts, n, *p, rho0, u, force, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rigid_side_rows_launch(const float* rpos, int nr,
                                      const int* starts,
                                      const StencilParams* p, void* room,
                                      void* stream) {
  if (nr > 0) {
    rigid_side_rows_kernel<<<grid_blocks(nr), kThreads, 0,
                             (cudaStream_t)stream>>>(
        rpos, nr, starts, *p, static_cast<long long*>(room));
  }
  return (int)cudaGetLastError();
}

extern "C" int rigid_side_list_launch(const float* rpos, const float* rvol,
                                      int nr, const float* pos,
                                      const int* starts, int n,
                                      const StencilParams* p, float rho0,
                                      const void* offs, int* base, int* cnt,
                                      void* rec, void* stream) {
  if (nr > 0) {
    rigid_side_list_kernel<<<lane_group_blocks<kSideListGroup>(nr),
                             kThreads, 0, (cudaStream_t)stream>>>(
        rpos, rvol, nr, pos, starts, n, *p, rho0,
        static_cast<const long long*>(offs), base, cnt,
        static_cast<int4*>(rec));
  }
  return (int)cudaGetLastError();
}

// The stream of value * scale: owned is a rank's (N,) bool rows, or null.
extern "C" int rigid_side_stream_launch(int nr, const int* base,
                                        const int* cnt, const void* rec,
                                        const float* value, float scale,
                                        const void* owned,
                                        const float* force, float* out,
                                        void* stream) {
  const auto* ri = static_cast<const int4*>(rec);
  const auto* mask = static_cast<const unsigned char*>(owned);
  if (nr > 0 && mask != nullptr) {
    rigid_side_force_list_kernel<true>
        <<<grid_blocks(nr), kThreads, 0, (cudaStream_t)stream>>>(
            nr, base, cnt, ri,
            SideStream<true>{value, scale, mask, force, out});
  } else if (nr > 0) {
    rigid_side_force_list_kernel<false>
        <<<grid_blocks(nr), kThreads, 0, (cudaStream_t)stream>>>(
            nr, base, cnt, ri,
            SideStream<false>{value, scale, nullptr, force, out});
  }
  return (int)cudaGetLastError();
}
