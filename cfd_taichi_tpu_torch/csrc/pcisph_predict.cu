// K6 pcisph_predict_rho and pcisph_predict_rho_list: PCISPH's predicted
// density, once a loop iteration.
//
// Replace bandmat.predicted_rho_op and boundary_predict_op (cfd_taichi_tpu/
// ops/bandmat.py:1626-1720) and, on a scene with a rigid body,
// rigid_dense.predict_rho_op (cfd_taichi_tpu/ops/rigid_dense.py:179-199):
// XLA window passes of the JAX package. Per sorted fluid particle i, with x
// the start-of-step positions and x~ the predicted ones:
//   rho~[i] = m sum_j W(|x~_i - x~_j|)            j != i, |x_i - x_j|^2 <= h2
//           + sum_s (rho0 V_s) W(|x~_i - x_s|)    |x_i - x_s|^2 <= h2 (body)
//           + sum_b (rho0 V_b) W(|x~_i - x_b|)    |x_i - x_b|^2 <= h2 (walls)
// with r = sqrt(max(d2, 1e-24)) and W the cubic spline (cubic_w, q = r *
// f32(1/h)). The pair set is the start-of-step one (the reference iterates
// the start-of-step grid, pcisph_solver.py:135-154), W is taken at the
// predicted distance: a pair valid at the start but beyond h at x~ gives W
// = 0, a pair within h at x~ but not valid at the start is not a pair. The
// body and the walls keep their positions (pcisph_solver.py:143-147). The
// three sums are kept apart and added at the end in JAX's order, fluid,
// body, walls (models/pcisph.py:281-286).
//
// Two forms of the fluid sum:
//
// * pcisph_predict_rho, the stencil form (the recompute engine, which has
//   no pair store): one thread per query on the queued walk (queued_walk_of,
//   stencil.cuh) over the start positions and their cell table, so that the
//   walk tests validity exactly as fluid_terms does; the drain loads x~_j
//   and runs the W term on lanes that nearly all hold a pair. Its bound is
//   far below what the walk of ~27 x occupancy candidates takes: the walk's
//   issue slots at 1M and its load latency at 30k set the time.
// * pcisph_predict_rho_list, the stream form (the stored-coefficient
//   engine): the pair set is fixed for the whole step and coef_build has
//   stored it once, as the CSR rows [offsets[i], offsets[i+1]) of nbr, in
//   the walk's order (9 runs, ascending slot; coef_build.cu). So the query
//   tests no candidate: it streams its row and sums W at the predicted
//   distance to x~[nbr[p]]. The shape is coef_matvec's (coef_matvec.cu): a
//   group of kPredictGroup lanes per row, lane t taking pairs offsets[i] +
//   t, + t + G, ..., kPredictUnroll nbr loads (streaming, __ldcs) ahead of
//   their gathers, the x~ gathers served from L2 (12 MB at 1M), the
//   group's partial sums reduced with __shfl_xor_sync. Each lane first
//   loads its own row's bounds and x~_i, coalesced, and a group takes them
//   by shuffle, so that a row's stream waits on no other load. With G = 1 a
//   thread adds its row's terms in the walk's order, bit for bit as the
//   stencil form; a group of G > 1 adds strided partial sums, which round
//   differently. The bytes it must read (nbr 4 B a pair, offsets, x, x~,
//   the output) are its floor (perf/bounds.py: stream bytes), ~43 us at 1M.
//   Measured on an H100 at 1M with walls (PERF.md section 6,
//   perf/coef_compare.py --kernel pcisph_predict): load latency sets the
//   time, so the loads a lane has in flight decide it: G = 4 with 8 pairs
//   loaded ahead (a lattice row's ~28 pairs in one round) took 150 us, 8
//   lanes with 2 ahead 186, 4 with 2 185, one lane a row with 8 ahead (the
//   stencil form's sum order, bit-equal to it) 198, with 4 ahead 291, the
//   stencil form 396; x~ gathered as 16-byte records (an (N, 4) copy made
//   a call) and two rows of a group in flight at once gained nothing.
//
// Walls and body, the same in both forms: the boundary walk comes second,
// over the static boundary table, and only warps with a wall-near lane
// take it (Scene.boundary_near, as boundary_terms). The body's walk comes
// third, over its per-step table (ops/rigid.rigid_table), and only warps
// with a lane inside the body's gate take it: rbox, the body's box grown
// by a little more than h (stencil.make_body_box), made on the device once a
// step. A query outside it has no body pair, so its body sum is 0.f either
// way and the gate leaves every output bit as it was. In the stream form
// a warp first streams its 32 rows, kRowGroups at a time; lane t then
// takes row t for these walks, its fluid sum passed on through shared
// memory, so that the walks run on full warps. The walks hand
// their pairs to one pair functor type, so that they share one queue in
// shared memory. Hits drain in walk order: a run repeats bit for bit. Sums
// stay in registers and each output is written once, with no atomics.
//
// The body's walk is the queued walk, one thread a row, in the warps with a
// row inside the gate. Measured on an H100 against four other forms, each
// bit-equal to it (PERF.md section 6; perf/pcisph_body_<form>.patch): a
// group of 8 or 16 lanes a row on the reaction's ordered group walk took
// 3.5-4.5 times as long at 30k and on the torus, since a warp near the body
// holds a median of 13-24 rows inside the gate (perf/body_rows.py) and the
// groups take them a few at a time; one thread a row with its candidates
// streamed across the 9 runs, with its runs' bounds loaded at once, or
// with no queue (each hit's term added as found) each added instructions a
// candidate and took longer on the torus. One 16-byte record [x, y, z, V]
// a body particle in place of four scalar loads took 7-20 % off it, even
// packed by a kernel of each call: a record the body's table would hold
// once a step (perf/pcisph_body_records.patch).
#include "stencil.cuh"

constexpr int kPredictQueue = 40;  // hits a thread can hold
constexpr int kPredictChunk = 8;   // candidates tested between two votes
constexpr int kPredictGroup = 4;   // stream form: lanes per CSR row
constexpr int kPredictUnroll = 8;  // stream form: pairs a lane loads ahead
constexpr int kRowGroups = 32 / kPredictGroup;  // rows a warp takes at once
static_assert(kPredictGroup >= 1 && kPredictGroup <= 32 &&
                  (kPredictGroup & (kPredictGroup - 1)) == 0,
              "kPredictGroup must be a power of two no larger than a warp");

// The W sum of one query against one source set: x~_j (or x_s, x_b) from
// `tpos`, each term weighted by wscale V_j where `vol` is given.
struct PredictSum {
  const float* tpos;
  const float* vol;  // body or boundary volumes, or null for fluid
  float wscale;      // rho0 on the body and the boundary
  float xi, yi, zi;  // the query's predicted position
  const StencilParams* p;
  float sum;

  __device__ __forceinline__ void operator()(int j, const XyzRows::Record&,
                                             float, float, float, float,
                                             bool take) {
    const float dx = xi - __ldg(tpos + 3 * j);
    const float dy = yi - __ldg(tpos + 3 * j + 1);
    const float dz = zi - __ldg(tpos + 3 * j + 2);
    const float w = cubic_w(pair_r(dist2(dx, dy, dz)), *p);
    const float t = vol ? (wscale * __ldg(vol + j)) * w : w;
    if (take) sum += t;
  }
};

// The static walls and the body of a call.
struct Solids {
  const float* bpos;
  const float* bvol;
  const int* bstarts;
  const int* bnear;  // per cell: boundary particles in its stencil
  int nb;
  const float* rpos;
  const float* rvol;
  const int* rstarts;
  const float* rbox;  // the body's gate: lo x, y, z, hi x, y, z
  int nr;
  float rho0;
};

// rho~ of query i (live) from its fluid sum: the walls' and the body's
// walks at its start position, added in JAX's order. Every lane of the
// warp must call it.
__device__ __forceinline__ float add_solids(float fluid, bool live, int i,
                                            const float* __restrict__ pos,
                                            const float* __restrict__ pos_p,
                                            const StencilParams& p,
                                            const Solids& s) {
  float xi = 0.f, yi = 0.f, zi = 0.f;
  PredictSum acc{nullptr, nullptr, s.rho0, 0.f, 0.f, 0.f, &p, 0.f};
  if (live) {
    xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    acc.xi = pos_p[3 * i], acc.yi = pos_p[3 * i + 1];
    acc.zi = pos_p[3 * i + 2];
  }
  float wall = 0.f;
  if (s.nb > 0) {
    bool near = false;
    if (live) {
      int c[3];
      cell_of(xi, yi, zi, p, c);
      near = __ldg(s.bnear + c[0] * p.strides[0] + c[1] * p.strides[1] +
                   c[2] * p.strides[2]) > 0;
    }
    if (__any_sync(kFullWarp, near)) {
      acc.tpos = s.bpos;
      acc.vol = s.bvol;
      acc.sum = 0.f;
      queued_walk_of<kPredictQueue, kPredictChunk, kDrainUnroll>(
          XyzRows{s.bpos}, s.nb, s.bstarts, p, near, -1, xi, yi, zi, acc);
      wall = acc.sum;
    }
  }
  float body = 0.f;
  if (s.nr > 0) {
    const bool near = live && in_body_box(s.rbox, xi, yi, zi);
    if (__any_sync(kFullWarp, near)) {
      acc.tpos = s.rpos;
      acc.vol = s.rvol;
      acc.sum = 0.f;
      queued_walk_of<kPredictQueue, kPredictChunk, kDrainUnroll>(
          XyzRows{s.rpos}, s.nr, s.rstarts, p, near, -1, xi, yi, zi, acc);
      body = acc.sum;
    }
  }
  return (fluid + body) + wall;
}

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pcisph_predict_rho_kernel(const float* __restrict__ pos,
                          const int* __restrict__ starts, int n,
                          StencilParams p, float m,
                          const float* __restrict__ pos_p, Solids s,
                          float* __restrict__ rho) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  PredictSum acc{pos_p, nullptr, 0.f, 0.f, 0.f, 0.f, &p, 0.f};
  if (live) {
    xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    acc.xi = pos_p[3 * i], acc.yi = pos_p[3 * i + 1];
    acc.zi = pos_p[3 * i + 2];
  }
  queued_walk_of<kPredictQueue, kPredictChunk, kDrainUnroll>(
      XyzRows{pos}, n, starts, p, live, i, xi, yi, zi, acc);
  const float out = add_solids(m * acc.sum, live, i, pos, pos_p, p, s);
  if (live) rho[i] = out;
}

// Sum over the kPredictGroup lanes of a group; every lane of the warp must
// call it.
__device__ __forceinline__ float predict_group_sum(float x) {
#pragma unroll
  for (int off = kPredictGroup / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullWarp, x, off, kPredictGroup);
  return x;
}

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pcisph_predict_rho_list_kernel(const float* __restrict__ pos, int n,
                               const int* __restrict__ offsets,
                               const int* __restrict__ nbr, StencilParams p,
                               float m, const float* __restrict__ pos_p,
                               Solids s, float* __restrict__ rho) {
  __shared__ float fluid_of[kThreads];
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x & ~31;        // the warp's first thread
  const int i = blockIdx.x * kThreads + threadIdx.x;  // lane t's row
  const bool live = i < n;
  // Each lane loads its own row's bounds and x~_i, coalesced, and the
  // groups take them by shuffle: no dependent load before a row's stream.
  int lo_t = 0, end_t = 0;
  float x_t = 0.f, y_t = 0.f, z_t = 0.f;
  if (live) {
    lo_t = __ldg(offsets + i), end_t = __ldg(offsets + i + 1);
    x_t = __ldg(pos_p + 3 * i), y_t = __ldg(pos_p + 3 * i + 1);
    z_t = __ldg(pos_p + 3 * i + 2);
  }
  const int g = lane & (kPredictGroup - 1);
  // The warp's 32 rows, a group a row, kRowGroups rows at a time (rows
  // past n are empty).
  for (int k = lane / kPredictGroup; k < 32; k += kRowGroups) {
    const int end = __shfl_sync(kFullWarp, end_t, k);
    const float xi = __shfl_sync(kFullWarp, x_t, k);
    const float yi = __shfl_sync(kFullWarp, y_t, k);
    const float zi = __shfl_sync(kFullWarp, z_t, k);
    float sum = 0.f;
    for (int q0 = __shfl_sync(kFullWarp, lo_t, k) + g; q0 < end;
         q0 += kPredictGroup * kPredictUnroll) {
      int j[kPredictUnroll];
#pragma unroll
      for (int u = 0; u < kPredictUnroll; ++u) {
        const int q = q0 + u * kPredictGroup;
        j[u] = q < end ? __ldcs(nbr + q) : -1;
      }
#pragma unroll
      for (int u = 0; u < kPredictUnroll; ++u) {
        if (j[u] < 0) continue;
        const float dx = xi - __ldg(pos_p + 3 * j[u]);
        const float dy = yi - __ldg(pos_p + 3 * j[u] + 1);
        const float dz = zi - __ldg(pos_p + 3 * j[u] + 2);
        sum += cubic_w(pair_r(dist2(dx, dy, dz)), p);
      }
    }
    sum = predict_group_sum(sum);
    if (g == 0) fluid_of[warp0 + k] = m * sum;
  }
  __syncwarp();
  // The walls and the body: lane t takes its own row.
  const float out = add_solids(live ? fluid_of[threadIdx.x] : 0.f, live, i,
                               pos, pos_p, p, s);
  if (live) rho[i] = out;
}

Solids solids(const float* bpos, const float* bvol, const int* bstarts,
              const int* bnear, int nb, const float* rpos, const float* rvol,
              const int* rstarts, const float* rbox, int nr, float rho0) {
  return Solids{bpos, bvol, bstarts, bnear, nb, rpos, rvol, rstarts, rbox,
                nr, rho0};
}

extern "C" int pcisph_predict_rho_launch(
    const float* pos, const int* starts, int n, const StencilParams* p,
    float m, const float* pos_p, const float* bpos, const float* bvol,
    const int* bstarts, const int* bnear, int nb, const float* rpos,
    const float* rvol, const int* rstarts, const float* rbox, int nr,
    float rho0, float* rho, void* stream) {
  if (n > 0) {
    pcisph_predict_rho_kernel<<<grid_blocks(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        pos, starts, n, *p, m, pos_p,
        solids(bpos, bvol, bstarts, bnear, nb, rpos, rvol, rstarts, rbox, nr,
               rho0),
        rho);
  }
  return (int)cudaGetLastError();
}

extern "C" int pcisph_predict_rho_list_launch(
    const float* pos, int n, const int* offsets, const int* nbr,
    const StencilParams* p, float m, const float* pos_p, const float* bpos,
    const float* bvol, const int* bstarts, const int* bnear, int nb,
    const float* rpos, const float* rvol, const int* rstarts,
    const float* rbox, int nr, float rho0, float* rho, void* stream) {
  if (n > 0) {
    pcisph_predict_rho_list_kernel<<<grid_blocks(n), kThreads, 0,
                                     (cudaStream_t)stream>>>(
        pos, n, offsets, nbr, *p, m, pos_p,
        solids(bpos, bvol, bstarts, bnear, nb, rpos, rvol, rstarts, rbox, nr,
               rho0),
        rho);
  }
  return (int)cudaGetLastError();
}

// What the body's walk was built with, for a run to print: the candidates
// it tests between two votes, then for the stencil form and the stream
// form each its registers a thread, local memory a thread (the stack
// frame and spills), static shared memory a block and resident blocks an
// SM (out: 9 ints).
extern "C" int pcisph_predict_attributes(int* out) {
  out[0] = kPredictChunk;
  const void* kernels[2] = {(const void*)pcisph_predict_rho_kernel,
                            (const void*)pcisph_predict_rho_list_kernel};
  for (int k = 0; k < 2; ++k) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernels[k]);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernels[k],
                                                      kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    out[1 + 4 * k] = a.numRegs;
    out[2 + 4 * k] = (int)a.localSizeBytes;
    out[3 + 4 * k] = (int)a.sharedSizeBytes;
    out[4 + 4 * k] = blocks;
  }
  return 0;
}
