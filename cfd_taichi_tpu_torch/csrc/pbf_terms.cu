// K7 pbf_terms: PBF's constraint pass in one launch, at the start-of-step
// positions: the fluid walk, which also stores the step's pair list, the
// walls' walk, and each row's density constraint and lambda.
//
// Replaces the one-shot terms of bandmat.dense_pbf_ops and
// bandmat.pbf_boundary_terms (cfd_taichi_tpu/ops/bandmat.py:1735-1792,
// 1811-1864), XLA window passes of the JAX package, and the row algebra of
// cfd_taichi_tpu/models/pbf.py:96-115, which XLA fuses into them. With
// spiky_c the spiky gradient factor, poly6 W, s = poly6 / w_ref and the
// quartic s_corr = -k s^4 (reference pbf_solver.py:32-65, 106-174), per
// sorted fluid particle i:
//   fluid walk, over j != i with r2 <= h2:
//     S_f    = sum poly6                 g_f = sum spiky_c x_ij
//     a_f    = sum (r spiky_c)^2         s_f = sum s_corr spiky_c x_ij
//   walls' walk, over boundary b with r2 <= h2:
//     S_b    = sum (rho0 V_b) poly6, and g_b, a_b, s_b as above with the
//     bare spiky coefficient: the volume weights the density only (JAX's
//     quirk, ops/bandmat.py:1813-1817, kept).
//   rows, in f32 and in the order of the torch algebra they replace
//   (stencil.pbf_rows_plain, each product and sum rounded on its own:
//   the library is built with -fmad=false, and / is IEEE division):
//     rho = (rho_seed + m S_f) + S_b,  gsum = g_f + g_b,  around = a_f + a_b,
//     ssum = s_f + s_b (the walls' terms only on scenes with walls)
//     constraint = max(rho * f32(1/rho0) - 1, 0)
//     g' = gsum * f32(1/rho0),
//     denom = ((g'x g'x + g'y g'y) + g'z g'z) + around * f32(1/rho0^2)
//     lam = constraint == 0 ? 0 : -constraint / (denom + f32(EPSILON))
//   and writes constraint, lam, gsum and ssum: 32 bytes a row.
// r = sqrt(max(r2, 1e-24)), as every JAX pass takes it.
//
// The fluid walk stores the pairs it finds, for the step's two later pair
// passes over the same pair set (pbf_lambda.cu, pbf_xsph.cu, which stream
// it): nbr[base[i] + kListStride t] = j for its t-th pair in walk order,
// and cnt[i]; a warp's 32 rows interleave (stencil.cuh, stream_rows). Each
// row has room for the largest number of sources in the 27-cell stencil of
// its warp's rows' cells (ops/stencil.py: pair_rows), known before the
// walk; the pairs are a subset of these candidates, so no row overflows it.
//
// Bound on the card: f32 operations (a distance test and a ~40-operation
// pair term a pair, and ~28 a row, perf/bounds.py), far below what the
// walk of ~27 x occupancy candidates takes; with the list it stores, the
// bytes (~65 us at 1M).
//
// Design: one thread per query on the queued walk (queued_walk_in,
// stencil.cuh): a candidate loop that only tests and queues its hits, the
// pair term in the drain on lanes that nearly all hold a pair. The walls'
// walk follows the fluid walk in the same launch and shares its queue (one
// 20 KB queue a block, so that 8 blocks of 64 registers fit an SM); a warp
// none of whose lanes has a boundary particle near, by Scene.boundary_near
// at its cell, skips it. The fluid sums are folded into rho_seed + m S_f
// before it, so that eight sums live through it, and the row's algebra
// runs on the sums in registers: the two launches and ~22 elementwise
// kernels of the composition before (two raw walks, then torch) are one.
// Hits drain in walk order: a run repeats bit for bit, and every output
// is bit-equal to that composition's. Sums stay in registers and each
// output is written once, with no atomics.
//
// A lane writes its hits' j to its own row as the drain hands them over; a
// drain turn's hits of the warp's lanes, the t-th of each row when their
// queues began the drain equally deep (as at a lattice query's one drain,
// at the end), fill one 128-byte line. Each row written as a run of its
// own (nbr[base[i] + t]), the fluid walk took 880 us at 1M where it took
// 418 with the rows interleaved: 4-byte stores to 32 lines a warp
// instruction.
//
// Measured on an NVIDIA H100 80GB HBM3 (PERF.md section 6, perf/
// coef_compare.py --kernel pbf, us at breaking_dam_1m): the one launch
// 423-433 against the composition's 563-569 (its fluid walk 415-424).
// Staging each block's candidates in shared memory lost: the 9 contiguous
// CSR ranges that a block's 128 queries (consecutive in cell order) need,
// ~1,300 float4 at ~8 particles a cell, read with one shared load a
// candidate, took 495 with a 24 KB tile (5 blocks an SM; 491 with 18 KB,
// 568 with 32, 698 with 48), 464 with 256 queries a block, 705 with 64,
// 481 with the tile filled by bulk copies (cp.async.bulk) of xyz; 30k and
// the clustered cloud lost too. The time followed the warps an SM could
// hold (12: 705, 20: 495, 24: 464, 32: 424): the walk waits on its loads
// more than it runs out of issue slots, and the tile's shared memory cost
// warps. A queue of 32 hits (drains mid-walk) took 485. The tile is kept
// as a patch of this file and stencil.cuh (perf/pbf_tile.patch; perf/
// coef_compare.py says how to build and time it).
#include "stencil.cuh"

constexpr int kPbfQueue = 40;          // hits a thread can hold (fluid)
constexpr int kPbfBoundaryQueue = 16;  // the same on the walls

struct PbfArgs {
  const float* pos;  // (n, 3) cell-sorted fluid
  const int* starts;
  int n;
  StencilParams p;
  SpikyPoly6 k;
  float m, inv_wref, neg_k;
  const int* base;  // the pair list's rows; cnt, nbr written
  int* cnt;
  int* nbr;
  const float* bpos;  // the walls: (nb, 3), V_b, CSR, near a cell
  const float* bvol;
  const int* bstarts;
  const int* bnear;
  int nb;
  float rho0;
  // f32(DENSITY_EPS), f32(1 / rho0), f32(1 / rho0^2), f32(EPSILON)
  float rho_seed, inv_rho0, inv_rho0_sq, eps;
  float* constraint;  // (n,)
  float* lam;         // (n,)
  float* gsum;        // (n, 3)
  float* ssum;        // (n, 3)
};

// The terms of one pair at distance r along x_ij = (dx, dy, dz), added into
// the sums under `take`.
struct PbfSums {
  float rho = 0.f, gx = 0.f, gy = 0.f, gz = 0.f, around = 0.f;
  float sx = 0.f, sy = 0.f, sz = 0.f;

  __device__ __forceinline__ void add(float r, float dx, float dy, float dz,
                                      float wrho, const SpikyPoly6& k,
                                      float inv_wref, float neg_k,
                                      bool take) {
    const float spiky = spiky_grad_coeff(r, k);
    const float poly = poly6_w(r, k);
    const float s = poly * inv_wref;
    const float s2 = s * s;
    const float sc = neg_k * s2 * s2 * spiky;
    const float rs = r * spiky;
    const float prho = wrho * poly;
    const float tgx = spiky * dx, tgy = spiky * dy, tgz = spiky * dz;
    const float ta = rs * rs;
    const float tsx = sc * dx, tsy = sc * dy, tsz = sc * dz;
    if (!take) return;
    rho += prho;
    gx += tgx;
    gy += tgy;
    gz += tgz;
    around += ta;
    sx += tsx;
    sy += tsy;
    sz += tsz;
  }
};

// kWalls: the walls' walk follows the fluid walk (else a clamp scene's
// pass, with no walls).
template <bool kWalls>
__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pbf_terms_kernel(PbfArgs a) {
  static_assert(kPbfBoundaryQueue <= kPbfQueue, "the walks share a queue");
  __shared__ int queue[kPbfQueue * kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < a.n;
  const StencilParams& p = a.p;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) xi = a.pos[3 * i], yi = a.pos[3 * i + 1], zi = a.pos[3 * i + 2];

  PbfSums acc;
  int* row = a.nbr;  // the query's row of the pair list
  if (live) row += __ldg(a.base + i);
  int found = 0;
  queued_walk_in<kPbfQueue, kChunk, kDrainUnroll>(
      queue, XyzRows{a.pos}, a.n, a.starts, p, live, i, xi, yi, zi,
      [&](int j, const XyzRows::Record&, float dx, float dy, float dz,
          float r2, bool take) {
        // The density's factor m comes after the sum, as JAX takes it.
        acc.add(pair_r(r2), dx, dy, dz, 1.0f, a.k, a.inv_wref, a.neg_k,
                take);
        if (take) row[kListStride * found++] = j;
      });
  if (live) a.cnt[i] = found;
  // rho_seed + m S_f, folded before the walls' walk
  const float rho_f = a.rho_seed + a.m * acc.rho;

  PbfSums wall;
  if (kWalls) {
    bool near = false;
    if (live) {
      int c[3];
      cell_of(xi, yi, zi, p, c);
      near = __ldg(a.bnear + c[0] * p.strides[0] + c[1] * p.strides[1] +
                   c[2] * p.strides[2]) > 0;
    }
    if (__any_sync(kFullWarp, near)) {
      queued_walk_in<kPbfBoundaryQueue, kChunk, kDrainUnroll>(
          queue, XyzRows{a.bpos}, a.nb, a.bstarts, p, near, -1, xi, yi, zi,
          [&](int j, const XyzRows::Record&, float dx, float dy, float dz,
              float r2, bool take) {
            wall.add(pair_r(r2), dx, dy, dz, a.rho0 * __ldg(a.bvol + j), a.k,
                     a.inv_wref, a.neg_k, take);
          });
    }
  }
  if (!live) return;

  // The rows, as the torch algebra rounds them (stencil.pbf_rows_plain).
  float rho = rho_f, gx = acc.gx, gy = acc.gy, gz = acc.gz;
  float around = acc.around, sx = acc.sx, sy = acc.sy, sz = acc.sz;
  if (kWalls) {
    rho = rho + wall.rho;
    gx = gx + wall.gx, gy = gy + wall.gy, gz = gz + wall.gz;
    around = around + wall.around;
    sx = sx + wall.sx, sy = sy + wall.sy, sz = sz + wall.sz;
  }
  float con = rho * a.inv_rho0 - 1.0f;
  con = con < 0.f ? 0.f : con;  // torch.clamp(min=0): NaN stays NaN
  const float ux = gx * a.inv_rho0, uy = gy * a.inv_rho0,
              uz = gz * a.inv_rho0;
  const float denom = (ux * ux + uy * uy) + uz * uz + around * a.inv_rho0_sq;
  a.constraint[i] = con;
  a.lam[i] = con == 0.f ? 0.f : -con / (denom + a.eps);
  a.gsum[3 * i] = gx;
  a.gsum[3 * i + 1] = gy;
  a.gsum[3 * i + 2] = gz;
  a.ssum[3 * i] = sx;
  a.ssum[3 * i + 1] = sy;
  a.ssum[3 * i + 2] = sz;
}

// PBF's constraint pass, pbf_terms' one launch. bpos == nullptr: no walls
// (the clamp scenes).
extern "C" int pbf_constraint_launch(
    const float* pos, const int* starts, int n, const StencilParams* p,
    const SpikyPoly6* k, float m, float inv_wref, float neg_k,
    const int* base, int* cnt, int* nbr, const float* bpos,
    const float* bvol, const int* bstarts, const int* bnear, int nb,
    float rho0, float rho_seed, float inv_rho0, float inv_rho0_sq, float eps,
    float* constraint, float* lam, float* gsum, float* ssum, void* stream) {
  const PbfArgs a{pos,   starts, n,    *p,   *k,    m,        inv_wref,
                  neg_k, base,   cnt,  nbr,  bpos, bvol,  bstarts,  bnear,
                  nb,    rho0,   rho_seed, inv_rho0, inv_rho0_sq,   eps,
                  constraint, lam, gsum, ssum};
  if (n > 0) {
    auto* kern = bpos ? pbf_terms_kernel<true> : pbf_terms_kernel<false>;
    kern<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
