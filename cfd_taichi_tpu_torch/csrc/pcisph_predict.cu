// K6 pcisph_predict_rho: PCISPH's predicted density, once a loop iteration.
//
// Replaces bandmat.predicted_rho_op and boundary_predict_op (cfd_taichi_tpu/
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
// Bound on the card: the bytes of x~ and the output (perf/bounds.py), far
// below what the walk of ~27 x occupancy candidates takes: as for matvec,
// the walk's issue slots at 1M and its load latency at 30k set the time.
//
// Design: one thread per query on the queued walk (queued_walk_of,
// stencil.cuh) over the start positions and their cell table, so that the
// walk tests validity exactly as fluid_terms does; the drain loads x~_j
// (or x_s and V_s, x_b and V_b) and runs the W term on lanes that nearly
// all hold a pair. The boundary walk comes second, in the same thread,
// over the static boundary table, and only warps with a wall-near lane
// take it (Scene.boundary_near, as boundary_terms). The body's walk comes
// third, over its per-step table (ops/rigid.rigid_table); in this first
// form every query walks it, though only queries near the body find
// pairs. The three walks hand their pairs to one pair functor type, so
// that they share one queue in shared memory. Hits drain in walk order: a
// run repeats bit for bit. Sums stay in registers and each output is
// written once, with no atomics.
#include "stencil.cuh"

constexpr int kPredictQueue = 40;  // hits a thread can hold
constexpr int kPredictChunk = 8;   // candidates tested between two votes

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

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pcisph_predict_rho_kernel(const float* __restrict__ pos,
                          const int* __restrict__ starts, int n,
                          StencilParams p, float m,
                          const float* __restrict__ pos_p,
                          const float* __restrict__ bpos,
                          const float* __restrict__ bvol,
                          const int* __restrict__ bstarts,
                          const int* __restrict__ bnear, int nb,
                          const float* __restrict__ rpos,
                          const float* __restrict__ rvol,
                          const int* __restrict__ rstarts, int nr,
                          float rho0, float* __restrict__ rho) {
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
  const float fluid = m * acc.sum;

  float wall = 0.f;
  if (nb > 0) {
    bool near = false;
    if (live) {
      int c[3];
      cell_of(xi, yi, zi, p, c);
      near = __ldg(bnear + c[0] * p.strides[0] + c[1] * p.strides[1] +
                   c[2] * p.strides[2]) > 0;
    }
    if (__any_sync(kFullWarp, near)) {
      acc.tpos = bpos;
      acc.vol = bvol;
      acc.wscale = rho0;
      acc.sum = 0.f;
      queued_walk_of<kPredictQueue, kPredictChunk, kDrainUnroll>(
          XyzRows{bpos}, nb, bstarts, p, near, -1, xi, yi, zi, acc);
      wall = acc.sum;
    }
  }

  float body = 0.f;
  if (nr > 0) {
    acc.tpos = rpos;
    acc.vol = rvol;
    acc.wscale = rho0;
    acc.sum = 0.f;
    queued_walk_of<kPredictQueue, kPredictChunk, kDrainUnroll>(
        XyzRows{rpos}, nr, rstarts, p, live, -1, xi, yi, zi, acc);
    body = acc.sum;
  }
  if (live) rho[i] = (fluid + body) + wall;
}

extern "C" int pcisph_predict_rho_launch(const float* pos, const int* starts,
                                         int n, const StencilParams* p,
                                         float m, const float* pos_p,
                                         const float* bpos, const float* bvol,
                                         const int* bstarts, const int* bnear,
                                         int nb, const float* rpos,
                                         const float* rvol,
                                         const int* rstarts, int nr,
                                         float rho0, float* rho,
                                         void* stream) {
  if (n > 0) {
    pcisph_predict_rho_kernel<<<grid_blocks(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        pos, starts, n, *p, m, pos_p, bpos, bvol, bstarts, bnear, nb, rpos,
        rvol, rstarts, nr, rho0, rho);
  }
  return (int)cudaGetLastError();
}
