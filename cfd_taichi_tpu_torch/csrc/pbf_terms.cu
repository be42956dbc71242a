// K7 pbf_terms: the one-shot pair sums of a PBF step, at the start-of-step
// positions, and the step's pair list.
//
// Replaces the one-shot terms of bandmat.dense_pbf_ops and
// bandmat.pbf_boundary_terms (cfd_taichi_tpu/ops/bandmat.py:1735-1792,
// 1811-1864), XLA window passes of the JAX package. With spiky_c the spiky
// gradient factor, poly6 W, s = poly6 / w_ref and the quartic s_corr =
// -k s^4 (reference pbf_solver.py:32-65, 106-174), per sorted fluid
// particle i:
//   fluid entry, over j != i with r2 <= h2:
//     rho    = m sum poly6               gsum = sum spiky_c x_ij
//     around = sum (r spiky_c)^2         ssum = sum s_corr spiky_c x_ij
//   boundary entry, over boundary b with r2 <= h2:
//     rho    = sum (rho0 V_b) poly6, and gsum, around, ssum as above with
//     the bare spiky coefficient: the volume weights the density only
//     (JAX's quirk, ops/bandmat.py:1813-1817, kept).
// r = sqrt(max(r2, 1e-24)), as every JAX pass takes it.
//
// The fluid entry also stores the pairs it finds, for the step's two later
// pair passes over the same pair set (pbf_lambda.cu, pbf_xsph.cu, which
// stream it): nbr[base[i] + kListStride t] = j for its t-th pair in walk
// order, and cnt[i]; a warp's 32 rows interleave (stencil.cuh,
// stream_rows). Each row has room for the largest number of sources in
// the 27-cell stencil of its warp's rows' cells (ops/stencil.py:
// pair_rows), known before the walk; the pairs are a subset of these
// candidates, so no row overflows it.
//
// Bound on the card: f32 operations (a distance test and a ~50-operation
// pair term a pair, perf/bounds.py), far below what the walk of ~27 x
// occupancy candidates takes, as for fluid_terms, whose shape this is.
//
// Design: fluid_terms' and boundary_terms' (queued_walk, stencil.cuh): one
// thread per query, a candidate loop that only tests and queues its hits,
// the pair term in the drain on lanes that nearly all hold a pair. The
// boundary entry reads Scene.boundary_near after cell_of, and a warp none
// of whose lanes has a boundary particle near writes zeros and leaves.
// Hits drain in walk order: a run repeats bit for bit. Sums stay in
// registers and each output is written once, with no atomics. A lane
// writes its hits' j to its own row as the drain hands them over; a
// drain turn's hits of the warp's lanes, the t-th of each row when their
// queues began the drain equally deep (as at a lattice query's one drain,
// at the end), fill one 128-byte line. Each row written as a run of its
// own (nbr[base[i] + t]), the fluid entry took 880 us at 1M where it
// takes 418 with the rows interleaved (an NVIDIA H100, perf/coef_compare.py
// --kernel pbf): 4-byte stores to 32 lines a warp instruction.
#include "stencil.cuh"

constexpr int kPbfQueue = 40;          // hits a thread can hold (fluid)
constexpr int kPbfBoundaryQueue = 16;  // the same on the boundary

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

  __device__ __forceinline__ void store(int i, float rho_scale,
                                        float* __restrict__ o_rho,
                                        float* __restrict__ o_g,
                                        float* __restrict__ o_around,
                                        float* __restrict__ o_s) const {
    o_rho[i] = rho_scale * rho;
    o_g[3 * i] = gx;
    o_g[3 * i + 1] = gy;
    o_g[3 * i + 2] = gz;
    o_around[i] = around;
    o_s[3 * i] = sx;
    o_s[3 * i + 1] = sy;
    o_s[3 * i + 2] = sz;
  }
};

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pbf_terms_kernel(const float* __restrict__ pos,
                 const int* __restrict__ starts, int n, StencilParams p,
                 SpikyPoly6 k, float m, float inv_wref, float neg_k,
                 const int* __restrict__ base, int* __restrict__ cnt,
                 int* __restrict__ nbr, float* __restrict__ rho,
                 float* __restrict__ gsum, float* __restrict__ around,
                 float* __restrict__ ssum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int* row = nbr;  // the query's row of the pair list
  if (live) {
    xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    row += __ldg(base + i);
  }

  PbfSums acc;
  int found = 0;
  queued_walk<kPbfQueue>(
      pos, n, starts, p, live, i, xi, yi, zi,
      [&](int j, float dx, float dy, float dz, float r2, bool take) {
        // The density's factor m comes after the sum, as JAX takes it.
        acc.add(pair_r(r2), dx, dy, dz, 1.0f, k, inv_wref, neg_k, take);
        if (take) row[kListStride * found++] = j;
      });
  if (live) {
    acc.store(i, m, rho, gsum, around, ssum);
    cnt[i] = found;
  }
}

__global__ void __launch_bounds__(kThreads, kQueuedBlocks)
pbf_boundary_terms_kernel(const float* __restrict__ qpos, int n,
                          const float* __restrict__ bpos,
                          const float* __restrict__ bvol,
                          const int* __restrict__ bstarts,
                          const int* __restrict__ bnear, int nb,
                          StencilParams p, SpikyPoly6 k, float rho0,
                          float inv_wref, float neg_k,
                          float* __restrict__ rho, float* __restrict__ gsum,
                          float* __restrict__ around,
                          float* __restrict__ ssum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  bool near = false;
  if (i < n) {
    xi = qpos[3 * i], yi = qpos[3 * i + 1], zi = qpos[3 * i + 2];
    int c[3];
    cell_of(xi, yi, zi, p, c);
    near = __ldg(bnear + c[0] * p.strides[0] + c[1] * p.strides[1] +
                 c[2] * p.strides[2]) > 0;
  }

  PbfSums acc;
  if (__any_sync(kFullWarp, near)) {
    queued_walk<kPbfBoundaryQueue>(
        bpos, nb, bstarts, p, near, -1, xi, yi, zi,
        [&](int j, float dx, float dy, float dz, float r2, bool take) {
          acc.add(pair_r(r2), dx, dy, dz, rho0 * __ldg(bvol + j), k,
                  inv_wref, neg_k, take);
        });
  }
  if (i < n) acc.store(i, 1.0f, rho, gsum, around, ssum);
}

extern "C" int pbf_terms_launch(const float* pos, const int* starts, int n,
                                const StencilParams* p, const SpikyPoly6* k,
                                float m, float inv_wref, float neg_k,
                                const int* base, int* cnt, int* nbr,
                                float* rho, float* gsum, float* around,
                                float* ssum, void* stream) {
  if (n > 0) {
    pbf_terms_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, starts, n, *p, *k, m, inv_wref, neg_k, base, cnt, nbr, rho,
        gsum, around, ssum);
  }
  return (int)cudaGetLastError();
}

extern "C" int pbf_boundary_terms_launch(
    const float* qpos, int n, const float* bpos, const float* bvol,
    const int* bstarts, const int* bnear, int nb, const StencilParams* p,
    const SpikyPoly6* k, float rho0, float inv_wref, float neg_k, float* rho,
    float* gsum, float* around, float* ssum, void* stream) {
  if (n > 0) {
    pbf_boundary_terms_kernel<<<grid_blocks(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        qpos, n, bpos, bvol, bstarts, bnear, nb, *p, *k, rho0, inv_wref,
        neg_k, rho, gsum, around, ssum);
  }
  return (int)cudaGetLastError();
}
