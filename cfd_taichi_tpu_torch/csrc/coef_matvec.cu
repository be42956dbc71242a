// K6 coef_matvec / coef_matvec_dot: the two per-iteration contractions of
// the stored-coefficient engine (ops/coef.py), and dfsph_kick /
// dfsph_rate: the same two contractions with DFSPH's loop algebra in their
// epilogue.
//
// Replace the three Pallas kernels of tools/perf_r5_mv3.py (the VPU
// contraction :66-69, the batched-dot contraction :72-77, and the fused
// kernel :97-125 that gathers the plane rows from a resident product table)
// and the XLA einsum they were measured against, bandmat.coef_matvec_ops
// (cfd_taichi_tpu/ops/bandmat.py:817-972). All compute
//   s[r, i] = sum_p w[p] lane_r(nbr[p])      p in [offsets[i], offsets[i+1])
// with lanes [k, x k, y k, z k] (matvec) or [vx, vy, vz, x . v] (dot), and
// finish with JAX's split over absolute coordinates:
//   matvec[i, c]  = x_ic s0 - s(1+c)
//   matvec_dot[i] = x_i s0 + y_i s1 + z_i s2 - s3
// As in the fused kernel, the lanes are formed from the source's position
// and k (or v) in registers, with no product table in memory. For a bf16
// engine each lane value is rounded to bf16 before the multiply, as the
// JAX engine rounds its product table to w's dtype (bandmat.py:913-914,
// 958-959). `lane_sums` writes the (N, 4) sums s instead of the final form.
//
// Bound on the card: bytes. Each pair is read once (nbr 4 B, w 4 B in f32
// or 2 B in bf16) and does ~11 FLOPs, about 1 FLOP per byte, so neither the
// FP32 pipes nor the tensor cores (four right-hand sides; wgmma has nothing
// to do at this intensity) set the pace. At breaking_dam_1m (28.4 M pairs)
// the arrays come to ~259 MB in f32 and ~202 MB in bf16: 77 / 60 us at
// 3.35 TB/s.
//
// Design: a group of kGroup lanes per CSR row. Lane t of a group takes
// pairs offsets[i] + t, + t + kGroup, ..., so the group reads one contiguous
// stretch of nbr and w per step, and each lane walks ~28 / kGroup pairs
// instead of ~28. A lane loads kUnroll pairs' nbr and w before it gathers
// any source, so that their dependent gathers are in flight together; it
// still adds its pairs in order. The pair list is read with streaming loads
// (__ldcs, evict first), so that one pass over it does not push the
// gathered vectors (pos, k, v: ~28 MB at 1M) out of the 50 MB L2; the pairs
// come in walk order (9 runs of ascending slots, coef_build.cu), so a
// group's gathers land on neighbouring addresses. The four partial sums are
// reduced in the group with __shfl_xor_sync and lane 0 writes the row;
// groups past the last row take part in the shuffles with zero sums and
// skip only the store. The strided partial sums and the tree reduction
// round differently from a serial sum; the checks hold the lane sums to
// 1e-5 of each lane's scale.
// Measured on the H100 at 1M (PERF.md §6; perf/coef_compare.py over copies
// of this file at each kGroup and kUnroll), the gathers, not the pair
// stream, set the time: bf16 storage, which cuts the bytes by a fifth,
// gains 1-4 %; plain __ldg instead of __ldcs changes nothing; staging the
// stream in shared memory with cp.async (a persistent grid over tiles of
// rows, two stages; not kept) is 19-25 % slower than the same groups
// without it; two pairs in flight per lane gain 6-30 % over one at kGroup
// 8-16. kGroup 8 with kUnroll 2 was the fastest pair of the sweep: 143 /
// 153 us (f32 matvec / dot), 54 / 50 % of the byte bound.
//
// dfsph_kick and dfsph_rate replace the torch ops that DFSPH's pressure
// loops ran around the contraction (models/dfsph.py; JAX fuses the same
// algebra into its contraction through XLA, cfd_taichi_tpu/models/
// dfsph.py:174-222): about 20 elementwise passes over the N or 3N rows an
// iteration, each a launch that reads and writes its rows in device memory.
// They run the row loop below unchanged (one `contract` for all four
// entries, through an epilogue functor, so that the contraction's bits
// cannot drift between them) and finish each row in registers:
//   dfsph_kick: v_out = v - (S k + matvec(k)) dt, where upd (a rank's rows
//     to update) holds, and in the divergence loop wk_out = wk + dr alpha;
//   dfsph_rate: d = v . S - matvec_dot(v) [- c_s], then the divergence
//     rate dr and its k = (dr alpha / dt) / rho, or the density loop's
//     rho_adv and k = ((rho_adv - rho0) alpha / dt^2) / rho, and the
//     residual average's inputs: sel (& owned) and sel ? value : 0, which
//     torch sums as it summed torch.where(sel, value, 0) before.
// Every epilogue operation rounds once, in the order the torch ops took
// (-fmad=false, IEEE division), so the outputs are the composition's bit
// for bit (ops/coef.kick_composition, rate_composition). dt and dt^2 are
// read from device memory, so the kernels sit inside the loops' captured
// graphs. Their bound is the contraction's bytes plus the rows that the
// epilogue alone reads and writes (perf/bounds.dfsph_work: 36-52 B a row
// for the kick, 29-41 for the rate); like the contraction they are bound
// by bytes.
//
// The source record. dfsph_rate's lanes [v, x . v] of a source j depend on
// j alone, so they are formed once a source instead of once a pair: the
// (N, 4) f32 record rec[j] = [vx, vy, vz, x . v], 16-byte aligned, which
// dfsph_kick's epilogue writes for every row it writes (v_out, or v where
// upd is 0) and dfsph_pack writes from a v that no kick wrote (the density
// loop's first rate). The rate's pair loop then gathers one float4 a pair
// (one load instruction instead of six scalar loads into the 12-byte rows
// of pos and v, and no x . v), and its epilogue reads v_i from the same
// row. x . v is (x vx + y vy) + z vz, one rounding an operation, as the
// in-register lanes formed it, so the record changes no bit. The
// contraction's own kernels and the kick keep their in-register lanes.
// Measured on the H100 at 1M (PERF.md §6, perf/coef_compare.py): the rate
// 183 -> 160 us with 4 pairs loaded ahead a lane (164 with 2; kGroup 4 or
// 16, which change the bits, 200-250), the kick +9 us for the record's
// stores (streaming stores: within +-3 us, not kept), and a bf16 engine's
// rate over the record rounded to bf16 (8 B a source, perf/dfsph_rec8.patch)
// -10 us, before the second record its kick would have to write: not kept.
#include <cuda_bf16.h>

#include "stencil.cuh"

constexpr int kGroup = 8;    // lanes per row: a power of two <= 32
constexpr int kUnroll = 2;   // pairs a lane loads before it gathers
// The same for the record form (dfsph_rate), whose pair is one gather.
// Unrolling changes no bit (a lane adds its pairs in order); kGroup does.
constexpr int kRecordUnroll = 4;
constexpr int kRowsPerBlock = kThreads / kGroup;
static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "kGroup must be a power of two no larger than a warp");

__device__ __forceinline__ float load_w(const float* w, int q) {
  return __ldcs(w + q);
}

__device__ __forceinline__ float load_w(const __nv_bfloat16* w, int q) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(w) + q)));
}

// A lane value in the engine's storage type.
__device__ __forceinline__ float lane(float x, float) { return x; }

__device__ __forceinline__ float lane(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum over the kGroup lanes of a group; every lane of the warp must call it.
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, kGroup);
  return x;
}

// Where a row's four lanes come from: formed in registers from k and pos
// (coef_matvec's [k, x k, y k, z k]) or from v and pos (coef_matvec_dot's
// [v, x . v]), or gathered as one record (dfsph_rate).
enum class Lanes { kK, kV, kRecord };

// The record of a row at x with velocity v: [vx, vy, vz, x . v].
__device__ __forceinline__ float4 record(const float x[3], float vx, float vy,
                                         float vz) {
  return make_float4(vx, vy, vz, x[0] * vx + x[1] * vy + x[2] * vz);
}

// s += w times the four lanes of source j.
template <Lanes L, typename T>
__device__ __forceinline__ void add_pair(const float* __restrict__ pos,
                                         const float* __restrict__ x, int j,
                                         float wq, float s[4]) {
  const T t{};
  if constexpr (L == Lanes::kRecord) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(x) + j);
    s[0] += wq * lane(r.x, t);
    s[1] += wq * lane(r.y, t);
    s[2] += wq * lane(r.z, t);
    s[3] += wq * lane(r.w, t);
  } else if constexpr (L == Lanes::kV) {
    const float vx = __ldg(x + 3 * j), vy = __ldg(x + 3 * j + 1),
                vz = __ldg(x + 3 * j + 2);
    const float xv = __ldg(pos + 3 * j) * vx + __ldg(pos + 3 * j + 1) * vy +
                     __ldg(pos + 3 * j + 2) * vz;
    s[0] += wq * lane(vx, t);
    s[1] += wq * lane(vy, t);
    s[2] += wq * lane(vz, t);
    s[3] += wq * lane(xv, t);
  } else {
    const float kj = __ldg(x + j);
    s[0] += wq * lane(kj, t);
    s[1] += wq * lane(__ldg(pos + 3 * j) * kj, t);
    s[2] += wq * lane(__ldg(pos + 3 * j + 1) * kj, t);
    s[3] += wq * lane(__ldg(pos + 3 * j + 2) * kj, t);
  }
}

// The finishes of JAX's split over absolute coordinates at the row's
// position x, one rounding an operation (-fmad=false): coef_matvec's
// x_c s0 - s(1+c) and coef_matvec_dot's x s0 + y s1 + z s2 - s3.
__device__ __forceinline__ float matvec_finish(const float x[3],
                                               const float s[4], int c) {
  return x[c] * s[0] - s[1 + c];
}

__device__ __forceinline__ float matvec_dot_finish(const float x[3],
                                                   const float s[4]) {
  return x[0] * s[0] + x[1] * s[1] + x[2] * s[2] - s[3];
}

// The row loop of all four entries: one row per group of kGroup lanes.
// L picks the lanes; x is k (N,), v (N, 3) or the record (N, 4). Lane 0
// of the group hands the row's four sums to `epilogue`, which writes the
// row.
template <Lanes L, typename T, typename Epilogue>
__device__ __forceinline__ void contract(const float* __restrict__ pos, int n,
                                         const int* __restrict__ offsets,
                                         const int* __restrict__ nbr,
                                         const T* __restrict__ w,
                                         const float* __restrict__ x,
                                         const Epilogue& epilogue) {
  constexpr int kU = L == Lanes::kRecord ? kRecordUnroll : kUnroll;
  const int g = threadIdx.x & (kGroup - 1);
  const int i = blockIdx.x * kRowsPerBlock + threadIdx.x / kGroup;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < n) {
    const int end = __ldg(offsets + i + 1);
    for (int q0 = __ldg(offsets + i) + g; q0 < end; q0 += kGroup * kU) {
      int j[kU];
      float wq[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int q = q0 + u * kGroup;
        j[u] = q < end ? __ldcs(nbr + q) : -1;
        wq[u] = q < end ? load_w(w, q) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (j[u] >= 0) add_pair<L, T>(pos, x, j[u], wq[u], s);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r] = group_sum(s[r]);
  if (i >= n || g != 0) return;
  epilogue(i, s);
}

// coef_matvec's and coef_matvec_dot's rows: the final form, or with
// lane_sums the (N, 4) sums.
template <bool kDot>
struct StoreRow {
  const float* __restrict__ pos;
  float* __restrict__ out;
  int lane_sums;

  __device__ __forceinline__ void operator()(int i, const float s[4]) const {
    if (lane_sums) {
#pragma unroll
      for (int r = 0; r < 4; ++r) out[4 * i + r] = s[r];
      return;
    }
    const float x[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
    if constexpr (kDot) {
      out[i] = matvec_dot_finish(x, s);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) out[3 * i + c] = matvec_finish(x, s, c);
    }
  }
};

// dfsph_kick's row (ops/coef.kick_composition, one rounding an operation,
// as the torch ops round):
//   v_out = v - (S k + matvec(k)) dt    (v itself where upd is 0)
//   wk_out = wk + dr alpha              (where wk_out is given)
//   rec = [v_out, x . v_out]            (the record dfsph_rate gathers)
struct KickRow {
  const float* __restrict__ pos;
  const float* __restrict__ k;
  const float* __restrict__ v;
  const float* __restrict__ S;
  const float* __restrict__ dt;     // 0-d
  const float* __restrict__ wk;     // wk, dr, alpha and wk_out: all or none
  const float* __restrict__ dr;
  const float* __restrict__ alpha;
  const bool* __restrict__ upd;     // or null: every row updates
  float* __restrict__ v_out;
  float* __restrict__ wk_out;
  float4* __restrict__ rec;

  __device__ __forceinline__ void operator()(int i, const float s[4]) const {
    const float x[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
    const float ki = k[i], h = *dt;
    const bool apply = upd == nullptr || upd[i];
    float vo[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float vi = v[3 * i + c];
      const float delta = S[3 * i + c] * ki + matvec_finish(x, s, c);
      vo[c] = apply ? vi - delta * h : vi;
      v_out[3 * i + c] = vo[c];
    }
    rec[i] = record(x, vo[0], vo[1], vo[2]);
    if (wk_out != nullptr) wk_out[i] = wk[i] + dr[i] * alpha[i];
  }
};

// dfsph_rate's row (ops/coef.rate_composition), v_i from the record's row
// i: d = v . S - matvec_dot(v) [- c_s], then
//   divergence (counts given): dr = 0 where count < min_neighbors, else
//     max(d, 0) (NaN kept, as torch.clamp keeps it); k = (dr alpha / dt) /
//     rho; the average counts dr > 0;
//   density: rho_adv = max(rho + dt d, rho0) (NaN kept); k = ((rho_adv -
//     rho0) alpha / dt2) / rho; the average counts rho_adv != rho0;
// and the average's inputs, sel (& owned where given) and sel ? value : 0.
// Each operation rounds once, as the torch ops do: -fmad=false, IEEE
// division.
struct RateRow {
  const float* __restrict__ pos;
  const float4* __restrict__ rec;
  const float* __restrict__ S;
  const float* __restrict__ cs;     // or null: nothing subtracted
  const int* __restrict__ counts;   // divergence; null: density
  int min_neighbors;
  const float* __restrict__ alpha;
  const float* __restrict__ rho;
  const float* __restrict__ dt;     // 0-d
  const float* __restrict__ dt2;    // 0-d, density
  float rho0;
  const bool* __restrict__ owned;   // or null: every row counts
  float* __restrict__ dr;           // divergence
  float* __restrict__ k;
  float* __restrict__ masked;
  bool* __restrict__ sel;

  __device__ __forceinline__ void operator()(int i, const float s[4]) const {
    const float x[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
    const float4 v = rec[i];
    const float vs = v.x * S[3 * i] + v.y * S[3 * i + 1] + v.z * S[3 * i + 2];
    float d = vs - matvec_dot_finish(x, s);
    if (cs != nullptr) d = d - cs[i];
    float val, ki;
    bool on;
    if (counts != nullptr) {
      val = counts[i] < min_neighbors ? 0.f : (isnan(d) ? d : fmaxf(d, 0.f));
      dr[i] = val;
      on = val > 0.f;
      ki = __fdiv_rn(__fdiv_rn(val * alpha[i], *dt), rho[i]);
    } else {
      val = rho[i] + *dt * d;
      val = isnan(val) ? val : fmaxf(val, rho0);
      on = val != rho0;
      ki = __fdiv_rn(__fdiv_rn((val - rho0) * alpha[i], *dt2), rho[i]);
    }
    if (owned != nullptr) on = on && owned[i];
    k[i] = ki;
    masked[i] = on ? val : 0.f;
    sel[i] = on;
  }
};

// One __global__ a entry, so that a profile names each by its own stem.
#define CONTRACT_KERNEL(name, L, Epilogue)                                 \
  template <typename T>                                                    \
  __global__ void __launch_bounds__(kThreads)                              \
      name(const float* __restrict__ pos, int n,                           \
           const int* __restrict__ offsets, const int* __restrict__ nbr,   \
           const T* __restrict__ w, const float* __restrict__ x,           \
           Epilogue epilogue) {                                            \
    contract<L>(pos, n, offsets, nbr, w, x, epilogue);                     \
  }

CONTRACT_KERNEL(coef_matvec_kernel, Lanes::kK, StoreRow<false>)
CONTRACT_KERNEL(coef_matvec_dot_kernel, Lanes::kV, StoreRow<true>)
CONTRACT_KERNEL(dfsph_kick_kernel, Lanes::kK, KickRow)
CONTRACT_KERNEL(dfsph_rate_kernel, Lanes::kRecord, RateRow)

// dfsph_pack: the record of every row from a v that no kick wrote, one
// thread a row (24 B read, 16 B written a row: bound by bytes).
__global__ void __launch_bounds__(kThreads)
    dfsph_pack_kernel(const float* __restrict__ pos, int n,
                      const float* __restrict__ v, float4* __restrict__ rec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
  rec[i] = record(x, v[3 * i], v[3 * i + 1], v[3 * i + 2]);
}

template <typename Epilogue>
int launch(void (*f32)(const float*, int, const int*, const int*,
                       const float*, const float*, Epilogue),
           void (*bf16)(const float*, int, const int*, const int*,
                        const __nv_bfloat16*, const float*, Epilogue),
           const float* pos, int n, const int* offsets, const int* nbr,
           const void* w, int is_bf16, const float* x,
           const Epilogue& epilogue, void* stream) {
  if (n > 0) {
    const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (is_bf16)
      bf16<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          pos, n, offsets, nbr, (const __nv_bfloat16*)w, x, epilogue);
    else
      f32<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          pos, n, offsets, nbr, (const float*)w, x, epilogue);
  }
  return (int)cudaGetLastError();
}

#define LAUNCH(name, ...) \
  launch(name<float>, name<__nv_bfloat16>, __VA_ARGS__)

extern "C" int coef_matvec_launch(const float* pos, int n, const int* offsets,
                                  const int* nbr, const void* w, int bf16,
                                  const float* k, float* out, int lane_sums,
                                  void* stream) {
  return LAUNCH(coef_matvec_kernel, pos, n, offsets, nbr, w, bf16, k,
                StoreRow<false>{pos, out, lane_sums}, stream);
}

extern "C" int coef_matvec_dot_launch(const float* pos, int n,
                                      const int* offsets, const int* nbr,
                                      const void* w, int bf16, const float* v,
                                      float* out, int lane_sums,
                                      void* stream) {
  return LAUNCH(coef_matvec_dot_kernel, pos, n, offsets, nbr, w, bf16, v,
                StoreRow<true>{pos, out, lane_sums}, stream);
}

extern "C" int dfsph_kick_launch(const float* pos, int n, const int* offsets,
                                 const int* nbr, const void* w, int bf16,
                                 const float* k, const float* v,
                                 const float* S, const float* dt,
                                 const float* wk, const float* dr,
                                 const float* alpha, const bool* upd,
                                 float* v_out, float* wk_out, float* rec,
                                 void* stream) {
  return LAUNCH(dfsph_kick_kernel, pos, n, offsets, nbr, w, bf16, k,
                KickRow{pos, k, v, S, dt, wk, dr, alpha, upd, v_out, wk_out,
                        reinterpret_cast<float4*>(rec)},
                stream);
}

extern "C" int dfsph_rate_launch(const float* pos, int n, const int* offsets,
                                 const int* nbr, const void* w, int bf16,
                                 const float* rec, const float* S,
                                 const float* cs, const int* counts,
                                 int min_neighbors, const float* alpha,
                                 const float* rho, const float* dt,
                                 const float* dt2, float rho0,
                                 const bool* owned, float* dr, float* k,
                                 float* masked, bool* sel, void* stream) {
  return LAUNCH(dfsph_rate_kernel, pos, n, offsets, nbr, w, bf16, rec,
                RateRow{pos, reinterpret_cast<const float4*>(rec), S, cs,
                        counts, min_neighbors, alpha, rho, dt, dt2, rho0,
                        owned, dr, k, masked, sel},
                stream);
}

extern "C" int dfsph_pack_launch(const float* pos, int n, const float* v,
                                 float* rec, void* stream) {
  if (n > 0)
    dfsph_pack_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, n, v, reinterpret_cast<float4*>(rec));
  return (int)cudaGetLastError();
}
