// The moments kernel with its stages swapped or switched off, for sm_90a
// (H100): a stage-timing instrument, not on any entry point's path.
//
// Replaces the TPU kernel scripts/micro_moments_split.py::_kernel, the
// copy of pct_tpu/ops/pallas_moments.py::_moment_kernel whose static
// `mode` picks the tau search and drops passes. The outputs are
// knn_moments' (T,C,48) layout (moments.cu); per query slot:
//   hi0 = max(largest usable bits, 0), lo0 = min(smallest bits - 1, hi0)
//   (signed int32 bits; the sentinel 3e38 marks an unusable slot), then
//   full        bisection while hi - lo > 1: mid = lo + (hi - lo) / 2
//   fixed26     the same bisection for 26 rounds
//   quad        4-ary rounds while hi - lo > 1
//   quad_fixed  4-ary, 14 rounds;  oct_fixed  8-ary, 10 rounds
//               (q = max((hi - lo) / arity, 1), probes min(lo + i q, hi),
//               all counted in one scan of the bits)
//   interp4     4 false-position probes, then bisection while hi - lo > 1
//   no_bisect   tau = hi0
//   no_moments, no_am   the full search; no 35 sums and no nearest/kth
//               offsets (no_moments), or no offsets (no_am)
//   d2_only     tau = hi0; column 0 = the count at or below it, 0 elsewhere
// and tau = hi. The fixed-round modes return hi after their last round
// whether or not it converged, as the script does. The Pallas while loops
// run until every row of the batch has converged; a converged row is a
// fixpoint of one more round, so here each warp stops at its own row's
// convergence and the result is the same. count_lt / count_le are counted
// at tau; everything after tau is moments_warp.cuh's finish_query, the
// production kernel's own code.
//
// Counts: every search counts over the warp's cached bits, 32 slots a
// step with one ballot and popc per threshold (signed compares: lo may be
// -1). The false-position guess rounds each operation (__fsub_rn,
// __fmul_rn, __fdiv_rn, __fadd_rn) as the plain version does.
//
// Layout: tb cell rows a block (the TPU batches tb rows a grid step), one
// after the other: the block stages a row, its warps take the row's query
// slots in turn, then it stages the next. tb changes no output bit. The
// script's `chunk` (tiles of its VMEM scratch) has no counterpart.
//
// What bounds it on the card: as moments.cu, one d2 (9 flops) per usable
// query-candidate pair plus 70 flops per weighted member, and the bytes
// of the candidates, queries and outputs; every search round adds a scan
// of the warp's cached bits, which is what the modes time.

#include "moments_warp.cuh"

namespace {

using namespace moments_warp;

enum Mode : int {
  kFull = 0, kFixed26, kQuad, kQuadFixed, kOctFixed, kInterp4, kNoBisect,
  kNoMoments, kNoAm, kD2Only, kModes
};

// #(src(m) <= t) over m < M (signed compare), the same on every lane
template <class Src>
__device__ __forceinline__ int count_le(const Src& src, int M, int t,
                                        int lane) {
  int c = 0;
  for (int g = 0; g < M; g += 32) {
    const int m = g + lane;
    c += __popc(__ballot_sync(
        FULL, m < M && static_cast<int>(src(m)) <= t));
  }
  return c;
}

// one A-ary round on [lo, hi]: A - 1 probes counted in one scan
template <int A, class Src>
__device__ __forceinline__ void nary_round(const Src& src, int M, int k,
                                           int lane, int& lo, int& hi) {
  const int q = max((hi - lo) / A, 1);   // hi >= lo: / is floor
  int mids[A - 1], cnt[A - 1];
#pragma unroll
  for (int i = 0; i < A - 1; ++i) {
    mids[i] = min(lo + (i + 1) * q, hi);
    cnt[i] = 0;
  }
  for (int g = 0; g < M; g += 32) {
    const int m = g + lane;
    const int v = m < M ? static_cast<int>(src(m)) : 0;
#pragma unroll
    for (int i = 0; i < A - 1; ++i)
      cnt[i] += __popc(__ballot_sync(FULL, m < M && v <= mids[i]));
  }
  int new_lo = lo, new_hi = hi;
#pragma unroll
  for (int i = 0; i < A - 1; ++i) {
    if (cnt[i] >= k) new_hi = min(new_hi, mids[i]);
    else new_lo = max(new_lo, mids[i]);
  }
  lo = new_lo;
  hi = new_hi;
}

template <class Src>
__device__ __forceinline__ void bisect_round(const Src& src, int M, int k,
                                             int lane, int& lo, int& hi) {
  const int mid = lo + (hi - lo) / 2;    // hi >= lo: / is floor
  if (count_le(src, M, mid, lane) >= k) hi = mid;
  else lo = mid;
}

// tau's bits for one query slot under MODE, from [lo0, hi0]
template <int MODE, class Src>
__device__ int search(const Src& src, int M, int k, int lane, int lo0,
                      int hi0) {
  int lo = lo0, hi = hi0;
  if constexpr (MODE == kNoBisect || MODE == kD2Only) {
    return hi0;
  } else if constexpr (MODE == kFixed26) {
    for (int r = 0; r < 26; ++r) bisect_round(src, M, k, lane, lo, hi);
  } else if constexpr (MODE == kQuad) {
    while (hi - lo > 1) nary_round<4>(src, M, k, lane, lo, hi);
  } else if constexpr (MODE == kQuadFixed) {
    for (int r = 0; r < 14; ++r) nary_round<4>(src, M, k, lane, lo, hi);
  } else if constexpr (MODE == kOctFixed) {
    for (int r = 0; r < 10; ++r) nary_round<8>(src, M, k, lane, lo, hi);
  } else if constexpr (MODE == kInterp4) {
    // false position: cnt(t) grows about linearly in t near a surface
    // point; cnt(lo0) = 0 (lo0 < every bits), cnt(hi0) counted
    int cl = 0, ch = count_le(src, M, hi0, lane);
    for (int r = 0; r < 4; ++r) {
      const float tlo = __int_as_float(max(lo, 0));
      const float thi = __int_as_float(hi);
      const float denom = fmaxf(static_cast<float>(ch - cl), 1.f);
      const float tg = __fadd_rn(
          tlo, __fmul_rn(__fsub_rn(thi, tlo),
                         __fdiv_rn(static_cast<float>(k - cl), denom)));
      const int gb = min(max(__float_as_int(tg), lo + 1),
                         max(hi - 1, lo + 1));
      const int cg = count_le(src, M, gb, lane);
      if (cg >= k) {
        hi = gb;
        ch = cg;
      } else {
        lo = gb;
        cl = cg;
      }
    }
    while (hi - lo > 1) bisect_round(src, M, k, lane, lo, hi);
  } else {   // kFull, kNoMoments, kNoAm
    while (hi - lo > 1) bisect_round(src, M, k, lane, lo, hi);
  }
  return hi;
}

template <int MODE, class First, class Src, class Row>
__device__ void variant_query(const First& first, unsigned* bits,
                              const Src& src, const Row& row, int M, int k,
                              float qx, float qy, float qz,
                              unsigned char* scratch, int lane, float* o) {
  const FirstPass f = first_pass(first, bits, M, lane);
  const int hi0 = static_cast<int>(f.mx);     // 0 when nothing is usable
  const int lo0 = min(static_cast<int>(f.mn) - 1, hi0);
  const int tau = search<MODE>(src, M, k, lane, lo0, hi0);   // >= 0
  const int count_le_tau = count_le(src, M, tau, lane);
  if constexpr (MODE == kD2Only) {
    o[lane] = lane == 0 ? static_cast<float>(count_le_tau) : 0.f;
    if (lane < NOUT - 32) o[32 + lane] = 0.f;
    __syncwarp();
    return;
  } else {
    const int count_lt_tau = count_le(src, M, tau - 1, lane);
    finish_query<MODE != kNoAm, MODE != kNoMoments>(
        src, row, M, k, static_cast<unsigned>(tau), count_lt_tau,
        count_le_tau, f.am_n, qx, qy, qz, scratch, lane, o);
  }
}

template <int MODE, bool CACHED>
__global__ void __launch_bounds__(MAX_WARPS * 32, 3)
variant_kernel(const float* __restrict__ q,      // (T,C,3)
               const float* __restrict__ p,      // (T,M,3)
               const int* __restrict__ cand,     // (T,M)
               const int* __restrict__ qrow,     // (T,C)
               const int* __restrict__ valid,    // (T,M)
               float* __restrict__ out,          // (T,C,48)
               int T, int C, int M, int k, int tb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  for (int r = 0; r < tb; ++r) {
    const size_t t = static_cast<size_t>(blockIdx.x) * tb + r;
    if (t >= static_cast<size_t>(T)) break;
    if (r > 0) __syncthreads();   // every warp is done with the last row
    const float* pt = p + t * M * 3;
    const int* ct = cand + t * M;
    const int* vt = valid + t * M;
    const Block b = carve(smem, CACHED, W, warp, pt, ct, vt, M);
    for (int c = warp; c < C; c += W) {
      const size_t qi = t * C + c;
      const float qx = q[qi * 3], qy = q[qi * 3 + 1], qz = q[qi * 3 + 2];
      const int qr = qrow[qi];
      float* o = out + qi * NOUT;
      if constexpr (CACHED) {
        variant_query<MODE>(
            RowBits<MomentRule, StagedRow>{b.row, qx, qy, qz, qr}, b.bits,
            CachedBits{b.bits}, b.row, M, k, qx, qy, qz, b.scratch, lane, o);
      } else {
        const GlobalRow row{pt, ct, vt};
        const RowBits<MomentRule, GlobalRow> src{row, qx, qy, qz, qr};
        variant_query<MODE>(src, nullptr, src, row, M, k, qx, qy, qz,
                            b.scratch, lane, o);
      }
    }
  }
}

template <int MODE>
int launch(const float* q, const float* p, const int* cand, const int* qrow,
           const int* valid, float* out, int T, int C, int M, int k, int tb,
           cudaStream_t s) {
  const int W = min(MAX_WARPS, C);
  const int blocks = (T + tb - 1) / tb;
  if (use_cache(W, M)) {
    static bool raised = false;   // above 48 KB needs the attribute
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          variant_kernel<MODE, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(CACHE_BUDGET));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
    variant_kernel<MODE, true><<<blocks, W * 32, smem_bytes(W, M, true), s>>>(
        q, p, cand, qrow, valid, out, T, C, M, k, tb);
  } else {
    variant_kernel<MODE, false><<<blocks, W * 32, smem_bytes(W, M, false),
                                  s>>>(q, p, cand, qrow, valid, out, T, C, M,
                                       k, tb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes as pct_knn_moments (moments.cu); `tb` >= 1 cell rows a block;
// `mode` 0..9 in the order full, fixed26, quad, quad_fixed, oct_fixed,
// interp4, no_bisect, no_moments, no_am, d2_only (checked by the wrapper).
extern "C" int pct_moments_variant(const float* q, const float* p,
                                   const int* cand, const int* qrow,
                                   const int* valid, float* out, int T, int C,
                                   int M, int k, int tb, int mode,
                                   void* stream) {
  if (T <= 0) return 0;
  if (tb < 1 || mode < 0 || mode >= kModes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Launch = int (*)(const float*, const float*, const int*, const int*,
                         const int*, float*, int, int, int, int, int,
                         cudaStream_t);
  static const Launch launches[kModes] = {
      launch<kFull>,      launch<kFixed26>,  launch<kQuad>,
      launch<kQuadFixed>, launch<kOctFixed>, launch<kInterp4>,
      launch<kNoBisect>,  launch<kNoMoments>, launch<kNoAm>,
      launch<kD2Only>};
  return launches[mode](q, p, cand, qrow, valid, out, T, C, M, k, tb, s);
}
