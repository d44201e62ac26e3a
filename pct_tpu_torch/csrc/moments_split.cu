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
// at tau, then come the tie weight, the members' 35 sums, the nearest and
// the first kth slot, as in moments_warp.cuh's finish_query.
//
// Design: one warp a query slot; slot m = 32 g + lane belongs to lane
// m % 32 throughout.
// - Bits in registers. For M <= 32 S (register classes S = 6, 8, 10) the
//   first pass leaves each lane's S bits in registers (0x7fffffff past M:
//   above every probe; the row is staged to 32 S slots, so the pass reads
//   without a branch). A probe's count is a compare and an add a register
//   and one __reduce_add_sync; an A-ary round counts its A - 1 probes in
//   one pass. No ballot and no popc a probe.
// - Bracket packing. Every round carries cnt(lo) and cnt(hi). Once
//   (lo, hi] holds at most 32 slots, their bits move one to a lane and
//   cnt(lo) is kept as the base: a later probe t in [lo, hi] counts
//   base + #(lane's slot <= t), one compare and one reduction, and so do
//   count_le / count_lt at tau and tau - 1 where both lie in it. The
//   counts are the same integers, so every probe and bracket is the
//   same; a bracket held open by more than 32 tied slots stays unpacked
//   and is counted over every slot.
// - Members from the registers: below tau, or at tau with a positive tie
//   weight, listed in slot order in the warp's shared memory (ballot
//   prefix sums). Member i is chained on lane i % 32 (add_member's _rn
//   chain, 1/sigma and the tie weight read back from shared memory), and
//   the 35 partial sums meet by recursive halving: 32 columns in 31
//   shuffles, lane l ending with column l, the last 3 in 6 (37 shuffles
//   where a butterfly takes 175). Only the order of the sums differs from
//   the plain version's.
// - Past 320 slots the same code runs over a runtime loop: the bits in a
//   warp's shared-memory slice where the row fits CACHE_BUDGET, else d2
//   recomputed from device memory at every read; members through a
//   64-slot queue drained 32 at a time.
// The false-position guess rounds each operation (__fsub_rn, __fmul_rn,
// __fdiv_rn, __fadd_rn) as the plain version does.
//
// Layout: tb cell rows a block (the TPU batches tb rows a grid step), one
// after the other: the block stages a row (x, y, z and the id as one
// 16-byte word a slot, then valid, then each query slot's x, y, z and
// qrow), its warps take the row's query slots in turn, then it stages
// the next. tb changes no output bit. The
// script's `chunk` (tiles of its VMEM scratch) has no counterpart.
//
// What bounds it on the card: as moments.cu, one d2 (9 flops) per usable
// query-candidate pair plus 70 flops per weighted member, and the bytes
// of the candidates, queries and outputs. Every search round adds a
// warp-wide count on top, which is what the modes time; each lane
// repeats the round's scalar steps, so the rounds are bound by the
// warps' instruction issue, and the design spends few instructions a
// round and keeps 32 warps an SM.

#include <climits>

#include "moments_warp.cuh"

namespace {

using namespace moments_warp;

enum Mode : int {
  kFull = 0, kFixed26, kQuad, kQuadFixed, kOctFixed, kInterp4, kNoBisect,
  kNoMoments, kNoAm, kD2Only, kModes
};

// Blocks of 8 warps (4 and 2 ran slower), four an SM: 64 registers a
// thread (a few bytes spill on the searching modes; three blocks'
// spill-free registers ran slower).
constexpr int MIN_BLOCKS = 4;

constexpr unsigned PAD = 0x7fffffffu;   // bits of a slot past M
constexpr int CACHED = 0;    // path: bits in a shared-memory slice
constexpr int GLOBAL = -1;   // path: d2 recomputed from device memory

// Where a query's bits live: register g of each lane (S > 0) ...
template <int S>
struct RegSlots {
  static constexpr bool kRegs = true;
  unsigned v[S];
  __device__ __forceinline__ int groups() const { return S; }
  __device__ __forceinline__ unsigned at(int g) const { return v[g]; }
  __device__ __forceinline__ void put(int g, unsigned b) { v[g] = b; }
};

// ... or read back from src: the warp's slice that put fills (CachedBits),
// or d2 recomputed (RowBits on GlobalRow, slice null).
template <class Src>
struct MemSlots {
  static constexpr bool kRegs = false;
  Src src;
  unsigned* slice;
  int M, lane;
  __device__ __forceinline__ int groups() const { return (M + 31) >> 5; }
  __device__ __forceinline__ unsigned at(int g) const {
    const int m = (g << 5) + lane;
    return m < M ? src(m) : PAD;
  }
  __device__ __forceinline__ void put(int g, unsigned b) {
    const int m = (g << 5) + lane;
    if (slice && m < M) slice[m] = b;
  }
};

// The staged row: x, y, z and the candidate id (its int bits) a slot in
// one 16-byte word, then valid.
struct Row4 {
  const float4* p;
  const int* valid;
  __device__ float x(int m) const { return p[m].x; }
  __device__ float y(int m) const { return p[m].y; }
  __device__ float z(int m) const { return p[m].z; }
};

struct StagedBits {
  Row4 row;
  float qx, qy, qz;
  int qr;
  __device__ __forceinline__ unsigned operator()(int m) const {
    const float4 c = row.p[m];
    return MomentRule::bits(row.valid[m], __float_as_int(c.w), qr,
                            d2_bits(qx, qy, qz, c.x, c.y, c.z));
  }
};

// The warp's shared memory: the output row, then the member list (32 S
// words; 64 past the register classes), which also takes a packed
// bracket.
struct Warp {
  float* row;
  int* list;
};

__host__ __device__ constexpr int list_words(int S) {
  return S > 0 ? 32 * S : 64;
}
__host__ __device__ constexpr int warp_bytes(int S) {
  return 4 * (NOUT + list_words(S));
}

// slots staged a row: 32 S on the register paths, so the first pass
// reads every register's slot without a branch
__host__ __device__ inline int row_pitch(int S, int M) {
  return S > 0 ? 32 * S : pitch(M);
}

inline size_t smem_total(int S, int W, int M, int C) {
  const size_t mp = static_cast<size_t>(row_pitch(S, M));
  size_t b = static_cast<size_t>(W) * warp_bytes(S);
  if (S == CACHED) b += static_cast<size_t>(W) * mp * 4;
  if (S != GLOBAL) b += mp * 20 + 16 * static_cast<size_t>(C);
  return b;
}

// The path of a (C, M) shape: S registers a lane, CACHED or GLOBAL. A
// register path also stages the C query slots; past the budget (C above
// ~5,000, which the wrapper's C <= 512 never reaches) the shape goes on to
// the memory paths.
inline int path_of(int C, int M) {
  const int W = min(MAX_WARPS, C);
  const int S = M <= 32 * 6 ? 6 : M <= 32 * 8 ? 8 : M <= 32 * 10 ? 10 : 0;
  if (S > 0 && smem_total(S, W, M, C) <= CACHE_BUDGET) return S;
  return smem_total(CACHED, W, M, C) <= CACHE_BUDGET ? CACHED : GLOBAL;
}

// First pass: every slot's bits (kept by put), the smallest bits and its
// first slot, the largest usable bits (0 when none); as first_pass.
struct Ends {
  unsigned mn;
  int am_n;
  unsigned mx;
};

template <class Slots, class First>
__device__ __forceinline__ Ends first_bits(Slots& s, const First& first,
                                           int M, int lane) {
  const unsigned sent = sent_bits();
  unsigned mn = ~0u, mx = 0;   // mx: 0 or the largest usable bits
  int am_n = M;
#pragma unroll
  for (int g = 0; g < s.groups(); ++g) {
    const int m = (g << 5) + lane;
    const bool in = m < M;
    unsigned v = PAD;
    if constexpr (Slots::kRegs) {   // staged 32 S slots: no branch
      const unsigned b = first(m);
      v = in ? b : PAD;
    } else if (in) {
      v = first(m);
    }
    if (in && v < mn) {
      mn = v;
      am_n = m;
    }
    if (in && v != sent && v > mx) mx = v;
    s.put(g, v);
  }
  __syncwarp();
  Ends e;
  e.mn = __reduce_min_sync(FULL, mn);
  e.am_n = static_cast<int>(__reduce_min_sync(
      FULL, mn == e.mn ? static_cast<unsigned>(am_n) : static_cast<unsigned>(M)));
  e.mx = __reduce_max_sync(FULL, mx);
  return e;
}

// [lo, hi] and the counts at its ends
struct Bracket {
  int lo, hi, cl, ch;
};

// Counts #(bits <= t) (signed) over the query's slots, the same on every
// lane: over every slot, or after pack() from the packed bracket.
template <class Slots>
struct Counter {
  const Slots& s;
  int* area;             // 32 words of the warp's shared memory
  int lane;
  bool packed = false;
  int base = 0;          // cnt(lo) when the bracket was packed ...
  int lo_pack = 0;       // ... and that lo
  int mine = INT_MAX;    // this lane's bracket slot (INT_MAX: none)

  // cnt(t[i]) over every slot, in one pass over the lane's bits
  template <int N>
  __device__ __forceinline__ void full(const int (&t)[N], int (&c)[N]) const {
    int own[N];
#pragma unroll
    for (int i = 0; i < N; ++i) own[i] = 0;
#pragma unroll
    for (int g = 0; g < s.groups(); ++g) {
      const int b = static_cast<int>(s.at(g));
#pragma unroll
      for (int i = 0; i < N; ++i) own[i] += b <= t[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      c[i] = static_cast<int>(
          __reduce_add_sync(FULL, static_cast<unsigned>(own[i])));
  }

  __device__ __forceinline__ int full(int t) const {
    const int ts[1] = {t};
    int c[1];
    full(ts, c);
    return c[0];
  }

  // cnt(t) - base for t in [lo_pack, hi_pack]: one compare, one reduction
  __device__ __forceinline__ int packed_above(int t) const {
    return static_cast<int>(__reduce_add_sync(FULL, mine <= t ? 1u : 0u));
  }

  // Once (lo, hi] holds at most 32 slots (ch - cl of them), move their
  // bits one to a lane (every later probe lies in [lo, hi]). Returns
  // whether the bracket is packed.
  __device__ __forceinline__ bool pack(const Bracket& b) {
    if (packed || b.lo > b.hi || b.ch - b.cl > 32) return packed;
    const unsigned below = (1u << lane) - 1u;
    int n = 0;
#pragma unroll
    for (int g = 0; g < s.groups(); ++g) {
      const int v = static_cast<int>(s.at(g));
      const bool in = b.lo < v && v <= b.hi;
      const unsigned bal = __ballot_sync(FULL, in);
      if (in) area[n + __popc(bal & below)] = v;
      n += __popc(bal);
    }
    __syncwarp();
    mine = lane < n ? area[lane] : INT_MAX;
    __syncwarp();
    base = b.cl;
    lo_pack = b.lo;
    return packed = true;
  }
};

// floor((hi - lo) / d) for hi >= lo (hi - lo < 2^31)
__device__ __forceinline__ int span_div(int lo, int hi, unsigned d) {
  return static_cast<int>(static_cast<unsigned>(hi - lo) / d);
}

// Bisection rounds on b: `rounds` of them, or while hi - lo > 1 (rounds
// < 0). Counted over every slot until the bracket packs; from then on a
// round is one compare and one reduction against k - cnt(lo at packing).
template <class Slots>
__device__ __forceinline__ void bisect(Counter<Slots>& cnt, int k,
                                       Bracket& b, int rounds) {
  int r = 0;
  for (; rounds < 0 ? b.hi - b.lo > 1 : r < rounds; ++r) {
    if (cnt.pack(b)) break;
    const int mid = b.lo + span_div(b.lo, b.hi, 2);
    const int c = cnt.full(mid);
    if (c >= k) {
      b.hi = mid;
      b.ch = c;
    } else {
      b.lo = mid;
      b.cl = c;
    }
  }
  const int need = k - cnt.base;
  for (; rounds < 0 ? b.hi - b.lo > 1 : r < rounds; ++r) {
    const int mid = b.lo + span_div(b.lo, b.hi, 2);
    if (cnt.packed_above(mid) >= need) b.hi = mid;
    else b.lo = mid;
  }
}

// A-ary rounds on b (q = max((hi - lo) / A, 1), probes min(lo + i q, hi),
// i < A), as bisect: the A - 1 probes of a round counted in one pass
template <int A, class Slots>
__device__ __forceinline__ void nary(Counter<Slots>& cnt, int k, Bracket& b,
                                     int rounds) {
  int r = 0;
  for (; rounds < 0 ? b.hi - b.lo > 1 : r < rounds; ++r) {
    if (cnt.pack(b)) break;
    const int q = max(span_div(b.lo, b.hi, A), 1);
    int mids[A - 1], c[A - 1];
#pragma unroll
    for (int i = 0; i < A - 1; ++i) mids[i] = min(b.lo + (i + 1) * q, b.hi);
    cnt.full(mids, c);
    Bracket n = b;
#pragma unroll
    for (int i = 0; i < A - 1; ++i) {
      if (c[i] >= k) {
        if (mids[i] < n.hi) {
          n.hi = mids[i];
          n.ch = c[i];
        }
      } else if (mids[i] > n.lo) {
        n.lo = mids[i];
        n.cl = c[i];
      }
    }
    b = n;
  }
  const int need = k - cnt.base;
  for (; rounds < 0 ? b.hi - b.lo > 1 : r < rounds; ++r) {
    const int q = max(span_div(b.lo, b.hi, A), 1);
    int lo = b.lo, hi = b.hi;
#pragma unroll
    for (int i = 0; i < A - 1; ++i) {
      const int mid = min(b.lo + (i + 1) * q, b.hi);
      if (cnt.packed_above(mid) >= need) hi = min(hi, mid);
      else lo = max(lo, mid);
    }
    b.lo = lo;
    b.hi = hi;
  }
}

// tau's bits for one query slot under MODE, from [lo0, hi0]
template <int MODE, class Slots>
__device__ __forceinline__ int search(Counter<Slots>& cnt, int k, int lo0,
                                      int hi0) {
  Bracket b{lo0, hi0, 0, 0};
  {
    const int ends[2] = {lo0, hi0};
    int c[2];
    cnt.full(ends, c);
    b.cl = c[0];
    b.ch = c[1];
  }
  if constexpr (MODE == kFixed26) {
    bisect(cnt, k, b, 26);
  } else if constexpr (MODE == kQuad) {
    nary<4>(cnt, k, b, -1);
  } else if constexpr (MODE == kQuadFixed) {
    nary<4>(cnt, k, b, 14);
  } else if constexpr (MODE == kOctFixed) {
    nary<8>(cnt, k, b, 10);
  } else if constexpr (MODE == kInterp4) {
    // false position: cnt(t) grows about linearly in t near a surface
    // point; the guess takes cnt(lo0) = 0 (lo0 < every bits), as the
    // plain version does, and cnt(hi0) counted
    int cl = 0, ch = b.ch;
    for (int r = 0; r < 4; ++r) {
      const float tlo = __int_as_float(max(b.lo, 0));
      const float thi = __int_as_float(b.hi);
      const float denom = fmaxf(static_cast<float>(ch - cl), 1.f);
      const float tg = __fadd_rn(
          tlo, __fmul_rn(__fsub_rn(thi, tlo),
                         __fdiv_rn(static_cast<float>(k - cl), denom)));
      const int gb = min(max(__float_as_int(tg), b.lo + 1),
                         max(b.hi - 1, b.lo + 1));
      const int cg = cnt.full(gb);   // gb may pass hi: over every slot
      if (cg >= k) {
        b.hi = gb;
        b.ch = ch = cg;
      } else {
        b.lo = gb;
        b.cl = cl = cg;
      }
    }
    bisect(cnt, k, b, -1);
  } else {   // kFull, kNoMoments, kNoAm
    bisect(cnt, k, b, -1);
  }
  return b.hi;
}

// 1/sigma and the tie weight: computed once a query slot, then read back
// from the warp's shared memory in every member round (held in registers,
// nvcc at 64 registers recomputes both divisions in every round)
struct Scales {
  const volatile float* p;   // [1/sigma, w_tie]
  __device__ __forceinline__ float inv() const { return p[0]; }
  __device__ __forceinline__ float w_tie() const { return p[1]; }
};

template <class Row>
__device__ __forceinline__ void add_listed(const Row& row, int e,
                                           unsigned tau, const Scales& sc,
                                           float qx, float qy, float qz,
                                           float* acc) {
  // e < 0 flags a member at tau (weight w_tie), else below it (weight 1)
  add_member(row, e & INT_MAX, e < 0 ? tau : 0u, tau, sc.w_tie(), qx, qy, qz,
             sc.inv(), acc);
}

// The members' monomial chains into acc (member i on lane i % 32); returns
// the first slot at tau (with AM; else M).
template <bool AM, class Slots, class Row>
__device__ __forceinline__ int members(const Slots& s, const Row& row, int M,
                                       unsigned tau, const Scales& sc,
                                       float qx, float qy, float qz,
                                       int* list, int lane,
                                       float (&acc)[NMOM]) {
  const unsigned below = (1u << lane) - 1u;
  const bool take_eq = sc.w_tie() > 0.f;
  int am_k = M, n = 0;
#pragma unroll
  for (int g = 0; g < s.groups(); ++g) {
    const int m = (g << 5) + lane;
    const unsigned v = s.at(g);
    const bool at = m < M && v == tau;
    const bool mem = m < M && (v < tau || (at && take_eq));
    if (AM && at) am_k = min(am_k, m);
    const unsigned bal = __ballot_sync(FULL, mem);
    if (mem) list[n + __popc(bal & below)] = at ? (m | INT_MIN) : m;
    n += __popc(bal);
    if constexpr (!Slots::kRegs) {
      if (n >= 32) {   // drain a full round of the 64-slot queue
        __syncwarp();
        add_listed(row, list[lane], tau, sc, qx, qy, qz, acc);
        __syncwarp();
        if (lane < n - 32) list[lane] = list[32 + lane];
        __syncwarp();
        n -= 32;
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32)
    add_listed(row, list[i], tau, sc, qx, qy, qz, acc);
  return AM ? static_cast<int>(__reduce_min_sync(FULL,
                                                 static_cast<unsigned>(am_k)))
            : M;
}

// a[j] += partner's a[j'] over lane bit h: the lane keeps the upper half
// of a[0, 2h) where its bit h is set, else the lower
template <int H, int N>
__device__ __forceinline__ void halve(float (&a)[N], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? a[j] : a[j + H];
    const float keep = up ? a[j + H] : a[j];
    a[j] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, H));
  }
}

// The warp's 35 column sums by recursive halving: col = column lane's,
// tail = column 32 + (lane & 3)'s (lanes with lane & 3 < 3).
__device__ __forceinline__ void halving_sum(float (&a)[NMOM], int lane,
                                            float& col, float& tail) {
  halve<16>(a, lane);
  halve<8>(a, lane);
  halve<4>(a, lane);
  halve<2>(a, lane);
  halve<1>(a, lane);
  col = a[0];
  float t[4] = {a[32], a[33], a[34], 0.f};
  halve<2>(t, lane);
  halve<1>(t, lane);
  float x = t[0];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, off));
  tail = x;
}

// Everything after tau, as finish_query: the 48 stats to o[0, 48).
template <bool AM, bool MOMENTS, class Slots, class Row>
__device__ __forceinline__ void finish(const Slots& s, const Row& row, int M,
                                       int k, unsigned tau, int count_lt,
                                       int count_le, int am_n, float qx,
                                       float qy, float qz, const Warp& w,
                                       int lane, float* o) {
  const float tau_f = __uint_as_float(tau);
  const float sigma = __fsqrt_rn(fmaxf(tau_f, 0.f));
  int am_k = M;   // the first slot at tau
  float col = 0.f, tail = 0.f;
  if constexpr (MOMENTS) {
    const float inv = __fdiv_rn(1.f, fmaxf(sigma, 1e-30f));
    const int count_eq = max(count_le - count_lt, 1);
    const float w_tie = fminf(fmaxf(__fdiv_rn(static_cast<float>(k - count_lt),
                                              static_cast<float>(count_eq)),
                                    0.f), 1.f);
    // in the row's columns 46-47, which are written last
    if (lane == 0) {
      w.row[46] = inv;
      w.row[47] = w_tie;
    }
    __syncwarp();
    const Scales sc{w.row + 46};
    float acc[NMOM];
#pragma unroll
    for (int j = 0; j < NMOM; ++j) acc[j] = 0.f;
    am_k = members<AM>(s, row, M, tau, sc, qx, qy, qz, w.list, lane, acc);
    halving_sum(acc, lane, col, tail);
  }
  w.row[lane] = col;
  if (lane < 3) w.row[32 + lane] = tail;
  if (lane == 0) {
    const bool found = count_le >= k;
    float* r = w.row;
    r[35] = tau_f;
    r[36] = static_cast<float>(count_lt);
    r[37] = static_cast<float>(count_le);
    r[38] = sigma;
    const bool offsets = AM && MOMENTS;
    r[39] = offsets ? __fsub_rn(row.x(am_n), qx) : 0.f;  // am_n < M
    r[40] = offsets ? __fsub_rn(row.y(am_n), qy) : 0.f;
    r[41] = offsets ? __fsub_rn(row.z(am_n), qz) : 0.f;
    const bool has_k = offsets && found && am_k < M;
    const int pk = has_k ? am_k : 0;
    r[42] = has_k ? __fsub_rn(row.x(pk), qx) : 0.f;
    r[43] = has_k ? __fsub_rn(row.y(pk), qy) : 0.f;
    r[44] = has_k ? __fsub_rn(row.z(pk), qz) : 0.f;
    r[45] = found ? 1.f : 0.f;
    r[46] = 0.f;
    r[47] = 0.f;
  }
  __syncwarp();
  o[lane] = w.row[lane];
  if (lane < NOUT - 32) o[32 + lane] = w.row[32 + lane];
  __syncwarp();
}

template <int MODE, class Slots, class First, class Row>
__device__ __forceinline__ void query(Slots& s, const First& first,
                                      const Row& row, int M, int k, float qx,
                                      float qy, float qz, const Warp& w,
                                      int lane, float* o) {
  const Ends e = first_bits(s, first, M, lane);
  const int hi0 = static_cast<int>(e.mx);     // 0 when nothing is usable
  const int lo0 = min(static_cast<int>(e.mn) - 1, hi0);
  Counter<Slots> cnt{s, w.list, lane};
  if constexpr (MODE == kD2Only) {
    const int c = cnt.full(hi0);
    o[lane] = lane == 0 ? static_cast<float>(c) : 0.f;
    if (lane < NOUT - 32) o[32 + lane] = 0.f;
    __syncwarp();
  } else {
    int tau = hi0;
    if constexpr (MODE != kNoBisect) tau = search<MODE>(cnt, k, lo0, hi0);
    // count_le / count_lt at tau: from the packed bracket where both lie
    // in it (tau <= hi always), else over every slot
    int c[2];
    if (cnt.packed && tau - 1 >= cnt.lo_pack) {
      c[0] = cnt.base + cnt.packed_above(tau);
      c[1] = cnt.base + cnt.packed_above(tau - 1);
    } else {
      const int ends[2] = {tau, tau - 1};
      cnt.full(ends, c);
    }
    finish<MODE != kNoAm, MODE != kNoMoments>(
        s, row, M, k, static_cast<unsigned>(tau), c[1], c[0], e.am_n, qx, qy,
        qz, w, lane, o);
  }
}

template <int MODE, int S>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS)
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
  const int mp = row_pitch(S, M);
  float* wrow = reinterpret_cast<float*>(smem + warp * warp_bytes(S));
  const Warp w{wrow, reinterpret_cast<int*>(wrow + NOUT)};
  unsigned char* rest = smem + W * warp_bytes(S);
  unsigned* slice = reinterpret_cast<unsigned*>(rest) + warp * mp;  // CACHED
  if (S == CACHED) rest += static_cast<size_t>(W) * mp * 4;
  float4* xyz = reinterpret_cast<float4*>(rest);
  int* vrow = reinterpret_cast<int*>(xyz + mp);
  float4* qs = reinterpret_cast<float4*>(vrow + mp);   // x, y, z, qrow
  for (int r = 0; r < tb; ++r) {
    const size_t t = static_cast<size_t>(blockIdx.x) * tb + r;
    if (t >= static_cast<size_t>(T)) break;
    if (r > 0) __syncthreads();   // every warp is done with the last row
    const float* pt = p + t * M * 3;
    const int* ct = cand + t * M;
    const int* vt = valid + t * M;
    if constexpr (S != GLOBAL) {   // stage the row, coalesced
      float* f = reinterpret_cast<float*>(xyz);
      for (int i = threadIdx.x; i < 3 * M; i += blockDim.x) {
        const int m = i / 3;
        f[4 * m + (i - 3 * m)] = pt[i];
      }
      for (int i = threadIdx.x; i < M; i += blockDim.x) {
        reinterpret_cast<int*>(f)[4 * i + 3] = ct[i];
        vrow[i] = vt[i];
      }
      for (int i = threadIdx.x; i < C; i += blockDim.x) {
        const size_t qi = t * C + i;
        qs[i] = make_float4(q[qi * 3], q[qi * 3 + 1], q[qi * 3 + 2],
                            __int_as_float(qrow[qi]));
      }
      __syncthreads();
    }
    for (int c = warp; c < C; c += W) {
      const size_t qi = t * C + c;
      float qx, qy, qz;
      int qr;
      if constexpr (S != GLOBAL) {
        const float4 qv = qs[c];
        qx = qv.x;
        qy = qv.y;
        qz = qv.z;
        qr = __float_as_int(qv.w);
      } else {
        qx = q[qi * 3];
        qy = q[qi * 3 + 1];
        qz = q[qi * 3 + 2];
        qr = qrow[qi];
      }
      float* o = out + qi * NOUT;
      if constexpr (S > 0) {
        const Row4 row{xyz, vrow};
        RegSlots<S> s;
        query<MODE>(s, StagedBits{row, qx, qy, qz, qr}, row, M, k, qx, qy,
                    qz, w, lane, o);
      } else if constexpr (S == CACHED) {
        const Row4 row{xyz, vrow};
        MemSlots<CachedBits> s{CachedBits{slice}, slice, M, lane};
        query<MODE>(s, StagedBits{row, qx, qy, qz, qr}, row, M, k, qx, qy,
                    qz, w, lane, o);
      } else {
        const GlobalRow row{pt, ct, vt};
        const RowBits<MomentRule, GlobalRow> src{row, qx, qy, qz, qr};
        MemSlots<RowBits<MomentRule, GlobalRow>> s{src, nullptr, M, lane};
        query<MODE>(s, src, row, M, k, qx, qy, qz, w, lane, o);
      }
    }
  }
}

struct Args {
  const float* q;
  const float* p;
  const int* cand;
  const int* qrow;
  const int* valid;
  float* out;
  int T, C, M, k, tb;
};

// Launches the (MODE, S) kernel, or with `info` fills info[1..3] (blocks
// an SM, warps a block, dynamic shared bytes a block) without launching.
template <int MODE, int S>
int go(const Args& a, cudaStream_t s, int* info) {
  const int W = min(MAX_WARPS, a.C);
  const size_t smem = smem_total(S, W, a.M, a.C);
  if (smem > 48 * 1024) {
    static bool raised = false;   // above 48 KB needs the attribute
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          variant_kernel<MODE, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(CACHE_BUDGET));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  if (info) {
    info[2] = W;
    info[3] = static_cast<int>(smem);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[1], variant_kernel<MODE, S>, W * 32, smem));
  }
  variant_kernel<MODE, S><<<(a.T + a.tb - 1) / a.tb, W * 32, smem, s>>>(
      a.q, a.p, a.cand, a.qrow, a.valid, a.out, a.T, a.C, a.M, a.k, a.tb);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(const Args& a, cudaStream_t s, int* info) {
  switch (path_of(a.C, a.M)) {
    case 6: return go<MODE, 6>(a, s, info);
    case 8: return go<MODE, 8>(a, s, info);
    case 10: return go<MODE, 10>(a, s, info);
    case CACHED: return go<MODE, CACHED>(a, s, info);
    default: return go<MODE, GLOBAL>(a, s, info);
  }
}

using Dispatch = int (*)(const Args&, cudaStream_t, int*);
const Dispatch kDispatch[kModes] = {
    dispatch<kFull>,      dispatch<kFixed26>,  dispatch<kQuad>,
    dispatch<kQuadFixed>, dispatch<kOctFixed>, dispatch<kInterp4>,
    dispatch<kNoBisect>,  dispatch<kNoMoments>, dispatch<kNoAm>,
    dispatch<kD2Only>};

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
  const Args a{q, p, cand, qrow, valid, out, T, C, M, k, tb};
  return kDispatch[mode](a, static_cast<cudaStream_t>(stream), nullptr);
}

// The kernel a (C, M) shape runs under `mode`, without launching:
// info[0] = its path (6, 8 or 10 registers a lane; 0 bits in shared
// memory; -1 recomputed from device memory), info[1] = its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), info[2] = warps a
// block, info[3] = dynamic shared bytes a block. Returns a CUDA error
// code (0 = ok).
extern "C" int pct_moments_variant_info(int C, int M, int mode, int* info) {
  if (C < 1 || M < 1 || mode < 0 || mode >= kModes)
    return static_cast<int>(cudaErrorInvalidValue);
  info[0] = path_of(C, M);
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               1, C, M, 1, 1};
  return kDispatch[mode](a, nullptr, info);
}
