// One query slot of the moments kernels, warp-wide, shared by moments.cu
// (the production kernel) and moments_split.cu (its stage-split
// variants), for sm_90a (H100).
//
// A query's work splits at tau, the threshold on the uint32 bits of d2:
//   first_pass    computes each slot's bits once (storing them to the
//                 warp's bit cache in the cached layout) and reduces the
//                 minimum and its first slot, the largest usable bits and
//                 how many slots hold them, and the usable count;
//   (tau)         moments.cu takes the radix select of knn_warp.cuh;
//                 moments_split.cu one of the JAX script's searches;
//   finish_query  everything after tau: the tie weight, the weighted
//                 members' monomial chains and their 35 sums, the nearest
//                 and the first kth slot, and the 48-float output row.
// finish_query's AM and MOMENTS switch off the nearest/kth pass and the
// member pass (the variants "no_am" and "no_moments"); the production
// kernel runs both.
//
// Bit-exactness: the offsets, products, sums, 1/sigma and sigma use the
// _rn intrinsics so nvcc cannot contract them into FMAs; the plain
// PyTorch version (ops/moments.py) rounds every operation the same way.

#pragma once

#include "knn_warp.cuh"

namespace moments_warp {

using namespace knn_warp;

constexpr int NOUT = 48;
constexpr int NMOM = 35;

// moments: usable when valid > 0 and not the query itself
struct MomentRule {
  __device__ static unsigned bits(int valid, int cand, int qr, unsigned b) {
    return (valid > 0 && cand != qr) ? b : sent_bits();
  }
};

// Per-warp scratch: the radix histogram (256 words), then reused as the
// member queue (64 slots) and the output row (48 floats).
struct Scratch {
  int queue[64];
  float row[NOUT];
};
static_assert(sizeof(Scratch) <= SCRATCH, "scratch overflow");

template <class Row>
__device__ __forceinline__ void add_member(const Row& row, int m, unsigned v,
                                           unsigned tau, float w_tie,
                                           float qx, float qy, float qz,
                                           float inv, float* acc) {
  const float w = v < tau ? 1.f : w_tie;
  const float xh = fminf(fmaxf(__fmul_rn(__fsub_rn(row.x(m), qx), inv), -2.f), 2.f);
  const float yh = fminf(fmaxf(__fmul_rn(__fsub_rn(row.y(m), qy), inv), -2.f), 2.f);
  const float zh = fminf(fmaxf(__fmul_rn(__fsub_rn(row.z(m), qz), inv), -2.f), 2.f);
  float mo[NMOM];
  mo[0] = w;
#define MONO(j, parent, h) mo[j] = __fmul_rn(mo[parent], h)
  MONO(1, 0, xh);   MONO(2, 0, yh);   MONO(3, 0, zh);   // degree 1
  MONO(4, 1, xh);   MONO(5, 2, xh);   MONO(6, 3, xh);   // degree 2
  MONO(7, 2, yh);   MONO(8, 3, yh);   MONO(9, 3, zh);
  MONO(10, 4, xh);  MONO(11, 5, xh);  MONO(12, 6, xh);  // degree 3
  MONO(13, 7, xh);  MONO(14, 8, xh);  MONO(15, 9, xh);
  MONO(16, 7, yh);  MONO(17, 8, yh);  MONO(18, 9, yh);
  MONO(19, 9, zh);
  MONO(20, 10, xh); MONO(21, 11, xh); MONO(22, 12, xh); // degree 4
  MONO(23, 13, xh); MONO(24, 14, xh); MONO(25, 15, xh);
  MONO(26, 16, xh); MONO(27, 17, xh); MONO(28, 18, xh);
  MONO(29, 19, xh); MONO(30, 16, yh); MONO(31, 17, yh);
  MONO(32, 18, yh); MONO(33, 19, yh); MONO(34, 19, zh);
#undef MONO
#pragma unroll
  for (int j = 0; j < NMOM; ++j) acc[j] = __fadd_rn(acc[j], mo[j]);
}

// What the first pass over a query's slots finds (every lane the same).
struct FirstPass {
  unsigned mn;    // the smallest bits (the sentinel when nothing is usable)
  int am_n;       // the first slot holding them
  unsigned mx;    // the largest usable bits (0 when nothing is usable)
  int n_at_mx;    // usable slots holding mx
  int nv;         // usable slots
};

// Each slot's bits from `first`, stored to `bits` when that is not null
// (the cached layout), and their reductions.
template <class First>
__device__ FirstPass first_pass(const First& first, unsigned* bits, int M,
                                int lane) {
  const unsigned sent = sent_bits();
  unsigned mn = ~0u, mx = 0;
  int am_n = M, nv = 0, n_mx = 0;
  for (int m = lane; m < M; m += 32) {
    const unsigned v = first(m);
    if (bits) bits[m] = v;
    if (v < mn) {
      mn = v;
      am_n = m;
    }
    if (v != sent) {
      ++nv;
      if (n_mx == 0 || v > mx) {
        mx = v;
        n_mx = 1;
      } else if (v == mx) {
        ++n_mx;
      }
    }
  }
  __syncwarp();
  FirstPass f;
  f.mn = __reduce_min_sync(FULL, mn);
  f.am_n = static_cast<int>(__reduce_min_sync(
      FULL, mn == f.mn ? static_cast<unsigned>(am_n) : static_cast<unsigned>(M)));
  f.mx = __reduce_max_sync(FULL, n_mx ? mx : 0u);
  f.n_at_mx = static_cast<int>(__reduce_add_sync(
      FULL, (n_mx && mx == f.mx) ? static_cast<unsigned>(n_mx) : 0u));
  f.nv = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(nv)));
  return f;
}

// Everything after tau for one query slot: its 48 stats, written to
// o[0, 48). count_lt / count_le are the slots below / at or below tau,
// am_n the first slot of the minimum. Without AM the nearest and kth
// offsets (columns 39-44) are 0; without MOMENTS so are the 35 sums, and
// the member pass does not run. A found row whose tau no slot holds (a
// variant's unconverged search) has a kth offset of 0.
template <bool AM, bool MOMENTS, class Src, class Row>
__device__ void finish_query(const Src& src, const Row& row, int M, int k,
                             unsigned tau, int count_lt, int count_le,
                             int am_n, float qx, float qy, float qz,
                             unsigned char* scratch, int lane, float* o) {
  const int groups = (M + 31) >> 5;
  const float tau_f = __uint_as_float(tau);
  const float sigma = __fsqrt_rn(fmaxf(tau_f, 0.f));
  const float inv = __fdiv_rn(1.f, fmaxf(sigma, 1e-30f));
  const int count_eq = max(count_le - count_lt, 1);
  const float w_tie = fminf(fmaxf(__fdiv_rn(static_cast<float>(k - count_lt),
                                            static_cast<float>(count_eq)),
                                  0.f), 1.f);
  float acc[NMOM];
#pragma unroll
  for (int j = 0; j < NMOM; ++j) acc[j] = 0.f;
  Scratch& s = *reinterpret_cast<Scratch*>(scratch);
  __syncwarp();   // the histogram is read
  int am_k = M;   // the first slot at tau
  if constexpr (MOMENTS) {
    // members (w > 0: below tau, or at tau with a positive tie weight) in
    // slot order through a 64-slot queue; each full 32 go one to a lane
    const unsigned lt_mask = (1u << lane) - 1u;   // lanes below this one
    int queued = 0;
    for (int g = 0; g < groups; ++g) {
      const int m = (g << 5) + lane;
      const unsigned v = m < M ? src(m) : ~0u;
      const bool mem = v < tau || (v == tau && w_tie > 0.f);
      if constexpr (AM) {
        const unsigned ek = __ballot_sync(FULL, v == tau);
        if (am_k == M && ek) am_k = (g << 5) + __ffs(ek) - 1;
      }
      const unsigned mb = __ballot_sync(FULL, mem);
      if (mem) s.queue[queued + __popc(mb & lt_mask)] = m;
      queued += __popc(mb);
      if (queued >= 32) {
        __syncwarp();
        const int mm = s.queue[lane];
        add_member(row, mm, src(mm), tau, w_tie, qx, qy, qz, inv, acc);
        __syncwarp();
        if (lane < queued - 32) s.queue[lane] = s.queue[32 + lane];
        __syncwarp();
        queued -= 32;
      }
    }
    __syncwarp();
    if (lane < queued) {
      const int mm = s.queue[lane];
      add_member(row, mm, src(mm), tau, w_tie, qx, qy, qz, inv, acc);
    }
#pragma unroll
    for (int j = 0; j < NMOM; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(FULL, acc[j], off));
    }
  }

  // the output row, staged and written by consecutive lanes
  if (lane == 0) {
    const bool found = count_le >= k;
#pragma unroll
    for (int j = 0; j < NMOM; ++j) s.row[j] = acc[j];
    s.row[35] = tau_f;
    s.row[36] = static_cast<float>(count_lt);
    s.row[37] = static_cast<float>(count_le);
    s.row[38] = sigma;
    const bool offsets = AM && MOMENTS;
    s.row[39] = offsets ? __fsub_rn(row.x(am_n), qx) : 0.f;  // am_n < M
    s.row[40] = offsets ? __fsub_rn(row.y(am_n), qy) : 0.f;
    s.row[41] = offsets ? __fsub_rn(row.z(am_n), qz) : 0.f;
    const bool has_k = offsets && found && am_k < M;
    const int pk = has_k ? am_k : 0;
    s.row[42] = has_k ? __fsub_rn(row.x(pk), qx) : 0.f;
    s.row[43] = has_k ? __fsub_rn(row.y(pk), qy) : 0.f;
    s.row[44] = has_k ? __fsub_rn(row.z(pk), qz) : 0.f;
    s.row[45] = found ? 1.f : 0.f;
    s.row[46] = 0.f;
    s.row[47] = 0.f;
  }
  __syncwarp();
  o[lane] = s.row[lane];
  if (lane < NOUT - 32) o[32 + lane] = s.row[32 + lane];
  __syncwarp();
}

}  // namespace moments_warp
