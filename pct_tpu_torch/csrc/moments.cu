// Large-k neighborhoods as moment sums, for sm_90a (H100).
//
// Replaces the TPU kernel pct_tpu/ops/pallas_moments.py::_moment_kernel.
// For every cell row t of a bucket and every query slot c of that cell,
// over the M candidate slots of the row (slots with valid <= 0 and the
// query itself, cand == qrow, are skipped):
//   d2    = ((dx*dx + dy*dy) + dz*dz),  d = q - p          (difference form)
//   tau   = the kth smallest valid d2 (>= k valid), else the largest valid
//           d2, else 0 (on the uint32 bits of d2: non-negative float32
//           compares are monotone on their bits)
//   count_lt, count_le at tau; first slots whose d2 is the minimum / tau
//   w     = 1 below tau, clip((k - count_lt) / count_eq, 0, 1) at tau, else 0
//   r^    = clip((p - q) * (1 / sigma), -2, 2),  sigma = sqrt(tau)
//   35 sums of w * x^a y^b z^c (a+b+c <= 4, graded-lex order), each
//   monomial built by the product chain (a-1,b,c)*x | (a,b-1,c)*y | (a,b,c-1)*z
// Output (T,C,48) float32: [0:35] moments, [35] tau, [36] count_lt,
// [37] count_le, [38] sigma, [39:42] nearest offset p1 - q, [42:45] kth
// offset pk - q (0 unless found), [45] found = count_le >= k, [46:48] 0.
//
// Bit-exactness: d2, r, the products, the sums, 1/sigma and sigma use the
// _rn intrinsics so nvcc cannot contract them into FMAs. The plain PyTorch
// version in ops/moments.py rounds every operation the same way, so
// columns 35-47 agree bit for bit and every monomial is the same float;
// only the order of the 35 sums differs: each lane adds its own members,
// then the warp adds the 32 partial sums in a butterfly (__shfl_xor_sync).
// The Pallas kernel finds tau by bisection; the radix select here returns
// the same value (the kth smallest bits, by definition).
//
// What bounds it on the card: the least work is one d2 (9 flops) per valid
// query-candidate pair plus 70 flops (35 mul + 35 add) per weighted member,
// against 67 TFLOP/s FP32, and reading the candidates (20 B a slot: xyz,
// id, valid) and queries (16 B a slot) and writing 192 B per query slot,
// against 3.35 TB/s. On the 1M-point k=100 main path the bytes dominate.
//
// The design (knn_warp.cuh): one block per cell row stages the row once
// (the Pallas kernel keeps all (C, M) d2 bits in VMEM; here each warp
// keeps its query's M bits in shared memory); one warp per query slot
// computes each d2 once, in a pass that also takes the minimum and its
// first slot, the largest valid bits and how many slots hold them, and
// the valid count (warp reductions); tau and count_lt / count_le then
// come from the four-pass radix select (in place of ~31 bisection rounds
// that each recomputed every d2 under a block-wide loop); one last pass
// over the bits finds the first slot at tau and queues the weighted
// members 32 at a time, so that each lane builds whole monomial chains.
// The 48 outputs are written by consecutive lanes.

#include "knn_warp.cuh"

namespace {

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

// One query slot: its 48 stats, written to o[0, 48). `first` computes
// each slot's bits for the first pass, which stores them to `bits` when
// that is not null (the cached layout); `src` reads them in later passes.
template <class First, class Src, class Row>
__device__ void moments_query(const First& first, unsigned* bits,
                              const Src& src, const Row& row, int M, int k,
                              float qx, float qy, float qz,
                              unsigned char* scratch, int lane, float* o) {
  const int groups = (M + 31) >> 5;
  const unsigned sent = sent_bits();
  // ---- 1. min bits and its first slot, max valid bits and how many
  //         slots hold it, valid count ----
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
  const unsigned wmn = __reduce_min_sync(FULL, mn);
  am_n = static_cast<int>(__reduce_min_sync(
      FULL, mn == wmn ? static_cast<unsigned>(am_n) : static_cast<unsigned>(M)));
  const unsigned wmx = __reduce_max_sync(FULL, n_mx ? mx : 0u);
  const int n_at_mx = static_cast<int>(__reduce_add_sync(
      FULL, (n_mx && mx == wmx) ? static_cast<unsigned>(n_mx) : 0u));
  nv = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(nv)));

  // ---- 2. tau and the counts at it ----
  unsigned tau = 0;
  int count_lt = 0, count_le = 0;
  if (nv >= k) {          // the kth smallest: every unusable slot lies above
    int equal;
    tau = radix_kth(src, M, k, reinterpret_cast<unsigned*>(scratch), lane,
                    &count_lt, &equal);
    count_le = count_lt + equal;
  } else if (nv > 0) {    // the largest valid: every valid slot at or below
    tau = wmx;
    count_le = nv;
    count_lt = nv - n_at_mx;
  }

  // ---- 3. weights and the 35 weighted monomial sums ----
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
  // members (w > 0: below tau, or at tau with a positive tie weight) in
  // slot order through a 64-slot queue; each full 32 go one to a lane
  const unsigned lt_mask = (1u << lane) - 1u;   // lanes below this one
  int queued = 0, am_k = M;   // and the first slot at tau
  for (int g = 0; g < groups; ++g) {
    const int m = (g << 5) + lane;
    const unsigned v = m < M ? src(m) : ~0u;
    const bool mem = v < tau || (v == tau && w_tie > 0.f);
    const unsigned ek = __ballot_sync(FULL, v == tau);
    if (am_k == M && ek) am_k = (g << 5) + __ffs(ek) - 1;
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

  // ---- 4. the output row, staged and written by consecutive lanes ----
  if (lane == 0) {
    const bool found = count_le >= k;
#pragma unroll
    for (int j = 0; j < NMOM; ++j) s.row[j] = acc[j];
    s.row[35] = tau_f;
    s.row[36] = static_cast<float>(count_lt);
    s.row[37] = static_cast<float>(count_le);
    s.row[38] = sigma;
    s.row[39] = __fsub_rn(row.x(am_n), qx);   // am_n < M: M >= 1
    s.row[40] = __fsub_rn(row.y(am_n), qy);
    s.row[41] = __fsub_rn(row.z(am_n), qz);
    const int pk = found ? am_k : 0;
    s.row[42] = found ? __fsub_rn(row.x(pk), qx) : 0.f;
    s.row[43] = found ? __fsub_rn(row.y(pk), qy) : 0.f;
    s.row[44] = found ? __fsub_rn(row.z(pk), qz) : 0.f;
    s.row[45] = found ? 1.f : 0.f;
    s.row[46] = 0.f;
    s.row[47] = 0.f;
  }
  __syncwarp();
  o[lane] = s.row[lane];
  if (lane < NOUT - 32) o[32 + lane] = s.row[32 + lane];
  __syncwarp();
}

// Three blocks an SM: caps the registers at 85 a thread (80 used, no
// spills), 24 resident warps in place of 16; measured faster on the H100.
template <bool CACHED>
__global__ void __launch_bounds__(MAX_WARPS * 32, 3)
moments_kernel(const float* __restrict__ q,      // (T,C,3)
               const float* __restrict__ p,      // (T,M,3)
               const int* __restrict__ cand,     // (T,M)
               const int* __restrict__ qrow,     // (T,C)
               const int* __restrict__ valid,    // (T,M)
               float* __restrict__ out,          // (T,C,48)
               int C, int M, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t t = blockIdx.x;
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
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
      moments_query(RowBits<MomentRule, StagedRow>{b.row, qx, qy, qz, qr},
                    b.bits, CachedBits{b.bits}, b.row, M, k, qx, qy, qz,
                    b.scratch, lane, o);
    } else {
      const GlobalRow row{pt, ct, vt};
      const RowBits<MomentRule, GlobalRow> src{row, qx, qy, qz, qr};
      moments_query(src, nullptr, src, row, M, k, qx, qy, qz, b.scratch, lane,
                    o);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes: q (T,C,3), p (T,M,3) float32; cand (T,M), qrow (T,C), valid (T,M)
// int32; output out (T,C,48) float32; all contiguous. Requires
// 1 <= C <= 512, M >= 1 and k >= 1 (checked by the wrapper).
extern "C" int pct_knn_moments(const float* q, const float* p, const int* cand,
                               const int* qrow, const int* valid, float* out,
                               int T, int C, int M, int k, void* stream) {
  if (T <= 0) return 0;
  const int W = min(MAX_WARPS, C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_cache(W, M)) {
    static bool raised = false;   // above 48 KB needs the attribute
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          moments_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(CACHE_BUDGET));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
    moments_kernel<true><<<T, W * 32, smem_bytes(W, M, true), s>>>(
        q, p, cand, qrow, valid, out, C, M, k);
  } else {
    moments_kernel<false><<<T, W * 32, smem_bytes(W, M, false), s>>>(
        q, p, cand, qrow, valid, out, C, M, k);
  }
  return static_cast<int>(cudaGetLastError());
}
