// Large-k neighborhoods as moment sums, for sm_90a (H100).
//
// Replaces the TPU kernel pct_tpu/ops/pallas_moments.py::_moment_kernel.
// For every cell row t of a bucket and every query slot c of that cell,
// over the M candidate slots of the row (slots with valid <= 0 and the
// query itself, cand == qrow, are skipped):
//   d2    = ((dx*dx + dy*dy) + dz*dz),  d = q - p          (difference form)
//   tau   = the kth smallest valid d2 (>= k valid), else the largest valid
//           d2, else 0: bisection on the int32 bits of d2 (non-negative
//           float32 compares are monotone on their bits), seeded with the
//           bracket [min bits - 1, max valid bits]
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
// only the order of the 35 sums differs (this kernel adds in slot order).
// The Pallas kernel's while-loop runs until the whole batch has converged;
// converged rows are fixpoints of mid = lo + (hi - lo) / 2, so the
// per-query loop here gives the same tau bits.
//
// What bounds it on the card: the least work is one d2 (9 flops) per valid
// query-candidate pair plus 70 flops (35 mul + 35 add) per weighted member,
// against 67 TFLOP/s FP32, and reading the candidates (20 B a slot: xyz,
// id, valid) and queries (16 B a slot) and writing 192 B per query slot,
// against 3.35 TB/s. On the 1M-point k=100 main path the bytes dominate.
//
// What this simple design does about it, and what holds it back: one
// thread block per cell row, one thread per query slot (blockDim = C
// rounded up to 32, C <= 512). The Pallas kernel keeps all (C, M) d2 bits
// in a VMEM scratch of up to 100 MB; a Hopper block has 227 KB of shared
// memory, so each pass instead streams the row's candidates through
// shared memory in chunks of CHUNK slots (coalesced loads; M has no
// limit) and recomputes d2. The passes are: min/max bits, one pass per
// bisection round (~27 on real data: the whole block loops until its
// slowest query converges), one for the counts and first-match slots, one
// for the weighted sums. So the kernel does ~30x the bound's d2 work and
// is far from its bound. Fewer rounds (a radix select over the bits),
// several threads per query and warp-level counts are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NOUT = 48;
constexpr int NMOM = 35;
constexpr int CHUNK = 512;
constexpr int MAX_THREADS = 512;
constexpr float SENT = 3.0e38f;  // d2 of a skipped slot

struct Staged {
  float x[CHUNK], y[CHUNK], z[CHUNK];
  int cand[CHUNK], valid[CHUNK];
};

// Calls f(i, m) for every candidate slot m of the row (i = its index in the
// staged chunk), every thread of the block together: the block stages the
// row's candidates chunk by chunk through shared memory.
template <class F>
__device__ void for_each_candidate(Staged& s, const float* pt, const int* ct,
                                   const int* vt, int M, bool active, F&& f) {
  for (int base = 0; base < M; base += CHUNK) {
    const int len = min(CHUNK, M - base);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const size_t m = base + i;
      s.x[i] = pt[m * 3];
      s.y[i] = pt[m * 3 + 1];
      s.z[i] = pt[m * 3 + 2];
      s.cand[i] = ct[m];
      s.valid[i] = vt[m];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < len; ++i) f(i, base + i);
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
moments_kernel(const float* __restrict__ q,      // (T,C,3)
               const float* __restrict__ p,      // (T,M,3)
               const int* __restrict__ cand,     // (T,M)
               const int* __restrict__ qrow,     // (T,C)
               const int* __restrict__ valid,    // (T,M)
               float* __restrict__ out,          // (T,C,48)
               int C, int M, int k) {
  __shared__ Staged s;

  const size_t t = blockIdx.x;
  const int c = threadIdx.x;
  const bool active = c < C;
  const size_t qi = t * C + c;
  const float* pt = p + t * M * 3;
  const int* ct = cand + t * M;
  const int* vt = valid + t * M;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  int qr = 0;
  if (active) {
    qx = q[qi * 3];
    qy = q[qi * 3 + 1];
    qz = q[qi * 3 + 2];
    qr = qrow[qi];
  }
  const int sent_bits = __float_as_int(SENT);
  // int32 bits of the masked d2 of staged slot i
  auto bits_of = [&](int i) -> int {
    if (s.valid[i] <= 0 || s.cand[i] == qr) return sent_bits;
    const float dx = __fsub_rn(qx, s.x[i]);
    const float dy = __fsub_rn(qy, s.y[i]);
    const float dz = __fsub_rn(qz, s.z[i]);
    return __float_as_int(__fadd_rn(
        __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  };

  // ---- 1. min bits and max valid bits: the bisection bracket ----
  int mn = sent_bits, mx = -1;
  for_each_candidate(s, pt, ct, vt, M, active, [&](int i, int) {
    const int b = bits_of(i);
    mn = min(mn, b);
    if (b != sent_bits) mx = max(mx, b);
  });

  // ---- 2. tau bits by bisection: count_le(lo) < k <= count_le(hi) ----
  int hi = max(mx, 0);
  int lo = min(mn - 1, hi);
  while (__syncthreads_or(active && hi - lo > 1)) {
    const bool open = active && hi - lo > 1;
    const int mid = lo + (hi - lo) / 2;
    int cnt = 0;
    for_each_candidate(s, pt, ct, vt, M, open, [&](int i, int) {
      cnt += bits_of(i) <= mid;
    });
    if (open) {
      if (cnt >= k) hi = mid;
      else lo = mid;
    }
  }
  const int tau = hi;

  // ---- 3. counts at tau, first slots of the minimum and of tau ----
  int count_le = 0, count_lt = 0, am_n = M, am_k = M;
  for_each_candidate(s, pt, ct, vt, M, active, [&](int i, int m) {
    const int b = bits_of(i);
    count_le += b <= tau;
    count_lt += b < tau;
    if (b == mn && am_n == M) am_n = m;
    if (b == tau && am_k == M) am_k = m;
  });

  // ---- 4. weights and the 35 weighted monomial sums ----
  const float tau_f = __int_as_float(tau);
  const float sigma = __fsqrt_rn(fmaxf(tau_f, 0.f));
  const float inv = __fdiv_rn(1.f, fmaxf(sigma, 1e-30f));
  const int count_eq = max(count_le - count_lt, 1);
  const float w_tie = fminf(fmaxf(__fdiv_rn(static_cast<float>(k - count_lt),
                                            static_cast<float>(count_eq)),
                                  0.f), 1.f);
  float acc[NMOM];
#pragma unroll
  for (int j = 0; j < NMOM; ++j) acc[j] = 0.f;
  for_each_candidate(s, pt, ct, vt, M, active, [&](int i, int) {
    const int b = bits_of(i);
    if (b > tau) return;
    const float w = b < tau ? 1.f : w_tie;
    if (w == 0.f) return;  // adds an exact +-0 to every sum
    const float xh = fminf(fmaxf(__fmul_rn(__fsub_rn(s.x[i], qx), inv), -2.f), 2.f);
    const float yh = fminf(fmaxf(__fmul_rn(__fsub_rn(s.y[i], qy), inv), -2.f), 2.f);
    const float zh = fminf(fmaxf(__fmul_rn(__fsub_rn(s.z[i], qz), inv), -2.f), 2.f);
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
  });

  if (!active) return;
  const bool found = count_le >= k;
  float* o = out + qi * NOUT;
#pragma unroll
  for (int j = 0; j < NMOM; ++j) o[j] = acc[j];
  o[35] = tau_f;
  o[36] = static_cast<float>(count_lt);
  o[37] = static_cast<float>(count_le);
  o[38] = sigma;
  const size_t pn = static_cast<size_t>(am_n) * 3;  // am_n < M: M >= 1
  o[39] = __fsub_rn(pt[pn], qx);
  o[40] = __fsub_rn(pt[pn + 1], qy);
  o[41] = __fsub_rn(pt[pn + 2], qz);
  const size_t pk = static_cast<size_t>(found ? am_k : 0) * 3;
  o[42] = found ? __fsub_rn(pt[pk], qx) : 0.f;
  o[43] = found ? __fsub_rn(pt[pk + 1], qy) : 0.f;
  o[44] = found ? __fsub_rn(pt[pk + 2], qz) : 0.f;
  o[45] = found ? 1.f : 0.f;
  o[46] = 0.f;
  o[47] = 0.f;
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
  const int threads = ((C + 31) / 32) * 32;
  moments_kernel<<<T, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, p, cand, qrow, valid, out, C, M, k);
  return static_cast<int>(cudaGetLastError());
}
