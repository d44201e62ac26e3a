// k-nearest selection emitting winner ids or positions, for sm_90a (H100).
//
// Replaces two TPU kernels of pct_tpu/ops/pallas_select.py:
//   _select_rows_kernel -> pct_select_rows: out[t,c,j] = cand[t, m_j]
//   _select_kernel      -> pct_select_pos:  out[t,c,j] = m_j
// For every cell row t of a bucket and every query slot c of that cell:
//   d2[m] = ((dx*dx + dy*dy) + dz*dz),  d = q[t,c] - p[t,m]   (difference form)
//   slots with valid[t,m] == 0 or cand[t,m] == qrow[t,c] (self) are skipped,
//   and so is any d2 at or above the 3e38 sentinel
//   emit the k smallest in ascending (d2, m) order: dist = sqrt(d2) and either
//   the winner's id cand[t,m] (rows) or its slot m (positions). Missing slots
//   (fewer than k usable candidates) carry (3e38, m = 0): distance sqrt(3e38)
//   and cand[t,0] or 0, which is what the Pallas kernels' k rounds of min /
//   first-argmin / mask-out give once every slot reads 3e38. Callers test
//   found = d < 1e18. `cand` holds whatever ids the caller wants back (sorted
//   rows, or original point ids); self-exclusion compares it with `qrow`.
//
// Bit-exactness: d2 uses __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract
// it into FMAs, and the distance is __fsqrt_rn; the plain PyTorch versions in
// ops/select.py do the same IEEE operations in the same order, so the two
// agree bit for bit on the card.
//
// What bounds it on the card: a bucket of T cells, C query slots and M
// candidate slots must read the candidates (20 B a slot: xyz, id, valid) and
// queries (16 B a slot: xyz, id) and write k*8 B per query slot (distance and
// id) against 3.35 TB/s, and does T*C*M pair evaluations of ~9 float32
// operations against the 67 TFLOP/s FP32 rate. On the 1M-point k=20 and
// k=100 paths the output bytes dominate: the bound is the bytes.
//
// The design (knn_warp.cuh): one block per cell row stages the row once; one
// warp per query slot computes each d2 once into its bit slice, finds the
// kth smallest bits tau and the count below it by a four-pass radix select,
// compacts in slot order every slot below tau and then the first k - below
// slots equal to tau (ballot + popc prefix sums: exactly the k smallest
// (d2, m) pairs), sorts those <= 128 keys (d2 bits << 32 | m) with a bitonic
// network in the warp's scratch, and writes them with consecutive lanes on
// consecutive j. That is the set and the order the Pallas kernels' rounds of
// min and first-argmin emit. It replaces a per-thread sorted list whose
// insertions (up to k shifts per accepted candidate, in local memory at
// k > 64) set the old kernel's time.

#include "knn_warp.cuh"

namespace {

using namespace knn_warp;

constexpr int KMAX = 128;

// select: usable when valid != 0, not the query itself and below the
// sentinel (nothing at or above it is ever selected)
struct SelectRule {
  __device__ static unsigned bits(int valid, int cand, int qr, unsigned b) {
    return (valid != 0 && cand != qr && b < sent_bits()) ? b : sent_bits();
  }
};

// Sort keys[0, n) ascending in place (bitonic network over the next power
// of two, padded with ~0), every lane of the warp together.
__device__ void warp_sort(unsigned long long* keys, int n, int lane) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = n + lane; i < P; i += 32) keys[i] = ~0ull;
  __syncwarp();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (P >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncwarp();
    }
  }
}

// One query slot: the k winners of src over the row's M slots, written to
// dist[0, k) and out[0, k).
template <bool ROWS, class Src, class Row>
__device__ void select_query(const Src& src, const Row& row, int M, int k,
                             unsigned char* scratch, int lane, float* dist,
                             int* out) {
  const int kk = min(k, M);
  int below, equal;
  const unsigned tau = radix_kth(src, M, kk, reinterpret_cast<unsigned*>(
                                     scratch), lane, &below, &equal);
  // slots below tau, then the first kk - below equal to tau; a tau at the
  // sentinel adds none (those slots are missing)
  const int n = below + (tau < sent_bits() ? kk - below : 0);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(scratch);
  int base = 0, eq_left = n - below;
  const unsigned lt_mask = (1u << lane) - 1u;   // lanes below this one
  const int groups = (M + 31) >> 5;
  for (int g = 0; g < groups && base < n; ++g) {
    const int m = (g << 5) + lane;
    const unsigned v = m < M ? src(m) : ~0u;
    const bool lt = v < tau;
    const unsigned eq = __ballot_sync(FULL, v == tau);
    const bool take = lt || (v == tau && __popc(eq & lt_mask) < eq_left);
    const unsigned took = __ballot_sync(FULL, take);
    if (take)
      keys[base + __popc(took & lt_mask)] =
          (static_cast<unsigned long long>(v) << 32) | static_cast<unsigned>(m);
    base += __popc(took);
    eq_left -= min(__popc(eq), eq_left);
  }
  __syncwarp();
  warp_sort(keys, n, lane);
  const float missing = __fsqrt_rn(SENT);
  for (int j = lane; j < k; j += 32) {
    float d = missing;
    int w = 0;
    if (j < n) {
      const unsigned long long key = keys[j];
      w = static_cast<int>(key & 0xffffffffu);
      d = __fsqrt_rn(fmaxf(__uint_as_float(static_cast<unsigned>(key >> 32)),
                           0.f));
    }
    dist[j] = d;
    out[j] = ROWS ? row.id(w) : w;
  }
  __syncwarp();
}

template <bool ROWS, bool CACHED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
select_ids_kernel(const float* __restrict__ q,      // (T,C,3)
                  const float* __restrict__ p,      // (T,M,3)
                  const int* __restrict__ cand,     // (T,M)
                  const int* __restrict__ qrow,     // (T,C)
                  const int* __restrict__ valid,    // (T,M)
                  float* __restrict__ dist,         // (T,C,k)
                  int* __restrict__ out,            // (T,C,k)
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
    float* d = dist + qi * k;
    int* o = out + qi * k;
    if constexpr (CACHED) {
      fill_bits<SelectRule>(b.bits, b.row, qx, qy, qz, qr, M, lane);
      select_query<ROWS>(CachedBits{b.bits}, b.row, M, k, b.scratch, lane, d,
                         o);
    } else {
      const GlobalRow row{pt, ct, vt};
      select_query<ROWS>(RowBits<SelectRule, GlobalRow>{row, qx, qy, qz, qr},
                         row, M, k, b.scratch, lane, d, o);
    }
  }
}

template <bool ROWS>
int launch(const float* q, const float* p, const int* cand, const int* qrow,
           const int* valid, float* dist, int* out, int T, int C, int M, int k,
           void* stream) {
  if (T <= 0) return 0;
  const int W = min(MAX_WARPS, C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_cache(W, M)) {
    static bool raised = false;   // above 48 KB needs the attribute
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          select_ids_kernel<ROWS, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(CACHE_BUDGET));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
    select_ids_kernel<ROWS, true><<<T, W * 32, smem_bytes(W, M, true), s>>>(
        q, p, cand, qrow, valid, dist, out, C, M, k);
  } else {
    select_ids_kernel<ROWS, false><<<T, W * 32, smem_bytes(W, M, false), s>>>(
        q, p, cand, qrow, valid, dist, out, C, M, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
// Shapes: q (T,C,3), p (T,M,3) float32; cand (T,M), qrow (T,C), valid (T,M)
// int32; outputs dist (T,C,k) float32 and rows / pos (T,C,k) int32; all
// contiguous. Require 1 <= C <= 1024, M >= 1 and 1 <= k <= 128 (checked by
// the wrapper).
extern "C" int pct_select_rows(const float* q, const float* p, const int* cand,
                               const int* qrow, const int* valid, float* dist,
                               int* rows, int T, int C, int M, int k,
                               void* stream) {
  if (k < 1 || k > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, p, cand, qrow, valid, dist, rows, T, C, M, k, stream);
}

extern "C" int pct_select_pos(const float* q, const float* p, const int* cand,
                              const int* qrow, const int* valid, float* dist,
                              int* pos, int T, int C, int M, int k,
                              void* stream) {
  if (k < 1 || k > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(q, p, cand, qrow, valid, dist, pos, T, C, M, k, stream);
}
