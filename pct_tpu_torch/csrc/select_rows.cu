// k-nearest selection emitting winner ids or positions, for sm_90a (H100).
//
// Replaces two TPU kernels of pct_tpu/ops/pallas_select.py:
//   _select_rows_kernel -> pct_select_rows: out[t,c,j] = cand[t, m_j]
//   _select_kernel      -> pct_select_pos:  out[t,c,j] = m_j
// For every cell row t of a bucket and every query slot c of that cell:
//   d2[m] = ((dx*dx + dy*dy) + dz*dz),  d = q[t,c] - p[t,m]   (difference form)
//   slots with valid[t,m] == 0 or cand[t,m] == qrow[t,c] (self) are skipped
//   emit the k smallest in ascending (d2, m) order: dist = sqrt(d2) and either
//   the winner's id cand[t,m] (rows) or its slot m (positions). Missing slots
//   (fewer than k usable candidates) keep (3e38, m = 0): distance sqrt(3e38)
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
// What this simple design does about it, and what holds it back: one thread
// block per cell row, one thread per query slot (blockDim = C rounded up to
// 32). The block stages its candidates through shared memory in chunks of
// CHUNK slots (coalesced, each candidate read from device memory once per
// cell). Each thread keeps its k best (d2, m) pairs sorted ascending in
// thread-local arrays and inserts a candidate only when d2 is STRICTLY less
// than its current k-th, after any equal entries: with m scanned in
// increasing order that reproduces first-argmin tie order. The k-th distance
// is kept in a register, so a rejected candidate costs no list access. What
// holds it back is the insertion: each accepted candidate shifts up to k
// entries of a list that lives in local memory (KM*8 B a thread, L1/L2
// backed), and threads of a warp shift by different amounts. At k=100 over
// M ~ 1,000 candidates a query accepts a few hundred candidates, so the list
// traffic, not the bytes, sets the time. Lists in registers, several threads
// per query and outputs staged through shared memory are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CHUNK = 256;
constexpr float MISSING_D2 = 3.0e38f;

template <int KM, bool ROWS>
__global__ void select_ids_kernel(const float* __restrict__ q,      // (T,C,3)
                                  const float* __restrict__ p,      // (T,M,3)
                                  const int* __restrict__ cand,     // (T,M)
                                  const int* __restrict__ qrow,     // (T,C)
                                  const int* __restrict__ valid,    // (T,M)
                                  float* __restrict__ dist,         // (T,C,k)
                                  int* __restrict__ out,            // (T,C,k)
                                  int C, int M, int k) {
  __shared__ float sx[CHUNK], sy[CHUNK], sz[CHUNK];
  __shared__ int sc[CHUNK], sv[CHUNK];

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
  float td[KM];
  int tm[KM];
  for (int j = 0; j < k; ++j) {
    td[j] = MISSING_D2;
    tm[j] = 0;
  }
  float worst = MISSING_D2;  // td[k - 1]

  for (int base = 0; base < M; base += CHUNK) {
    const int len = min(CHUNK, M - base);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const size_t m = base + i;
      sx[i] = pt[m * 3];
      sy[i] = pt[m * 3 + 1];
      sz[i] = pt[m * 3 + 2];
      sc[i] = ct[m];
      sv[i] = vt[m];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < len; ++i) {
      if (sv[i] == 0 || sc[i] == qr) continue;
      const float dx = __fsub_rn(qx, sx[i]);
      const float dy = __fsub_rn(qy, sy[i]);
      const float dz = __fsub_rn(qz, sz[i]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < worst) {
        int j = k - 1;
        while (j > 0 && td[j - 1] > d2) {
          td[j] = td[j - 1];
          tm[j] = tm[j - 1];
          --j;
        }
        td[j] = d2;
        tm[j] = base + i;
        worst = td[k - 1];
      }
    }
  }
  if (!active) return;
  for (int j = 0; j < k; ++j) {
    const size_t o = qi * k + j;
    dist[o] = __fsqrt_rn(fmaxf(td[j], 0.f));
    out[o] = ROWS ? ct[tm[j]] : tm[j];
  }
}

template <bool ROWS>
int launch(const float* q, const float* p, const int* cand, const int* qrow,
           const int* valid, float* dist, int* out, int T, int C, int M, int k,
           void* stream) {
  if (T <= 0) return 0;
  const int threads = ((C + 31) / 32) * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 64) {
    select_ids_kernel<64, ROWS><<<T, threads, 0, s>>>(q, p, cand, qrow, valid,
                                                      dist, out, C, M, k);
  } else {
    select_ids_kernel<128, ROWS><<<T, threads, 0, s>>>(q, p, cand, qrow, valid,
                                                       dist, out, C, M, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
// Shapes: q (T,C,3), p (T,M,3) float32; cand (T,M), qrow (T,C), valid (T,M)
// int32; outputs dist (T,C,k) float32 and rows / pos (T,C,k) int32; all
// contiguous. Require 1 <= C <= 1024 and 1 <= k <= 128 (checked by the
// wrapper).
extern "C" int pct_select_rows(const float* q, const float* p, const int* cand,
                               const int* qrow, const int* valid, float* dist,
                               int* rows, int T, int C, int M, int k,
                               void* stream) {
  return launch<true>(q, p, cand, qrow, valid, dist, rows, T, C, M, k, stream);
}

extern "C" int pct_select_pos(const float* q, const float* p, const int* cand,
                              const int* qrow, const int* valid, float* dist,
                              int* pos, int T, int C, int M, int k,
                              void* stream) {
  return launch<false>(q, p, cand, qrow, valid, dist, pos, T, C, M, k, stream);
}
