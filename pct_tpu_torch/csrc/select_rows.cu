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
// The design (knn_warp.cuh's select_kernel, shared with select_coords.cu):
// one block per cell row stages the row once; one warp per query slot
// computes each d2 once into its bit slice, finds the kth smallest bits tau
// and the count below it by a four-pass radix select, compacts in slot order
// every slot below tau and then the first k - below slots equal to tau
// (ballot + popc prefix sums: exactly the k smallest (d2, m) pairs), sorts
// those <= k keys (d2 bits << 32 | m) with a bitonic network in the warp's
// scratch, and writes them with consecutive lanes on consecutive j. That is
// the set and the order the Pallas kernels' rounds of min and first-argmin
// emit. Up to k = 1024 the warp's scratch is a class chosen by k (1 KB up
// to k = 128; 2 / 4 / 8 KB up to 256 / 512 / 1024, the sort's keys), and
// so is the shared-memory budget under which the row is staged. Past 1024
// the block class (knn_warp.cuh's select_block_kernel) gives a whole block
// to one query slot: the same radix select and compaction block-wide, the
// sort in shared memory up to 16,384 keys and past that over a
// device-memory workspace, so any k runs, as the Pallas kernels take any k.
// Every output offset is size_t (qi * k): 1M query slots at k = 2048 write
// 8.4 GB a tensor.

#include "knn_warp.cuh"

namespace {

using namespace knn_warp;

// dist[j] = sqrt(d2) and the winner's id cand[m] (ROWS) or slot m, with
// consecutive lanes on consecutive j; missing winners read (3e38, m = 0).
template <bool ROWS>
struct IdsOut {
  float* dist;   // (T,C,k)
  int* out;      // (T,C,k)
  template <class Row>
  __device__ void write(const Row& row, const unsigned long long* keys, int n,
                        size_t qi, int k, int lane) const {
    const float missing = __fsqrt_rn(SENT);
    for (int j = lane; j < k; j += 32) {
      float d = missing;
      int w = 0;
      if (j < n) {
        w = key_pos(keys[j]);
        d = key_dist(keys[j]);
      }
      dist[qi * k + j] = d;
      out[qi * k + j] = ROWS ? row.id(w) : w;
    }
  }
  // The same outputs from the block class: every thread of the block.
  template <class Row>
  __device__ void write_block(const Row& row, const unsigned long long* keys,
                              int n, size_t qi, int k) const {
    const float missing = __fsqrt_rn(SENT);
    for (int j = threadIdx.x; j < k; j += BLOCK_THREADS) {
      float d = missing;
      int w = 0;
      if (j < n) {
        const unsigned long long key = keys[j];
        w = key_pos(key);
        d = key_dist(key);
      }
      dist[qi * k + j] = d;
      out[qi * k + j] = ROWS ? row.id(w) : w;
    }
  }
};

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
// Shapes: q (T,C,3), p (T,M,3) float32; cand (T,M), qrow (T,C), valid (T,M)
// int32; outputs dist (T,C,k) float32 and rows / pos (T,C,k) int32; all
// contiguous. Require C >= 1, M >= 1 and k >= 1 (checked by the wrapper).
// `ws`: past k = 1024 where min(k, M) > 16,384, the device-memory sort's
// workspace of min(T*C, WS_BLOCKS) * min(k, M) int64 keys; else null.
extern "C" int pct_select_rows(const float* q, const float* p, const int* cand,
                               const int* qrow, const int* valid, float* dist,
                               int* rows, void* ws, int T, int C, int M, int k,
                               void* stream) {
  return launch_select_any(q, p, cand, qrow, valid, IdsOut<true>{dist, rows},
                           ws, T, C, M, k, stream);
}

extern "C" int pct_select_pos(const float* q, const float* p, const int* cand,
                              const int* qrow, const int* valid, float* dist,
                              int* pos, void* ws, int T, int C, int M, int k,
                              void* stream) {
  return launch_select_any(q, p, cand, qrow, valid, IdsOut<false>{dist, pos},
                           ws, T, C, M, k, stream);
}

// The layout the selects take at (C, M, k): the dynamic shared bytes a
// block, positive where the bits (the block class) or the row (the warp
// classes) are staged, negative where every pass reads device memory.
extern "C" long long pct_select_layout(int C, int M, int k) {
  if (C < 1 || M < 1 || k < 1) return 0;
  if (k > KWARP)
    return block_cached(M, k)
               ? static_cast<long long>(block_smem_bytes(M, k, true))
               : -static_cast<long long>(block_smem_bytes(M, k, false));
  return select_layout(C, M, k);
}
