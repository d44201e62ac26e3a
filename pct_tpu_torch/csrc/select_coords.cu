// k-nearest selection with winner coordinates, for sm_90a (H100).
//
// Replaces the TPU kernel pct_tpu/ops/pallas_select.py::_select_coords_kernel.
// For every cell row t of a bucket and every query slot c of that cell:
//   d2[m] = ((dx*dx + dy*dy) + dz*dz),  d = q[t,c] - p[t,m]   (difference form)
//   slots with valid[t,m] == 0 or cand[t,m] == qrow[t,c] (self) are skipped,
//   and so is any d2 at or above the 3e38 sentinel
//   emit the k smallest in ascending (d2, m) order: dist = sqrt(d2) and the
//   winner's xyz. Missing slots (fewer than k usable candidates) carry
//   (3e38, m = 0): distance sqrt(3e38) and the coords of candidate slot 0,
//   which is what the Pallas kernel's k rounds of min / first-argmin /
//   mask-out give once every slot reads 3e38. Callers test found = d < 1e18.
//
// Bit-exactness: d2 uses __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract
// it into FMAs, and the distance is __fsqrt_rn; the plain PyTorch version in
// ops/select.py does the same IEEE operations in the same order, so the two
// agree bit for bit on the card.
//
// What bounds it on the card: a bucket of T cells, C query slots and M
// candidate slots does T*C*M pair evaluations of ~9 float32 operations
// (3 sub, 3 mul, 2 add, 1 compare) against the 67 TFLOP/s FP32 rate, and
// must read the candidates (20 B a slot: xyz, id, valid) and queries
// (16 B a slot) and write k*(4 + 12) B per query slot against 3.35 TB/s.
// On the 1M-point k=20 main path the output bytes dominate: the kernel is
// memory-bound by its writes.
//
// The design is the rows kernel's (knn_warp.cuh's select_kernel): one block
// per cell row stages the row (xyz, id, valid) in shared memory, or streams
// it from device memory past its scratch class's budget; one warp per
// query slot computes each d2 once, finds the kth by the radix select,
// compacts and sorts the winner keys (up to k = 1024 the scratch class of k,
// past it the block class, as in select_rows.cu). Only the emitter differs: each winner's xyz comes
// from the staged row in shared memory (not read back from device
// memory), and the lanes write the slot's contiguous (k, 3) coordinates
// and its k distances with consecutive lanes on consecutive floats (the
// block class's threads likewise; its coordinates come from device memory).
// Every output offset is size_t: 1M query slots at k = 1024 write 12.9 GB
// of coordinates.

#include "knn_warp.cuh"

namespace {

using namespace knn_warp;

// dist[j] = sqrt(d2) and nbr[j, 0:3] = the winner's xyz from `row`; missing
// winners read (3e38, the xyz of slot 0).
struct CoordsOut {
  float* dist;   // (T,C,k)
  float* nbr;    // (T,C,k,3)
  template <class Row>
  __device__ void write(const Row& row, const unsigned long long* keys, int n,
                        size_t qi, int k, int lane) const {
    const float missing = __fsqrt_rn(SENT);
    for (int j = lane; j < k; j += 32)
      dist[qi * k + j] = j < n ? key_dist(keys[j]) : missing;
    float* o = nbr + qi * k * 3;
    for (int e = lane; e < 3 * k; e += 32) {
      const int j = e / 3;
      const int a = e - 3 * j;
      const int w = j < n ? key_pos(keys[j]) : 0;
      o[e] = a == 0 ? row.x(w) : (a == 1 ? row.y(w) : row.z(w));
    }
  }
  // The same outputs from the block class: every thread of the block.
  template <class Row>
  __device__ void write_block(const Row& row, const unsigned long long* keys,
                              int n, size_t qi, int k) const {
    const float missing = __fsqrt_rn(SENT);
    for (int j = threadIdx.x; j < k; j += BLOCK_THREADS)
      dist[qi * k + j] = j < n ? key_dist(keys[j]) : missing;
    float* o = nbr + qi * k * 3;
    for (int e = threadIdx.x; e < 3 * k; e += BLOCK_THREADS) {
      const int j = e / 3;
      const int a = e - 3 * j;
      const int w = j < n ? key_pos(keys[j]) : 0;
      o[e] = a == 0 ? row.x(w) : (a == 1 ? row.y(w) : row.z(w));
    }
  }
};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes: q (T,C,3), p (T,M,3) float32; cand (T,M), qrow (T,C), valid (T,M)
// int32; outputs dist (T,C,k), nbr (T,C,k,3) float32; all contiguous.
// Requires C >= 1, M >= 1 and k >= 1 (checked by the wrapper); `ws` as
// select_rows.cu's entry points take it.
extern "C" int pct_select_coords(const float* q, const float* p, const int* cand,
                                 const int* qrow, const int* valid, float* dist,
                                 float* nbr, void* ws, int T, int C, int M,
                                 int k, void* stream) {
  return launch_select_any(q, p, cand, qrow, valid, CoordsOut{dist, nbr}, ws,
                           T, C, M, k, stream);
}
