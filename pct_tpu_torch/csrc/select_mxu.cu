// The k-nearest coords select with the winner extraction as a matrix
// product on the tensor cores, for sm_90a (H100): an A/B instrument beside
// select_coords.cu, not on any entry point's path.
//
// Replaces the TPU kernel scripts/micro_select_mxu.py::_mxu_kernel. Per
// cell row t and query slot c, over the M candidate slots (slots with
// valid <= 0 and the query itself, cand == qrow, read d2 = 3e38):
//   d2 in the difference form ((dx*dx + dy*dy) + dz*dz), d = q - p;
//   k rounds of: the minimum, the FIRST slot holding it, that slot set to
//   3e38; dist = sqrt(max(min, 0));
//   the round's winner extracted as a one-hot row times the (M, 4) matrix
//   P = [x, y, z, float(cand)], so rows = int(float(cand)) (ids above
//   2^24 round as float32 does).
// Once the usable slots are used up every d2 reads 3e38, so a missing
// slot carries dist sqrt(3e38) and slot 0's coordinates and id.
//
// The rounds' winners are the k smallest (d2, slot) pairs in order; the
// warp finds them as select_coords.cu does (knn_warp.cuh: d2 once into
// the bit cache, the radix select, compaction and the warp sort). The
// extraction is then the product the script times: for each group of 8
// rounds, A (8 x M, one-hot rows) times B = P padded to (M, 8) with
// zeros, on the tensor cores as mma.sync m8n8k4 in FP64, M / 4 steps. A
// one-hot row times float32 values converted to double is exact, and so
// is the double sum of one value and zeros, so the product returns each
// winner's float32 coordinates and float(cand) bit for bit (a -0.0
// coordinate reads +0.0: the sum starts from +0). Plain TF32 would round
// the coordinates to 10 mantissa bits, the Hopper twin of the TPU's bf16
// pass.
//
// Layout: block_cells cell rows a block, one after the other (the TPU
// takes block_cells rows a grid step); warps over a row's query slots.
//
// What bounds it on the card: select_coords.cu's pairs (9 flops each) and
// bytes, plus the extraction's 2 * 8 * M * 4 flops per 8 rounds of a
// query (8 k C M a cell row: the one-hot product done densely, as the
// script does), against the 67 TFLOP/s of FP32 and of FP64 tensor cores.

#include "knn_warp.cuh"

namespace {

using namespace knn_warp;

constexpr int KMAX = 128;

// usable when valid > 0, not the query itself and below the sentinel
struct MxuRule {
  __device__ static unsigned bits(int valid, int cand, int qr, unsigned b) {
    return (valid > 0 && cand != qr && b < sent_bits()) ? b : sent_bits();
  }
};

// D (8x8, two doubles a lane) += A (8x4, one a lane) * B (4x8, one a lane)
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// One query's outputs from its n sorted winner keys: dist[j], and
// (x, y, z, float(cand)) of round j's winner through the one-hot product.
// Fragments (PTX m8n8k4 .f64): lane l holds A[l/4][l%4], B[l%4][l/4] and
// D[l/4][2(l%4)], D[l/4][2(l%4)+1].
template <class Row>
__device__ void extract(const Row& row, const unsigned long long* keys,
                        int n, size_t qi, int k, int M, int lane,
                        float* dist, float* nbr, int* rows) {
  const float missing = __fsqrt_rn(SENT);
  for (int j = lane; j < k; j += 32)
    dist[qi * k + j] = j < n ? key_dist(keys[j]) : missing;
  const int ar = lane >> 2, ac = lane & 3;   // A: row (round), column (slot)
  const int bs = lane & 3, bn = lane >> 2;   // B: row (slot), column
  for (int r0 = 0; r0 < k; r0 += 8) {
    const int j = r0 + ar;
    // this lane's A row: round j's winner (slot 0 when missing), none past k
    const int w = j < k ? (j < n ? key_pos(keys[j]) : 0) : -1;
    double d0 = 0.0, d1 = 0.0;
    for (int s = 0; s < M; s += 4) {
      const double a = (s + ac == w) ? 1.0 : 0.0;
      const int m = s + bs;
      double b = 0.0;
      if (m < M) {
        if (bn == 0) b = row.x(m);
        else if (bn == 1) b = row.y(m);
        else if (bn == 2) b = row.z(m);
        else if (bn == 3) b = __int2float_rn(row.id(m));
      }
      mma_f64(d0, d1, a, b);
    }
    if (j < k) {
      const size_t o = qi * k + j;
      if (ac == 0) {          // columns 0, 1: x, y
        nbr[o * 3] = static_cast<float>(d0);
        nbr[o * 3 + 1] = static_cast<float>(d1);
      } else if (ac == 1) {   // columns 2, 3: z, float(cand)
        nbr[o * 3 + 2] = static_cast<float>(d0);
        rows[o] = static_cast<int>(static_cast<float>(d1));
      }
    }
  }
}

template <bool CACHED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
mxu_kernel(const float* __restrict__ q,      // (T,C,3)
           const float* __restrict__ p,      // (T,M,3)
           const int* __restrict__ cand,     // (T,M)
           const int* __restrict__ qrow,     // (T,C)
           const int* __restrict__ valid,    // (T,M)
           float* __restrict__ dist,         // (T,C,k)
           float* __restrict__ nbr,          // (T,C,k,3)
           int* __restrict__ rows,           // (T,C,k)
           int C, int M, int k, int bc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  for (int r = 0; r < bc; ++r) {
    const size_t t = static_cast<size_t>(blockIdx.x) * bc + r;
    if (r > 0) __syncthreads();   // every warp is done with the last row
    const float* pt = p + t * M * 3;
    const int* ct = cand + t * M;
    const int* vt = valid + t * M;
    const Block b = carve(smem, CACHED, W, warp, pt, ct, vt, M);
    const unsigned long long* keys =
        reinterpret_cast<const unsigned long long*>(b.scratch);
    for (int c = warp; c < C; c += W) {
      const size_t qi = t * C + c;
      const float qx = q[qi * 3], qy = q[qi * 3 + 1], qz = q[qi * 3 + 2];
      const int qr = qrow[qi];
      if constexpr (CACHED) {
        fill_bits<MxuRule>(b.bits, b.row, qx, qy, qz, qr, M, lane);
        const int n = select_sorted(CachedBits{b.bits}, M, k, b.scratch, lane);
        extract(b.row, keys, n, qi, k, M, lane, dist, nbr, rows);
      } else {
        const GlobalRow row{pt, ct, vt};
        const int n = select_sorted(
            RowBits<MxuRule, GlobalRow>{row, qx, qy, qz, qr}, M, k,
            b.scratch, lane);
        extract(row, keys, n, qi, k, M, lane, dist, nbr, rows);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes: q (T,C,3), p (T,M,3) float32; cand (T,M), qrow (T,C), valid (T,M)
// int32; outputs dist (T,C,k), nbr (T,C,k,3) float32, rows (T,C,k) int32;
// all contiguous. Requires T % bc == 0, 1 <= C <= 1024, M >= 1 and
// 1 <= k <= 128 (checked by the wrapper).
extern "C" int pct_select_coords_mxu(const float* q, const float* p,
                                     const int* cand, const int* qrow,
                                     const int* valid, float* dist,
                                     float* nbr, int* rows, int T, int C,
                                     int M, int k, int bc, void* stream) {
  if (T <= 0) return 0;
  if (k < 1 || k > KMAX || bc < 1 || T % bc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = min(MAX_WARPS, C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_cache(W, M)) {
    static bool raised = false;   // above 48 KB needs the attribute
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          mxu_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(CACHE_BUDGET));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
    mxu_kernel<true><<<T / bc, W * 32, smem_bytes(W, M, true), s>>>(
        q, p, cand, qrow, valid, dist, nbr, rows, C, M, k, bc);
  } else {
    mxu_kernel<false><<<T / bc, W * 32, smem_bytes(W, M, false), s>>>(
        q, p, cand, qrow, valid, dist, nbr, rows, C, M, k, bc);
  }
  return static_cast<int>(cudaGetLastError());
}
