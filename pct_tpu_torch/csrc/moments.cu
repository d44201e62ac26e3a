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
// The design (knn_warp.cuh; the per-query stages in moments_warp.cuh,
// shared with moments_split.cu): one block per cell row stages the row
// once (the Pallas kernel keeps all (C, M) d2 bits in VMEM; here each warp
// keeps its query's M bits in shared memory); one warp per query slot
// computes each d2 once, in a pass that also takes the minimum and its
// first slot, the largest valid bits and how many slots hold them, and
// the valid count (warp reductions); tau and count_lt / count_le then
// come from the four-pass radix select (in place of ~31 bisection rounds
// that each recomputed every d2 under a block-wide loop); one last pass
// over the bits finds the first slot at tau and queues the weighted
// members 32 at a time, so that each lane builds whole monomial chains.
// The 48 outputs are written by consecutive lanes.

#include "moments_warp.cuh"

namespace {

using namespace moments_warp;

// One query slot: its 48 stats, written to o[0, 48). `first` computes
// each slot's bits for the first pass, which stores them to `bits` when
// that is not null (the cached layout); `src` reads them in later passes.
template <class First, class Src, class Row>
__device__ void moments_query(const First& first, unsigned* bits,
                              const Src& src, const Row& row, int M, int k,
                              float qx, float qy, float qz,
                              unsigned char* scratch, int lane, float* o) {
  // ---- 1. min bits and its first slot, max valid bits and how many
  //         slots hold it, valid count ----
  const FirstPass f = first_pass(first, bits, M, lane);

  // ---- 2. tau and the counts at it ----
  unsigned tau = 0;
  int count_lt = 0, count_le = 0;
  if (f.nv >= k) {        // the kth smallest: every unusable slot lies above
    int equal;
    tau = radix_kth(src, M, k, reinterpret_cast<unsigned*>(scratch), lane,
                    &count_lt, &equal);
    count_le = count_lt + equal;
  } else if (f.nv > 0) {  // the largest valid: every valid slot at or below
    tau = f.mx;
    count_le = f.nv;
    count_lt = f.nv - f.n_at_mx;
  }

  // ---- 3. weights, the 35 weighted monomial sums, the output row ----
  finish_query<true, true>(src, row, M, k, tau, count_lt, count_le, f.am_n,
                           qx, qy, qz, scratch, lane, o);
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
