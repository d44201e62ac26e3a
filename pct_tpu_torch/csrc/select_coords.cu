// k-nearest selection with winner coordinates, for sm_90a (H100).
//
// Replaces the TPU kernel pct_tpu/ops/pallas_select.py::_select_coords_kernel.
// For every cell row t of a bucket and every query slot c of that cell:
//   d2[m] = ((dx*dx + dy*dy) + dz*dz),  d = q[t,c] - p[t,m]   (difference form)
//   slots with valid[t,m] == 0 or cand[t,m] == qrow[t,c] (self) are skipped
//   emit the k smallest in ascending (d2, m) order: dist = sqrt(d2) and the
//   winner's xyz. Missing slots (fewer than k usable candidates) keep
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
// What this simple design does about it: one thread block per cell row,
// one thread per query slot (blockDim = C rounded up to 32). The block
// stages its candidates through shared memory in chunks of CHUNK slots
// (coalesced loads, each candidate read from device memory once per cell,
// not once per query). Each thread keeps its k best (d2, m) pairs sorted
// ascending and inserts a candidate only when d2 is STRICTLY less than its
// current k-th, after any equal entries: with m scanned in increasing
// order that reproduces first-argmin tie order. The pairs live in
// thread-local arrays (local memory, L1-cached); winners' coordinates are
// read back once at the end. Keeping the lists in registers, splitting a
// query's scan over several threads and writing the outputs through shared
// memory are later work. The list length KM is a template parameter: 64 for
// k <= 64 (the k=20 main path), 128 above.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CHUNK = 256;
constexpr float MISSING_D2 = 3.0e38f;

template <int KM>
__global__ void select_coords_kernel(const float* __restrict__ q,      // (T,C,3)
                                     const float* __restrict__ p,      // (T,M,3)
                                     const int* __restrict__ cand,     // (T,M)
                                     const int* __restrict__ qrow,     // (T,C)
                                     const int* __restrict__ valid,    // (T,M)
                                     float* __restrict__ dist,         // (T,C,k)
                                     float* __restrict__ nbr,          // (T,C,k,3)
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
      if (d2 < td[k - 1]) {
        int j = k - 1;
        while (j > 0 && td[j - 1] > d2) {
          td[j] = td[j - 1];
          tm[j] = tm[j - 1];
          --j;
        }
        td[j] = d2;
        tm[j] = base + i;
      }
    }
  }
  if (!active) return;
  for (int j = 0; j < k; ++j) {
    const size_t o = qi * k + j;
    const size_t src = (size_t)tm[j] * 3;
    dist[o] = __fsqrt_rn(fmaxf(td[j], 0.f));
    nbr[o * 3] = pt[src];
    nbr[o * 3 + 1] = pt[src + 1];
    nbr[o * 3 + 2] = pt[src + 2];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes: q (T,C,3), p (T,M,3) float32; cand (T,M), qrow (T,C), valid (T,M)
// int32; outputs dist (T,C,k), nbr (T,C,k,3) float32; all contiguous.
// Requires 1 <= C <= 1024 and 1 <= k <= 128 (checked by the wrapper).
extern "C" int pct_select_coords(const float* q, const float* p, const int* cand,
                                 const int* qrow, const int* valid, float* dist,
                                 float* nbr, int T, int C, int M, int k,
                                 void* stream) {
  if (T <= 0) return 0;
  const int threads = ((C + 31) / 32) * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 64) {
    select_coords_kernel<64><<<T, threads, 0, s>>>(q, p, cand, qrow, valid, dist,
                                                   nbr, C, M, k);
  } else {
    select_coords_kernel<128><<<T, threads, 0, s>>>(q, p, cand, qrow, valid,
                                                    dist, nbr, C, M, k);
  }
  return static_cast<int>(cudaGetLastError());
}
