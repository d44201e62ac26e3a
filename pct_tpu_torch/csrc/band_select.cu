// Band k-nearest selection for row blocks of grid cells, for sm_90a (H100).
//
// Replaces the TPU kernel _band_kernel of pct_tpu/experimental/pallas_band.py
// (wrapper knn_band_select). A row block b holds bc cells of one grid (y,z)
// row, so the 27-cell windows of its cells are 9 contiguous bands of sorted
// rows: band j covers rows bs[b,j] .. bs[b,j]+band. For query slot s of the
// block (cell c = s / cap, qrow = qrow_base[b,c] + s % cap), over the
// concatenated positions i = j*band + p:
//   position p of band j is a candidate iff
//     rs_rel[b,c,j] <= p < rs_rel[b,c,j] + run_len[b,c,j]  and  bs[b,j]+p != qrow
//   d2 = ((dx*dx + dy*dy) + dz*dz),  d = q - plane[bs[b,j]+p]   (difference form)
//   emit the k smallest in ascending (d2, i) order: dist = sqrt(max(d2, 0)) and
//   row = bs[b, i/band] + i%band. Missing slots (fewer than k candidates) keep
//   (3e38, i = 0): distance sqrt(3e38) and row bs[b,0], which is what the
//   Pallas kernel's k rounds of min / first-argmin / mask-out give once every
//   position reads 3e38. Every query slot is computed, padding slots included.
//   cover = min(min(min(qx-lox, hix-qx), min(qy-loy, hiy-qy)), min(qz-loz, hiz-qz))
//   with the edges of the slot's cell.
//
// Bit-exactness: d2 uses __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract
// it into FMAs, and the distance is __fsqrt_rn; the plain PyTorch version in
// experimental/band_select.py does the same IEEE operations in the same order,
// so the two agree bit for bit on the card.
//
// What bounds it on the card: S = NB*bc*cap query slots must write k*8 bytes
// each (distance and row) plus a 4-byte cover, S*k*8 + S*4 bytes, and read
// the planes (12 B a row), the queries (12 B a slot) and the small per-cell
// tables once, against 3.35 TB/s; the pair work is one d2 (~9 float32
// operations) per (query slot, run position) against the 67 TFLOP/s FP32
// rate. On the 1M-point k=20 path the output bytes dominate: the bound is
// the bytes.
//
// What this simple design does about it, and what holds it back: one thread
// block per row block, one thread per query slot (blockDim = bc*cap rounded up
// to 32). The block stages its nine bands of x, y and z into dynamic shared
// memory, coalesced (9*band*12 bytes: 41,472 at band 384, 110,592 at 1024,
// above the 48 KB default, so the launch raises the block's limit), so each
// band row is read from device memory once per block, with no candidate
// gather. Each thread then scans only its own cell's nine runs, j ascending
// and p ascending, and keeps its k best (d2, i) pairs sorted in thread-local
// arrays; a candidate enters only when d2 is STRICTLY less than the current
// k-th, after any equal entries, which reproduces first-argmin tie order over
// the full 9*band window (positions outside the runs read 3e38 there and can
// never enter). The k-th distance is kept in a register, so a rejected
// candidate costs no list access. What holds it back: padding slots (cells
// with fewer points than cap, and whole padding cells) occupy threads and
// write outputs; staging reads whole bands where the block's runs cover less;
// and the list insertions shift entries in local memory, by different amounts
// across a warp, as in select_rows.cu.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float MISSING_D2 = 3.0e38f;
constexpr int NINE = 9;

// Up to 1024 threads a block (bc*cap query slots), so at most 64 registers a
// thread; the lists live in local memory either way.
template <int KM>
__global__ void __launch_bounds__(1024)
band_select_kernel(const float* __restrict__ px,
                   const float* __restrict__ py,
                   const float* __restrict__ pz,
                   const int* __restrict__ bs,          // (NB,9)
                   const int* __restrict__ rs_rel,      // (NB,bc,9)
                   const int* __restrict__ run_len,     // (NB,bc,9)
                   const float* __restrict__ qpts,      // (NB,Q,3)
                   const int* __restrict__ qrow_base,   // (NB,bc)
                   const float* __restrict__ lo_edge,   // (NB,bc,3)
                   const float* __restrict__ hi_edge,   // (NB,bc,3)
                   float* __restrict__ dist,            // (S,k)
                   int* __restrict__ rows,              // (S,k)
                   float* __restrict__ cover,           // (S,)
                   int npad, int k, int bc, int cap, int band) {
  extern __shared__ float planes[];  // x, y, z of the 9 bands, 9*band each
  __shared__ int sbs[NINE];
  const int m = NINE * band;
  float* sx = planes;
  float* sy = planes + m;
  float* sz = planes + 2 * m;
  const size_t b = blockIdx.x;
  const int q = bc * cap;

  if (threadIdx.x < NINE) sbs[threadIdx.x] = bs[b * NINE + threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int j = i / band;
    const long long g = static_cast<long long>(sbs[j]) + (i - j * band);
    const bool in = g >= 0 && g < npad;
    sx[i] = in ? px[g] : 0.f;
    sy[i] = in ? py[g] : 0.f;
    sz[i] = in ? pz[g] : 0.f;
  }
  __syncthreads();

  const int s = threadIdx.x;
  if (s >= q) return;
  const int c = s / cap;
  const size_t cell = b * bc + c;
  const size_t qi = b * q + s;
  const float qx = qpts[qi * 3];
  const float qy = qpts[qi * 3 + 1];
  const float qz = qpts[qi * 3 + 2];
  const int qrow = qrow_base[cell] + (s - c * cap);

  const float* lo = lo_edge + cell * 3;
  const float* hi = hi_edge + cell * 3;
  cover[qi] = fminf(fminf(fminf(__fsub_rn(qx, lo[0]), __fsub_rn(hi[0], qx)),
                          fminf(__fsub_rn(qy, lo[1]), __fsub_rn(hi[1], qy))),
                    fminf(__fsub_rn(qz, lo[2]), __fsub_rn(hi[2], qz)));

  float td[KM];
  int tm[KM];
  for (int j = 0; j < k; ++j) {
    td[j] = MISSING_D2;
    tm[j] = 0;
  }
  float worst = MISSING_D2;  // td[k - 1]
  const int* rr = rs_rel + cell * NINE;
  const int* rl = run_len + cell * NINE;
  for (int j = 0; j < NINE; ++j) {
    const int p0 = max(rr[j], 0);
    const int p1 = min(rr[j] + rl[j], band);
    const int base = sbs[j];
    for (int p = p0; p < p1; ++p) {
      if (base + p == qrow) continue;
      const int i = j * band + p;
      const float dx = __fsub_rn(qx, sx[i]);
      const float dy = __fsub_rn(qy, sy[i]);
      const float dz = __fsub_rn(qz, sz[i]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < worst) {
        int t = k - 1;
        while (t > 0 && td[t - 1] > d2) {
          td[t] = td[t - 1];
          tm[t] = tm[t - 1];
          --t;
        }
        td[t] = d2;
        tm[t] = i;
        worst = td[k - 1];
      }
    }
  }
  for (int j = 0; j < k; ++j) {
    const size_t o = qi * k + j;
    const int jj = tm[j] / band;
    dist[o] = __fsqrt_rn(fmaxf(td[j], 0.f));
    rows[o] = sbs[jj] + (tm[j] - jj * band);
  }
}

template <int KM>
int launch(const float* px, const float* py, const float* pz, const int* bs,
           const int* rs_rel, const int* run_len, const float* qpts,
           const int* qrow_base, const float* lo, const float* hi, float* dist,
           int* rows, float* cover, int nb, int npad, int k, int bc, int cap,
           int band, cudaStream_t s) {
  const int threads = ((bc * cap + 31) / 32) * 32;
  const size_t smem = sizeof(float) * 3 * NINE * static_cast<size_t>(band);
  cudaError_t err = cudaFuncSetAttribute(
      band_select_kernel<KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_select_kernel<KM><<<nb, threads, smem, s>>>(
      px, py, pz, bs, rs_rel, run_len, qpts, qrow_base, lo, hi, dist, rows,
      cover, npad, k, bc, cap, band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 = launched).
// Shapes: px/py/pz (npad,) float32; bs (nb,9), rs_rel/run_len (nb,bc,9),
// qrow_base (nb,bc) int32; qpts (nb,bc*cap,3), lo/hi (nb,bc,3) float32;
// outputs dist (S,k) float32, rows (S,k) int32, cover (S,) float32 with
// S = nb*bc*cap; all contiguous. Require 1 <= bc*cap <= 1024,
// 1 <= k <= 128 and 1 <= band <= 1024 (checked by the wrapper).
extern "C" int pct_band_select(const float* px, const float* py,
                               const float* pz, const int* bs,
                               const int* rs_rel, const int* run_len,
                               const float* qpts, const int* qrow_base,
                               const float* lo, const float* hi, float* dist,
                               int* rows, float* cover, int nb, int npad,
                               int k, int bc, int cap, int band,
                               void* stream) {
  if (nb <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 64) {
    return launch<64>(px, py, pz, bs, rs_rel, run_len, qpts, qrow_base, lo, hi,
                      dist, rows, cover, nb, npad, k, bc, cap, band, s);
  }
  return launch<128>(px, py, pz, bs, rs_rel, run_len, qpts, qrow_base, lo, hi,
                     dist, rows, cover, nb, npad, k, bc, cap, band, s);
}
