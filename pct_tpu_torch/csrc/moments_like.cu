// A moments-shaped toy kernel: per-chunk products and their row
// statistics, for sm_90a (H100). It exists to time a cold first use
// (nvcc and the module load), as its TPU original timed a cold Mosaic
// compile; no entry point runs it.
//
// Replaces the TPU kernel scripts/repro_mosaic_cold.py::_kernel. For each
// tile t and each chunk j of 256 rows of y:
//   d = x[t] @ y[t, 256 j : 256 j + 256]^T          (C x 256, depth 256)
//   o[t] += [sum_n d, max_n d, sum_n d*d, max_n |d|], each over the 256
//           columns and broadcast over 32 lanes (columns 0-31, 32-63,
//           64-95, 96-127),
// from o = 0, chunk by chunk: the "max" columns hold the sum of the
// chunks' maxima. Shapes: x (T, C, 256), y (T, M, 256) with M a multiple
// of 256, o (T, C, 128), float32.
//
// Bit-exactness: each dot accumulates in k order with __fmul_rn /
// __fadd_rn (no FMA, no TF32), and each sum over the 256 columns is the
// halving tree the plain version writes out (column i + column i + h for
// h = 128, 64, ..., 1: three in registers, five through __shfl_down_sync),
// so the kernel and its plain version (micro/moments_like.py) agree bit
// for bit.
//
// What bounds it on the card: 2 T C M 256 flops against the 67 TFLOP/s
// of FP32 (the bytes, x + y + o once, take a fifth of that time). The
// design is a plain shared-memory-tiled SIMT product: a block takes 16
// rows of x of one tile and walks the chunks; per chunk it stages 32
// columns of the depth at a time (x: 16 x 32, y: 256 x 32, padded to 33
// against bank conflicts), each thread accumulates 4 x 4 outputs, the
// 16 x 256 product goes to shared memory, and each warp reduces two rows.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 256;     // columns of d a chunk, and the depth
constexpr int BM = 16;         // rows of x a block
constexpr int BK = 32;         // depth staged at a time
constexpr int PAD = BK + 1;
constexpr int THREADS = 256;
constexpr int NOUT = 128;

__global__ void __launch_bounds__(THREADS)
moments_like_kernel(const float* __restrict__ x,   // (T,C,256)
                    const float* __restrict__ y,   // (T,M,256)
                    float* __restrict__ out,       // (T,C,128)
                    int C, int M) {
  __shared__ float xs[BM * PAD];
  // y's staged columns (CHUNK x PAD), then the 16 x 256 product
  __shared__ float ys[CHUNK * PAD];
  float* dt = ys;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t t = blockIdx.y;
  const int r0 = blockIdx.x * BM;
  const float* xt = x + t * C * CHUNK;
  const float* yt = y + t * static_cast<size_t>(M) * CHUNK;
  const int tr = tid >> 6, tc = tid & 63;   // rows 4 tr.., columns tc + 64 j
  float total[4] = {0.f, 0.f, 0.f, 0.f};    // lane 0: this warp's row stats
  float total2[4] = {0.f, 0.f, 0.f, 0.f};   // and its second row's
  for (int j = 0; j < M / CHUNK; ++j) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int k0 = 0; k0 < CHUNK; k0 += BK) {
      __syncthreads();   // the last slice (or the last chunk's d) is read
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, c = i - r * BK;
        xs[r * PAD + c] = r0 + r < C ? xt[(size_t)(r0 + r) * CHUNK + k0 + c]
                                     : 0.f;
      }
      for (int i = tid; i < CHUNK * BK; i += THREADS) {
        const int n = i / BK, c = i - n * BK;
        ys[n * PAD + c] = yt[((size_t)j * CHUNK + n) * CHUNK + k0 + c];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = xs[(4 * tr + a) * PAD + kk];
#pragma unroll
        for (int b = 0; b < 4; ++b) bv[b] = ys[(tc + 64 * b) * PAD + kk];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(av[a], bv[b]));
      }
    }
    __syncthreads();     // ys is read: it becomes the product tile
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        dt[(4 * tr + a) * CHUNK + tc + 64 * b] = acc[a][b];
    __syncthreads();
    // warp w reduces rows 2w and 2w + 1; lane l holds columns l + 32 i
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* d = dt + (2 * warp + h) * CHUNK;
      float v[8], sq[8], mx = __uint_as_float(0xff800000u), ma = 0.f;  // -inf
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = d[lane + 32 * i];
        sq[i] = __fmul_rn(v[i], v[i]);
        mx = fmaxf(mx, v[i]);
        ma = fmaxf(ma, fabsf(v[i]));
      }
      // halving tree: h = 128, 64, 32 in registers
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = __fadd_rn(v[i], v[i + 4]);
        sq[i] = __fadd_rn(sq[i], sq[i + 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        v[i] = __fadd_rn(v[i], v[i + 2]);
        sq[i] = __fadd_rn(sq[i], sq[i + 2]);
      }
      float s = __fadd_rn(v[0], v[1]), s2 = __fadd_rn(sq[0], sq[1]);
      // h = 16, 8, 4, 2, 1 across lanes
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s = __fadd_rn(s, __shfl_down_sync(FULL, s, off));
        s2 = __fadd_rn(s2, __shfl_down_sync(FULL, s2, off));
        mx = fmaxf(mx, __shfl_down_sync(FULL, mx, off));
        ma = fmaxf(ma, __shfl_down_sync(FULL, ma, off));
      }
      float* tot = h == 0 ? total : total2;
      tot[0] = __fadd_rn(tot[0], s);
      tot[1] = __fadd_rn(tot[1], mx);
      tot[2] = __fadd_rn(tot[2], s2);
      tot[3] = __fadd_rn(tot[3], ma);
    }
  }
  // each row's 4 stats (lane 0's), broadcast over 32 lanes each
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 2 * warp + h;
    const float* tot = h == 0 ? total : total2;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float v = __shfl_sync(FULL, tot[s], 0);
      if (r < C) out[(t * C + r) * NOUT + 32 * s + lane] = v;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes: x (T,C,256), y (T,M,256), out (T,C,128) float32, contiguous;
// M a multiple of 256 (checked by the wrapper).
extern "C" int pct_moments_like(const float* x, const float* y, float* out,
                                int T, int C, int M, void* stream) {
  if (T <= 0 || C <= 0) return 0;
  if (M <= 0 || M % CHUNK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + BM - 1) / BM, T);
  moments_like_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, C, M);
  return static_cast<int>(cudaGetLastError());
}
