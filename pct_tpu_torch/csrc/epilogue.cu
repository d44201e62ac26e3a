// The moments route's epilogue, for sm_90a (H100): (rows, 48) moment stats
// -> (rows, 8) float32 K, H, k1, k2, H^2, nx, ny, nz.
//
// Replaces no TPU kernel: the JAX package runs this chain
// (pct_tpu/fit/moments.py::curvature_from_moments_chunked) as XLA ops. The
// port ran it as ~600 eager PyTorch ops a 2^18-row chunk, six chunks a
// 1M-point call.
//
// The chain, row by row (pct_tpu_torch/ops/epilogue.py::epilogue_plain is
// its plain version, operation for operation): covariance from the degree
// <= 2 moments -> Frobenius pre-scale -> Cardano's smallest eigenvalue ->
// the cross-row eigenvector (+z where its quality is <= 1e-12) -> the sign
// fix on kth - nearest -> the Rodrigues rotation taking the normal to +z
// (identity where |n x z| < 1e-8) -> the 21 rotated moments the fit reads,
// each contracted from the symmetric raw moments one rotation row at a time
// (no 81-entry M4) -> RMS preconditioning, the relative ridge 1e-7 and the
// unrolled 6x6 Cholesky with the dead-pivot rule -> the Monge curvatures.
//
// Bit-exactness: every add, subtract, multiply, divide and square root is
// its _rn intrinsic (the eigenvector, sign fix, rotation, solve and
// curvature steps are fit_row.cuh's, shared with list_fit.cu); the plain
// version run on CUDA tensors then gives the same bits on every column
// (padding rows' NaNs included).
//
// What bounds it on the card: 192 B read and 32 B written a row (~0.09 ms
// for 1.4M rows at 3.35 TB/s); ~1,500 FP32 operations a row, none fused
// (~2 GFLOP a call, ~0.03 ms at 67 TFLOP/s). The design: one thread a row;
// a block stages its 128 rows through shared memory with consecutive
// threads on consecutive words (a row is 192 B, so loading rows a thread
// each would split every warp's loads), at a stride of 49 words, so that
// the row-per-thread reads meet no bank conflict.

#include <cuda_runtime.h>
#include <math.h>

#include "fit_row.cuh"

namespace {

using namespace fit_row;

constexpr int NIN = 48;
constexpr int NOUT = 8;
constexpr int ROWS = 128;          // rows (threads) a block
constexpr int STRIDE = NIN + 1;    // odd: conflict-free row reads

// Position of exponent (a, b, d - a - b) among the degree-d moments, in
// fit.moments.MOMENT_EXPS order (a descending, then b descending).
__host__ __device__ constexpr int pos(int d, int a, int b) {
  return (d - a) * (d - a + 1) / 2 + (d - a - b);
}

// One rotation row r into a symmetric degree-D tensor T (its (D+1)(D+2)/2
// distinct entries): out[beta] = ((r0 T[beta+x] + r1 T[beta+y]) + r2 T[beta+z])
// over the degree D-1 exponents beta.
template <int D>
__device__ __forceinline__ void contract(const float* T, const float* r,
                                         float* out) {
#pragma unroll
  for (int a = D - 1; a >= 0; --a) {
#pragma unroll
    for (int b = D - 1 - a; b >= 0; --b) {
      out[pos(D - 1, a, b)] = sum3(mul(r[0], T[pos(D, a + 1, b)]),
                                   mul(r[1], T[pos(D, a, b + 1)]),
                                   mul(r[2], T[pos(D, a, b)]));
    }
  }
}

__device__ __forceinline__ float dot1(const float* T, const float* r) {
  float out;
  contract<1>(T, r, &out);
  return out;
}

// stats row s (moments at [0, 35), sigma [38], nearest [39, 42), kth
// [42, 45)) -> o = K, H, k1, k2, H^2, nx, ny, nz
__device__ __forceinline__ void epilogue_row(const float* s, float* o) {
  const float* m = s;
  // covariance_from_moments (sigma^2 dropped: eigenvectors are scale-free)
  const float cnt = clamp_min(m[0], 1.0f);
  const float mu[3] = {dvd(m[1], cnt), dvd(m[2], cnt), dvd(m[3], cnt)};
  const float f = dvd(1.0f, clamp_min(sub(cnt, 1.0f), 1.0f));
  auto cov = [&](int e, int i, int j) {
    return mul(sub(m[e], mul(mul(cnt, mu[i]), mu[j])), f);
  };
  float n[3];
  eigvec_min(cov(4, 0, 0), cov(5, 0, 1), cov(6, 0, 2), cov(7, 1, 1),
             cov(8, 1, 2), cov(9, 2, 2), n);
  // the sign fix on kth - nearest (the reference's pts[-1] - pts[0])
  sign_fix(n, s + 42, s + 39);
  float R[3][3];
  rotation(n, R);
  const float *Rx = R[0], *Ry = R[1], *Rz = R[2];

  // The 21 rotated moments, by MOMENT_EXPS index: target (a, b, c) takes
  // c z rows, then b y rows, then a x rows; shared prefixes are shared.
  float S[35];
  S[0] = m[0];
  S[pos(1, 1, 0) + 1] = dot1(m + 1, Rx);
  S[pos(1, 0, 1) + 1] = dot1(m + 1, Ry);
  S[pos(1, 0, 0) + 1] = dot1(m + 1, Rz);
  {
    float Az[3], Ay[3], Ax[3];
    contract<2>(m + 4, Rz, Az);
    contract<2>(m + 4, Ry, Ay);
    contract<2>(m + 4, Rx, Ax);
    S[4 + pos(2, 0, 1)] = dot1(Az, Ry);    // (0,1,1)
    S[4 + pos(2, 1, 0)] = dot1(Az, Rx);    // (1,0,1)
    S[4 + pos(2, 0, 2)] = dot1(Ay, Ry);    // (0,2,0)
    S[4 + pos(2, 1, 1)] = dot1(Ay, Rx);    // (1,1,0)
    S[4 + pos(2, 2, 0)] = dot1(Ax, Rx);    // (2,0,0)
  }
  {
    float Az[6], Ay[6], Ax[6], Bzy[3], Bzx[3], Byy[3], Byx[3], Bxx[3];
    contract<3>(m + 10, Rz, Az);
    contract<3>(m + 10, Ry, Ay);
    contract<3>(m + 10, Rx, Ax);
    contract<2>(Az, Ry, Bzy);
    contract<2>(Az, Rx, Bzx);
    contract<2>(Ay, Ry, Byy);
    contract<2>(Ay, Rx, Byx);
    contract<2>(Ax, Rx, Bxx);
    S[10 + pos(3, 0, 2)] = dot1(Bzy, Ry);  // (0,2,1)
    S[10 + pos(3, 1, 1)] = dot1(Bzy, Rx);  // (1,1,1)
    S[10 + pos(3, 2, 0)] = dot1(Bzx, Rx);  // (2,0,1)
    S[10 + pos(3, 0, 3)] = dot1(Byy, Ry);  // (0,3,0)
    S[10 + pos(3, 1, 2)] = dot1(Byy, Rx);  // (1,2,0)
    S[10 + pos(3, 2, 1)] = dot1(Byx, Rx);  // (2,1,0)
    S[10 + pos(3, 3, 0)] = dot1(Bxx, Rx);  // (3,0,0)
  }
  {
    float Ay[10], Ax[10], Byy[6], Byx[6], Bxx[6];
    float Cyyy[3], Cyyx[3], Cyxx[3], Cxxx[3];
    contract<4>(m + 20, Ry, Ay);
    contract<4>(m + 20, Rx, Ax);
    contract<3>(Ay, Ry, Byy);
    contract<3>(Ay, Rx, Byx);
    contract<3>(Ax, Rx, Bxx);
    contract<2>(Byy, Ry, Cyyy);
    contract<2>(Byy, Rx, Cyyx);
    contract<2>(Byx, Rx, Cyxx);
    contract<2>(Bxx, Rx, Cxxx);
    S[20 + pos(4, 0, 4)] = dot1(Cyyy, Ry);  // (0,4,0)
    S[20 + pos(4, 1, 3)] = dot1(Cyyy, Rx);  // (1,3,0)
    S[20 + pos(4, 2, 2)] = dot1(Cyyx, Rx);  // (2,2,0)
    S[20 + pos(4, 3, 1)] = dot1(Cyxx, Rx);  // (3,1,0)
    S[20 + pos(4, 4, 0)] = dot1(Cxxx, Rx);  // (4,0,0)
  }

  // fit_quadratic_from_moments: RMS preconditioning, relative ridge,
  // unrolled Cholesky with the dead-pivot rule
  const float sa = sqr(clamp_min(dvd(S[4 + pos(2, 2, 0)], cnt), 1e-20f));
  const float sb = sqr(clamp_min(dvd(S[4 + pos(2, 0, 2)], cnt), 1e-20f));
  float ia[5], ib[5];
  ia[0] = ib[0] = 1.0f;   // not read
  ia[1] = dvd(1.0f, sa);
  ib[1] = dvd(1.0f, sb);
#pragma unroll
  for (int p = 2; p < 5; ++p) {
    ia[p] = mul(ia[p - 1], ia[1]);
    ib[p] = mul(ib[p - 1], ib[1]);
  }
  auto scaled = [&](int a, int b, int c) {
    const int d = a + b + c;
    float v = S[d * (d + 1) * (d + 2) / 6 + pos(d, a, b)];
    if (a) v = mul(v, ia[a]);
    if (b) v = mul(v, ib[b]);
    return v;
  };
  constexpr int PA[6] = {2, 0, 1, 1, 0, 0};   // [a^2, b^2, ab, a, b, 1]
  constexpr int PB[6] = {0, 2, 1, 0, 1, 0};
  float G[6][6], rhs[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j)
      G[i][j] = G[j][i] = scaled(PA[i] + PA[j], PB[i] + PB[j], 0);
    rhs[i] = scaled(PA[i], PB[i], 1);
  }
  float x[6];
  ridge_solve6(G, rhs, x);
  const float sg = clamp_min(s[38], TINY);
  const float A = mul(x[0], dvd(mul(ia[1], ia[1]), sg));
  const float B = mul(x[1], dvd(mul(ib[1], ib[1]), sg));
  const float C = mul(x[2], dvd(mul(ia[1], ib[1]), sg));
  const float D = mul(x[3], ia[1]);
  const float E = mul(x[4], ib[1]);

  // explicit_curvatures
  monge(A, B, C, D, E, o);
  o[5] = n[0];
  o[6] = n[1];
  o[7] = n[2];
}

// ---- the kernel ----

__global__ void __launch_bounds__(ROWS)
epilogue_kernel(const float* __restrict__ stats,   // (rows, 48)
                float* __restrict__ out,           // (rows, 8)
                int rows) {
  __shared__ float tile[ROWS * STRIDE];
  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int n = static_cast<int>(min(static_cast<long long>(ROWS), rows - r0));
  const float* src = stats + r0 * NIN;
  for (int e = threadIdx.x; e < n * NIN; e += ROWS)
    tile[(e / NIN) * STRIDE + e % NIN] = src[e];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= n) return;
  float o[NOUT];
  epilogue_row(tile + threadIdx.x * STRIDE, o);
  float4* dst = reinterpret_cast<float4*>(out + (r0 + threadIdx.x) * NOUT);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// stats (rows, 48) and out (rows, 8) float32, contiguous, out 16-byte
// aligned (checked by the wrapper, which allocates it).
extern "C" int pct_moments_epilogue(const float* stats, float* out, int rows,
                                    void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + ROWS - 1) / ROWS;
  epilogue_kernel<<<blocks, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      stats, out, rows);
  return static_cast<int>(cudaGetLastError());
}
