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
// its _rn intrinsic, so nvcc contracts nothing into an FMA; clamps, maxima
// and selects pass NaN through as PyTorch's CUDA clamp_min, clamp and
// maximum do; acosf, cosf and powf are libdevice's, which PyTorch's CUDA
// arccos, cos and pow call. The plain version run on CUDA tensors then
// gives the same bits on every column (padding rows' NaNs included).
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

namespace {

constexpr int NIN = 48;
constexpr int NOUT = 8;
constexpr int ROWS = 128;          // rows (threads) a block
constexpr int STRIDE = NIN + 1;    // odd: conflict-free row reads

// ---- the row (the plain version's operations, one for one) ----

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqr(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, b), c);
}
// torch.clamp_min, torch.clamp and torch.maximum on CUDA: NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// The Python constants, each a double rounded once to float, as PyTorch
// rounds a Python number against a float32 tensor.
constexpr float EPS = static_cast<float>(1e-12);    // fit.eigh3._EPS
constexpr float TINY = static_cast<float>(1e-30);
constexpr float RIDGE = static_cast<float>(1e-7);   // fit.quadratic._RIDGE
constexpr float DEAD = static_cast<float>(1e-10);
constexpr float THIRD_TURN =
    static_cast<float>(2.0 * 3.14159265358979323846 / 3.0);

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

// c = u x v and |c|^2
__device__ __forceinline__ void cross(const float* u, const float* v, float* c,
                                      float& n2) {
  c[0] = sub(mul(u[1], v[2]), mul(u[2], v[1]));
  c[1] = sub(mul(u[2], v[0]), mul(u[0], v[2]));
  c[2] = sub(mul(u[0], v[1]), mul(u[1], v[0]));
  n2 = sum3(mul(c[0], c[0]), mul(c[1], c[1]), mul(c[2], c[2]));
}

// smallest_eigvec3 of the symmetric matrix (a00 a01 a02; . a11 a12; . . a22)
__device__ __forceinline__ void eigvec_min(float a00, float a01, float a02,
                                           float a11, float a12, float a22,
                                           float* n) {
  const float e0[9] = {a00, a01, a02, a01, a11, a12, a02, a12, a22};
  float acc = mul(e0[0], e0[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) acc = add(acc, mul(e0[i], e0[i]));
  const float s = clamp_min(sqr(acc), TINY);
  a00 = dvd(a00, s); a01 = dvd(a01, s); a02 = dvd(a02, s);
  a11 = dvd(a11, s); a12 = dvd(a12, s); a22 = dvd(a22, s);
  // eigvalsh3's smallest eigenvalue (Cardano)
  const float q = dvd(sum3(a00, a11, a22), 3.0f);
  const float b00 = sub(a00, q), b11 = sub(a11, q), b22 = sub(a22, q);
  const float e1[9] = {b00, a01, a02, a01, b11, a12, a02, a12, b22};
  acc = mul(e1[0], e1[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) acc = add(acc, mul(e1[i], e1[i]));
  const float p = sqr(clamp_min(dvd(acc, 6.0f), 0.0f));
  const float safe_p = clamp_min(p, EPS);
  const float det =
      add(sub(mul(b00, sub(mul(b11, b22), mul(a12, a12))),
              mul(a01, sub(mul(a01, b22), mul(a12, a02)))),
          mul(a02, sub(mul(a01, a12), mul(b11, a02))));
  const float r = clamp(dvd(det, mul(2.0f, mul(mul(safe_p, safe_p), safe_p))),
                        -1.0f, 1.0f);
  const float phi = dvd(acosf(r), 3.0f);
  const float lam = add(q, mul(mul(2.0f, p), cosf(add(phi, THIRD_TURN))));
  // the cross-row eigenvector of A - lam I
  const float r0[3] = {sub(a00, lam), a01, a02};
  const float r1[3] = {a01, sub(a11, lam), a12};
  const float r2[3] = {a02, a12, sub(a22, lam)};
  float c[3][3], nrm[3];
  cross(r0, r1, c[0], nrm[0]);
  cross(r0, r2, c[1], nrm[1]);
  cross(r1, r2, c[2], nrm[2]);
  const bool pick01 = (nrm[0] >= nrm[1]) && (nrm[0] >= nrm[2]);
  const bool pick02 = nrm[1] >= nrm[2];
  const float quality = maximum(maximum(nrm[0], nrm[1]), nrm[2]);
  const float norm = sqr(clamp_min(quality, EPS));
  const bool ok = quality > EPS;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float v = dvd(pick01 ? c[0][i] : (pick02 ? c[1][i] : c[2][i]), norm);
    n[i] = ok ? v : (i == 2 ? 1.0f : 0.0f);
  }
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
  const float dot = sum3(mul(n[0], sub(s[42], s[39])),
                         mul(n[1], sub(s[43], s[40])),
                         mul(n[2], sub(s[44], s[41])));
  if (dot < 0.0f) {
    n[0] = -n[0]; n[1] = -n[1]; n[2] = -n[2];
  }
  // rodrigues_to_z's rows
  const float vx = n[1], vy = -n[0];
  const float s2 = add(mul(vx, vx), mul(vy, vy));
  const float fac = dvd(sub(1.0f, n[2]), clamp_min(s2, 1e-20f));
  const bool small = sqr(clamp_min(s2, 0.0f)) < 1e-8f;
  const float r01 = mul(mul(vx, vy), fac);
  float R[3][3] = {{add(1.0f, mul(sub(mul(vx, vx), s2), fac)), r01, vy},
                   {r01, add(1.0f, mul(sub(mul(vy, vy), s2), fac)), -vx},
                   {-vy, vx, sub(1.0f, mul(s2, fac))}};
  if (small) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = i == j ? 1.0f : 0.0f;
  }
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
  float trace = G[0][0];
#pragma unroll
  for (int j = 1; j < 6; ++j) trace = add(trace, G[j][j]);
  const float ridge = dvd(mul(RIDGE, trace), 6.0f);
#pragma unroll
  for (int j = 0; j < 6; ++j) G[j][j] = add(G[j][j], ridge);
  float L[6][6], invd[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float t = G[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) t = sub(t, mul(L[j][k], L[j][k]));
    const bool dead = t < add(mul(DEAD, fabsf(G[j][j])), TINY);
    invd[j] = dead ? 0.0f : dvd(1.0f, sqr(clamp_min(t, TINY)));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float u = G[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) u = sub(u, mul(L[i][k], L[j][k]));
      L[i][j] = mul(u, invd[j]);
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t = sub(t, mul(L[i][k], y[k]));
    y[i] = mul(t, invd[i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t = sub(t, mul(L[k][i], x[k]));
    x[i] = mul(t, invd[i]);
  }
  const float sg = clamp_min(s[38], TINY);
  const float A = mul(x[0], dvd(mul(ia[1], ia[1]), sg));
  const float B = mul(x[1], dvd(mul(ib[1], ib[1]), sg));
  const float C = mul(x[2], dvd(mul(ia[1], ib[1]), sg));
  const float D = mul(x[3], ia[1]);
  const float E = mul(x[4], ib[1]);

  // explicit_curvatures
  const float fxx = mul(2.0f, A), fyy = mul(2.0f, B);
  const float fx2 = mul(D, D), fy2 = mul(E, E);
  const float w = add(add(1.0f, fx2), fy2);
  const float K = dvd(sub(mul(fxx, fyy), mul(C, C)), mul(w, w));
  const float num = add(sub(mul(add(1.0f, fx2), fyy), mul(mul(mul(2.0f, D), E), C)),
                        mul(add(1.0f, fy2), fxx));
  const float H = dvd(num, mul(2.0f, powf(w, 1.5f)));
  const float disc = sqr(clamp_min(sub(mul(H, H), K), 0.0f));
  o[0] = K;
  o[1] = H;
  o[2] = add(H, disc);
  o[3] = sub(H, disc);
  o[4] = mul(H, H);
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
