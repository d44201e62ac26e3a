// The explicit fit's per-row steps, shared by epilogue.cu (the moments
// route) and list_fit.cu (the list engine), for sm_90a (H100): the
// smallest eigenvector of a 3x3 covariance, the sign fix, the Rodrigues
// rotation to +z, the ridged 6x6 Cholesky solve and the Monge curvatures.
// Each is the same sequence of operations as its helper in
// pct_tpu_torch/ops/epilogue.py (_eigvec_min, _sign_fix, _rotation,
// _add_ridge + _solve, _curvatures), one for one.
//
// Bit-exactness: every add, subtract, multiply, divide and square root is
// its _rn intrinsic, so nvcc contracts nothing into an FMA; clamps, maxima
// and selects pass NaN through as PyTorch's CUDA clamp_min, clamp and
// maximum do; acosf, cosf and powf are libdevice's, which PyTorch's CUDA
// arccos, cos and pow call.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fit_row {

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

// The sign fix (the reference's pts[-1] - pts[0]): flip n where its dot
// with far - near is negative.
__device__ __forceinline__ void sign_fix(float* n, const float* far,
                                         const float* near) {
  const float dot = sum3(mul(n[0], sub(far[0], near[0])),
                         mul(n[1], sub(far[1], near[1])),
                         mul(n[2], sub(far[2], near[2])));
  if (dot < 0.0f) {
    n[0] = -n[0]; n[1] = -n[1]; n[2] = -n[2];
  }
}

// rodrigues_to_z's rows: R n = +z, the identity where |n x z| < 1e-8
// (also for n = -z)
__device__ __forceinline__ void rotation(const float* n, float R[3][3]) {
  const float vx = n[1], vy = -n[0];
  const float s2 = add(mul(vx, vx), mul(vy, vy));
  const float fac = dvd(sub(1.0f, n[2]), clamp_min(s2, 1e-20f));
  const bool small = sqr(clamp_min(s2, 0.0f)) < 1e-8f;
  const float r01 = mul(mul(vx, vy), fac);
  R[0][0] = add(1.0f, mul(sub(mul(vx, vx), s2), fac));
  R[0][1] = r01;
  R[0][2] = vy;
  R[1][0] = r01;
  R[1][1] = add(1.0f, mul(sub(mul(vy, vy), s2), fac));
  R[1][2] = -vx;
  R[2][0] = -vy;
  R[2][1] = vx;
  R[2][2] = sub(1.0f, mul(s2, fac));
  if (small) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = i == j ? 1.0f : 0.0f;
  }
}

// The relative ridge 1e-7 trace / 6 on G's diagonal, then the unrolled
// Cholesky with the dead-pivot rule (a pivot below 1e-10 |G_jj| + 1e-30
// gets an inverse of 0), forward and backward substitution: G x = rhs.
__device__ __forceinline__ void ridge_solve6(float G[6][6], const float* rhs,
                                             float* x) {
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
  float y[6];
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
}

// explicit_curvatures of z = A a^2 + B b^2 + C ab + D a + E b + F:
// o = K, H, k1, k2, H^2
__device__ __forceinline__ void monge(float A, float B, float C, float D,
                                      float E, float* o) {
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
}

}  // namespace fit_row
