// The list engine's explicit fit, for sm_90a (H100): the coords select's
// winners (rows, k, 3) and the query points (rows, 3) -> (rows, 8) float32
// K, H, k1, k2, H^2, nx, ny, nz, the layout of epilogue.cu.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA
// (pct_tpu/pipeline/fused.py:57-60, _curvature_of_neighborhoods:
// tangent_frames -> fit_quadratic -> explicit_curvatures). The port ran it
// as ~545 eager PyTorch ops a chunk of 2^17 query slots, 13-14 chunks a
// 1M-point call.
//
// The chain, row by row (pct_tpu_torch/ops/list_fit.py::list_fit_plain is
// its plain version, operation for operation): the winners centred on the
// query (nbrs - q) -> their mean and covariance over k - 1 (np.cov) ->
// fit_row.cuh's smallest eigenvector (Frobenius scale, Cardano, cross-row
// vector, +z fallback) -> the sign fix on slot k-1 minus slot 0 -> the
// Rodrigues rotation to +z (identity where |n x z| < 1e-8) of every
// centred slot -> each tangent axis scaled by its largest extent -> the
// 6x6 normal equations of [a^2, b^2, ab, a, b, 1] against z, the relative
// ridge, the unrolled Cholesky with the dead-pivot rule -> the scale-back
// and the Monge curvatures. Every sum over the k slots runs from slot 0
// to slot k-1, one correctly rounded add at a time; every operation is an
// _rn intrinsic or libdevice's, so the plain version run on CUDA tensors
// gives the same bits.
//
// What bounds it on the card: 12k B of winners, 12 B of query and 32 B of
// output a row, ~0.121 ms for 1.43M rows at k=20 and 3.35 TB/s; ~90 FP32
// operations a slot (2 of them divisions) and ~500 more a row, none fused
// (~3.3 GFLOP a call at k=20, ~0.05 ms at 67 TFLOP/s). The design: one thread
// a row, every pass over the row's slots in registers of that thread, so the
// sums keep the plain version's order. Where a block's rows fit 48 KB of
// shared memory (k <= 127: 128, 64 or 32 rows a block), the block loads its
// rows' winners, one contiguous span, with coalesced 16-byte loads, centres
// them on their queries as it stores them, at an odd stride of 3k | 1 words,
// so that the row-per-thread reads meet no bank conflict, and rotates them in
// place for the fit's pass. Past that each thread streams its own row from
// device memory (through L1 and L2), centring it on every read and rotating
// it again for the fit's pass: the same operations, so the same bits. The
// variant follows from k alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fit_row.cuh"

namespace {

using namespace fit_row;

constexpr int NOUT = 8;
constexpr int MAX_ROWS = 128;            // rows (threads) a block
constexpr int SMEM_BYTES = 48 * 1024;    // dynamic shared memory, no opt-in
constexpr int NSUM = 26;                 // the fit's sums over the slots

// A row staged in shared memory: slot j's centred point at words 3j..3j+2,
// overwritten by its rotated point.
struct StagedRow {
  float* w;
  __device__ __forceinline__ void centred(int j, float* p) const {
    p[0] = w[3 * j]; p[1] = w[3 * j + 1]; p[2] = w[3 * j + 2];
  }
  __device__ __forceinline__ void keep(int j, const float* r) const {
    w[3 * j] = r[0]; w[3 * j + 1] = r[1]; w[3 * j + 2] = r[2];
  }
  __device__ __forceinline__ void rotated(int j, const float (*)[3],
                                          float* r) const {
    centred(j, r);
  }
};

// A row read from device memory on every pass.
struct StreamedRow {
  const float* w;
  float q[3];
  __device__ __forceinline__ void centred(int j, float* p) const {
    p[0] = sub(w[3 * j], q[0]);
    p[1] = sub(w[3 * j + 1], q[1]);
    p[2] = sub(w[3 * j + 2], q[2]);
  }
  __device__ __forceinline__ void keep(int, const float*) const {}
  __device__ __forceinline__ void rotated(int j, const float (*R)[3],
                                          float* r) const;
};

__device__ __forceinline__ void rotate(const float (*R)[3], const float* p,
                                       float* r) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = sum3(mul(R[i][0], p[0]), mul(R[i][1], p[1]), mul(R[i][2], p[2]));
}

__device__ __forceinline__ void StreamedRow::rotated(int j, const float (*R)[3],
                                                     float* r) const {
  float p[3];
  centred(j, p);
  rotate(R, p, r);
}

// One slot's terms of the fit's 26 sums, in list_fit_plain's order:
// cols = [a^2, b^2, ab, a, b]; cols_i cols_j (i <= j), cols_i, cols_i z, z.
__device__ __forceinline__ void gram_terms(const float* r, float sa, float sb,
                                           float* t) {
  const float a = dvd(r[0], sa), b = dvd(r[1], sb), z = r[2];
  const float cols[5] = {mul(a, a), mul(b, b), mul(a, b), a, b};
  int e = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = i; j < 5; ++j) t[e++] = mul(cols[i], cols[j]);
#pragma unroll
  for (int i = 0; i < 5; ++i) t[e++] = cols[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) t[e++] = mul(cols[i], z);
  t[e] = z;
}

// One row's k slots -> o = K, H, k1, k2, H^2, nx, ny, nz
template <class Row>
__device__ __forceinline__ void fit_row_k(const Row& row, int k, float* o) {
  float p[3], s[3];
  // the mean of the centred slots
  row.centred(0, s);
  for (int j = 1; j < k; ++j) {
    row.centred(j, p);
    s[0] = add(s[0], p[0]); s[1] = add(s[1], p[1]); s[2] = add(s[2], p[2]);
  }
  const float kf = static_cast<float>(k);
  const float mu[3] = {dvd(s[0], kf), dvd(s[1], kf), dvd(s[2], kf)};
  // the covariance: xx, xy, xz, yy, yz, zz over max(k - 1, 1)
  float cv[6];
  for (int j = 0; j < k; ++j) {
    row.centred(j, p);
    const float d[3] = {sub(p[0], mu[0]), sub(p[1], mu[1]), sub(p[2], mu[2])};
    const float t[6] = {mul(d[0], d[0]), mul(d[0], d[1]), mul(d[0], d[2]),
                        mul(d[1], d[1]), mul(d[1], d[2]), mul(d[2], d[2])};
#pragma unroll
    for (int i = 0; i < 6; ++i) cv[i] = j ? add(cv[i], t[i]) : t[i];
  }
  const float km1 = static_cast<float>(k > 1 ? k - 1 : 1);
#pragma unroll
  for (int i = 0; i < 6; ++i) cv[i] = dvd(cv[i], km1);
  float n[3];
  eigvec_min(cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], n);
  {
    float far[3], near[3];
    row.centred(k - 1, far);
    row.centred(0, near);
    sign_fix(n, far, near);
  }
  float R[3][3];
  rotation(n, R);
  // every slot rotated; each tangent axis's largest extent
  float ea = 0.0f, eb = 0.0f;
  for (int j = 0; j < k; ++j) {
    float r[3];
    row.centred(j, p);
    rotate(R, p, r);
    row.keep(j, r);
    const float xa = mul(r[0], r[0]), xb = mul(r[1], r[1]);
    ea = j ? maximum(ea, xa) : xa;
    eb = j ? maximum(eb, xb) : xb;
  }
  const float sa = sqr(clamp_min(ea, 1e-20f));
  const float sb = sqr(clamp_min(eb, 1e-20f));
  // the normal equations' sums
  float g[NSUM];
  for (int j = 0; j < k; ++j) {
    float r[3], t[NSUM];
    row.rotated(j, R, r);
    gram_terms(r, sa, sb, t);
#pragma unroll
    for (int i = 0; i < NSUM; ++i) g[i] = j ? add(g[i], t[i]) : t[i];
  }
  float G[6][6], rhs[6];
  int e = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = i; j < 5; ++j) G[i][j] = G[j][i] = g[e++];
#pragma unroll
  for (int i = 0; i < 5; ++i) G[i][5] = G[5][i] = g[e++];
  G[5][5] = kf;
#pragma unroll
  for (int i = 0; i < 6; ++i) rhs[i] = g[e++];
  float x[6];
  ridge_solve6(G, rhs, x);
  // the scale-back to the rotated frame's units
  const float A = mul(x[0], dvd(1.0f, mul(sa, sa)));
  const float B = mul(x[1], dvd(1.0f, mul(sb, sb)));
  const float C = mul(x[2], dvd(1.0f, mul(sa, sb)));
  const float D = mul(x[3], dvd(1.0f, sa));
  const float E = mul(x[4], dvd(1.0f, sb));
  monge(A, B, C, D, E, o);
  o[5] = n[0];
  o[6] = n[1];
  o[7] = n[2];
}

__device__ __forceinline__ void store(float* out, long long r, const float* o) {
  float4* dst = reinterpret_cast<float4*>(out + r * NOUT);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// ---- the kernel ----

template <bool STAGED>
__global__ void __launch_bounds__(MAX_ROWS)
list_fit_kernel(const float* __restrict__ nbrs,   // (rows, k, 3)
                const float* __restrict__ qpts,   // (rows, 3)
                float* __restrict__ out,          // (rows, 8)
                int rows, int k) {
  const int R = blockDim.x;
  const int tid = threadIdx.x;
  const int W = 3 * k;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  float o[NOUT];
  if constexpr (STAGED) {
    extern __shared__ float smem[];
    const int stride = W | 1;
    float* qs = smem;             // R x 3
    float* tile = smem + 3 * R;   // R x stride
    const int n = static_cast<int>(min(static_cast<long long>(R), rows - r0));
    for (int e = tid; e < 3 * n; e += R) qs[e] = qpts[3 * r0 + e];
    __syncthreads();
    const float* src = nbrs + r0 * W;
    const int total = n * W;
    auto put = [&](int e, float v) {
      const int r = e / W, col = e - r * W;
      tile[r * stride + col] = sub(v, qs[3 * r + col % 3]);
    };
    int e = tid;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int i = tid; i < total / 4; i += R) {
        const float4 v = src4[i];
        put(4 * i, v.x); put(4 * i + 1, v.y);
        put(4 * i + 2, v.z); put(4 * i + 3, v.w);
      }
      e = total / 4 * 4 + tid;
    }
    for (; e < total; e += R) put(e, src[e]);
    __syncthreads();
    if (tid >= n) return;
    fit_row_k(StagedRow{tile + tid * stride}, k, o);
    store(out, r0 + tid, o);
  } else {
    const long long r = r0 + tid;
    if (r >= rows) return;
    const StreamedRow row{nbrs + r * W,
                          {qpts[3 * r], qpts[3 * r + 1], qpts[3 * r + 2]}};
    fit_row_k(row, k, o);
    store(out, r, o);
  }
}

// Rows a block of the staged variant at this k, or 0 where a row streams.
int staged_rows(int k) {
  const int stride = (3 * k) | 1;
  for (int rows = MAX_ROWS; rows >= 32; rows /= 2)
    if (static_cast<long long>(rows) * (3 + stride) * 4 <= SMEM_BYTES)
      return rows;
  return 0;
}

}  // namespace

// The variant at k: rows a block, positive where the block stages its rows
// in shared memory, negative where each row streams from device memory.
extern "C" int pct_list_fit_layout(int k) {
  const int rows = staged_rows(k);
  return rows ? rows : -MAX_ROWS;
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// nbrs (rows, k, 3), qpts (rows, 3) and out (rows, 8) float32, contiguous,
// out 16-byte aligned (checked by the wrapper, which allocates it).
extern "C" int pct_list_fit(const float* nbrs, const float* qpts, float* out,
                            int rows, int k, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int staged = staged_rows(k);
  if (staged) {
    const int blocks = (rows + staged - 1) / staged;
    const size_t smem =
        static_cast<size_t>(staged) * (3 + ((3 * k) | 1)) * sizeof(float);
    list_fit_kernel<true><<<blocks, staged, smem, st>>>(nbrs, qpts, out, rows,
                                                        k);
  } else {
    const int blocks = (rows + MAX_ROWS - 1) / MAX_ROWS;
    list_fit_kernel<false><<<blocks, MAX_ROWS, 0, st>>>(nbrs, qpts, out, rows,
                                                        k);
  }
  return static_cast<int>(cudaGetLastError());
}
