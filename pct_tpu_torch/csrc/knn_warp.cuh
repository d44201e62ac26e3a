// Warp-per-query k-nearest machinery shared by select_rows.cu,
// select_coords.cu, band_select.cu, moments.cu (with moments_warp.cuh)
// and the script kernels moments_split.cu and select_mxu.cu, for sm_90a
// (H100).
//
// Layout. One thread block per cell row t, W = min(MAX_WARPS, C) warps;
// warp w serves the row's query slots c = w, w + W, ... in turn. Each warp
// owns a scratch area whose size is a class chosen by k (scratch_bytes):
// SCRATCH = 1 KB for k <= 128, else 8 * P bytes, P the next power of two
// >= k (2 / 4 / 8 KB up to k = 256 / 512 / 1024): the radix histogram
// (256 words) and the sort's P keys of 8 bytes share it. Where the row
// fits the class's shared-memory budget (CACHE_BUDGET for the 1 KB class,
// M up to ~1,800 slots at 8 warps; WIDE_BUDGET, the card's most a block,
// for the others: M up to ~4,100 at 8 warps and k <= 256) the block stages
// its candidates once (x, y, z, id, valid: 20 B a slot, coalesced) and
// each warp computes every d2 of its query exactly once into a per-warp
// slice of M uint32 bits; each later pass reads the bits back. Past the
// budget the same code runs on a streamed source that recomputes d2 from
// device memory in every pass: correct and slower.
//
// d2 is the difference form ((dx*dx + dy*dy) + dz*dz) with the _rn
// intrinsics, so nvcc cannot contract it into FMAs; non-negative float32
// values order as their uint32 bits do, so every select below runs on
// the bits.
//
// kth smallest: a radix select over the bits, four 8-bit digit passes
// from the top, each a per-warp 256-bin shared histogram (one shared
// atomicAdd a slot whose bits match the digits found so far) and a warp
// prefix scan that finds the digit holding the kth value. It returns the
// value and, exactly, how many values lie below it and how many equal it.
// (Combining equal digits first with __match_any_sync was measured
// slower on the H100.)
//
// k smallest in order (the selects): every slot below the kth value tau,
// then the first k - below slots equal to tau, compacted in candidate
// order (ballot + popc prefix sums) as keys (d2 bits << 32 | position),
// which is exactly the set of the k smallest (d2, position) pairs; the
// <= k keys are unique (their positions are) and a bitonic network over
// P = the next power of two in the warp's scratch sorts them into the
// order the Pallas kernels' rounds of min and first-argmin emit.
// select_kernel runs that over one cell row per block with an emitter for
// the outputs (ids, positions or coordinates).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace knn_warp {

constexpr unsigned FULL = 0xffffffffu;
constexpr float SENT = 3.0e38f;          // d2 of an unusable slot
constexpr int MAX_WARPS = 8;
constexpr int SCRATCH = 1024;            // per-warp scratch bytes, k <= 128
constexpr size_t CACHE_BUDGET = 100 * 1024;  // dynamic shared bytes, 1 KB
constexpr size_t WIDE_BUDGET = 227 * 1024;   // the larger classes: sm_90's
                                             // most a block

// Bytes of per-warp scratch for a select of k winners (1 <= k <= 1024):
// SCRATCH up to k = 128, else 8 bytes a key for the next power of two >= k.
__host__ __device__ constexpr int scratch_bytes(int k) {
  int P = 256;
  while (P < k) P <<= 1;
  return k <= 128 ? SCRATCH : 8 * P;
}

__device__ __forceinline__ unsigned sent_bits() { return __float_as_uint(SENT); }

__device__ __forceinline__ unsigned d2_bits(float qx, float qy, float qz,
                                            float px, float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __float_as_uint(__fadd_rn(
      __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

// The M candidate slots of one cell row, staged in shared memory (SoA,
// pitch mp) ...
struct StagedRow {
  const float* xyz;
  const int* cand;
  const int* valid;
  int mp;
  __device__ float x(int m) const { return xyz[m]; }
  __device__ float y(int m) const { return xyz[mp + m]; }
  __device__ float z(int m) const { return xyz[2 * mp + m]; }
  __device__ int id(int m) const { return cand[m]; }
  __device__ int ok(int m) const { return valid[m]; }
};

// ... or read from device memory: p (M,3), cand (M,), valid (M,).
struct GlobalRow {
  const float* p;
  const int* cand;
  const int* valid;
  __device__ float x(int m) const { return __ldg(p + 3 * (size_t)m); }
  __device__ float y(int m) const { return __ldg(p + 3 * (size_t)m + 1); }
  __device__ float z(int m) const { return __ldg(p + 3 * (size_t)m + 2); }
  __device__ int id(int m) const { return __ldg(cand + m); }
  __device__ int ok(int m) const { return __ldg(valid + m); }
};

// Bits of slot m for one query: Rule::bits(valid, cand, qrow, d2 bits)
// masks the unusable slots to sent_bits().
template <class Rule, class Row>
struct RowBits {
  Row row;
  float qx, qy, qz;
  int qr;
  __device__ unsigned operator()(int m) const {
    return Rule::bits(row.ok(m), row.id(m), qr,
                      d2_bits(qx, qy, qz, row.x(m), row.y(m), row.z(m)));
  }
};

struct CachedBits {
  const unsigned* b;
  __device__ unsigned operator()(int m) const { return b[m]; }
};

// Per-block shared memory: W scratch areas of `scr` bytes, then (cached)
// W bit slices of mp words and the staged row.
__host__ __device__ inline int pitch(int M) { return (M + 3) & ~3; }

inline size_t smem_bytes(int W, int M, bool cached, int scr = SCRATCH) {
  const size_t mp = static_cast<size_t>(pitch(M));
  return static_cast<size_t>(W) * scr +
         (cached ? static_cast<size_t>(W) * mp * 4 + mp * 20 : 0);
}

inline bool use_cache(int W, int M, int scr = SCRATCH,
                      size_t budget = CACHE_BUDGET) {
  return M <= (1 << 20) && smem_bytes(W, M, true, scr) <= budget;
}

// The shared-memory budget of a scratch class: CACHE_BUDGET for the 1 KB
// class (k <= 128), the card's most a block for the others.
constexpr size_t class_budget(int scr) {
  return scr == SCRATCH ? CACHE_BUDGET : WIDE_BUDGET;
}

struct Block {
  unsigned char* scratch;   // this warp's scratch bytes
  unsigned* bits;           // this warp's bit slice (cached)
  StagedRow row;            // the staged row (cached)
};

// Carve the block's shared memory; with `cached`, stage row t's slots
// (all threads, coalesced) and synchronize the block.
__device__ inline Block carve(unsigned char* smem, bool cached, int W,
                              int warp, const float* pt, const int* ct,
                              const int* vt, int M, int scr = SCRATCH) {
  Block b;
  b.scratch = smem + warp * scr;
  b.bits = nullptr;
  b.row = StagedRow{nullptr, nullptr, nullptr, 0};
  if (!cached) return b;
  const int mp = pitch(M);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + W * scr);
  float* xyz = reinterpret_cast<float*>(bits + W * mp);
  int* cand = reinterpret_cast<int*>(xyz + 3 * mp);
  int* valid = cand + mp;
  for (int i = threadIdx.x; i < 3 * M; i += blockDim.x) {
    const int m = i / 3;
    xyz[(i - 3 * m) * mp + m] = pt[i];
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    cand[i] = ct[i];
    valid[i] = vt[i];
  }
  __syncthreads();
  b.bits = bits + warp * mp;
  b.row = StagedRow{xyz, cand, valid, mp};
  return b;
}

// Fill this warp's bit slice for one query (cached layout).
template <class Rule>
__device__ inline void fill_bits(unsigned* bits, const StagedRow& row,
                                 float qx, float qy, float qz, int qr, int M,
                                 int lane) {
  const RowBits<Rule, StagedRow> src{row, qx, qy, qz, qr};
  for (int m = lane; m < M; m += 32) bits[m] = src(m);
  __syncwarp();
}

// The kk-th smallest (1 <= kk <= M) of src(m) over m < M, every lane of
// the warp together; *below gets how many values are strictly smaller,
// *equal how many equal it. `hist` is 256 words of the warp's scratch.
template <class Src>
__device__ unsigned radix_kth(const Src& src, int M, int kk, unsigned* hist,
                              int lane, int* below, int* equal) {
  unsigned prefix = 0, known = 0;
  int under = 0;
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) hist[j * 32 + lane] = 0;  // bin 8*lane + j
    __syncwarp();
    for (int m = lane; m < M; m += 32) {
      const unsigned v = src(m);
      if ((v & known) == prefix) {
        const unsigned d = (v >> shift) & 255u;
        atomicAdd(&hist[((d & 7u) << 5) | (d >> 3)], 1u);
      }
    }
    __syncwarp();
    unsigned c[8], own = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[j * 32 + lane];
      own += c[j];
    }
    unsigned incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned excl = incl - own;
    const unsigned want = static_cast<unsigned>(kk);
    const bool here = excl < want && want <= incl;
    int dj = 0;
    unsigned lower = excl, acc = excl, in_bin = 0;
    bool seen = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!seen && acc + c[j] >= want) {
        seen = true;
        dj = j;
        lower = acc;
        in_bin = c[j];
      }
      acc += c[j];
    }
    const int from = __ffs(__ballot_sync(FULL, here)) - 1;
    const unsigned digit =
        static_cast<unsigned>(8 * from + __shfl_sync(FULL, dj, from));
    const int lo = static_cast<int>(__shfl_sync(FULL, lower, from));
    *equal = static_cast<int>(__shfl_sync(FULL, in_bin, from));
    prefix |= digit << shift;
    known |= 255u << shift;
    kk -= lo;
    under += lo;
  }
  __syncwarp();
  *below = under;
  return prefix;
}

// select: usable when valid != 0, not the query itself and below the
// sentinel (nothing at or above it is ever selected)
struct SelectRule {
  __device__ static unsigned bits(int valid, int cand, int qr, unsigned b) {
    return (valid != 0 && cand != qr && b < sent_bits()) ? b : sent_bits();
  }
};

// Sort keys[0, n) ascending in place (bitonic network over the next power
// of two, padded with ~0), every lane of the warp together.
__device__ inline void warp_sort(unsigned long long* keys, int n, int lane) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = n + lane; i < P; i += 32) keys[i] = ~0ull;
  __syncwarp();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (P >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncwarp();
    }
  }
}

// How many of the kk smallest are found: the slots below tau, and the
// rest at tau unless tau is the sentinel (those slots are missing).
__device__ __forceinline__ int found_count(unsigned tau, int below, int kk) {
  return below + (tau < sent_bits() ? kk - below : 0);
}

// One group of 32 candidates of the compaction, one a lane, in candidate
// order: v its bits (~0u past the end), pos the key's low word. Appends
// the lanes taken to keys[base, ...) and advances base and eq_left (the
// slots at tau still to take).
__device__ __forceinline__ void compact_group(unsigned v, unsigned pos,
                                              unsigned tau, int lane,
                                              unsigned long long* keys,
                                              int& base, int& eq_left) {
  const unsigned lt_mask = (1u << lane) - 1u;   // lanes below this one
  const unsigned eq = __ballot_sync(FULL, v == tau);
  const bool take = v < tau || (v == tau && __popc(eq & lt_mask) < eq_left);
  const unsigned took = __ballot_sync(FULL, take);
  if (take)
    keys[base + __popc(took & lt_mask)] =
        (static_cast<unsigned long long>(v) << 32) | pos;
  base += __popc(took);
  eq_left -= min(__popc(eq), eq_left);
}

// The winners of one query over src(m), m < M (M >= 1): sorts the keys
// (bits << 32 | m) of the min(k, M) smallest into the warp's scratch and
// returns how many were found.
template <class Src>
__device__ int select_sorted(const Src& src, int M, int k,
                             unsigned char* scratch, int lane) {
  const int kk = min(k, M);
  int below, equal;
  const unsigned tau = radix_kth(src, M, kk, reinterpret_cast<unsigned*>(
                                     scratch), lane, &below, &equal);
  const int n = found_count(tau, below, kk);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(scratch);
  int base = 0, eq_left = n - below;
  const int groups = (M + 31) >> 5;
  for (int g = 0; g < groups && base < n; ++g) {
    const int m = (g << 5) + lane;
    compact_group(m < M ? src(m) : ~0u, static_cast<unsigned>(m), tau, lane,
                  keys, base, eq_left);
  }
  __syncwarp();
  warp_sort(keys, n, lane);
  return n;
}

__device__ __forceinline__ float key_dist(unsigned long long key) {
  return __fsqrt_rn(
      fmaxf(__uint_as_float(static_cast<unsigned>(key >> 32)), 0.f));
}

__device__ __forceinline__ int key_pos(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffu);
}

// One block per cell row t, warps over its query slots: each query's n
// sorted winner keys go to out.write(row, keys, n, query index, k, lane),
// which writes its k outputs (missing ones past n). SCR is the scratch
// class of k (scratch_bytes).
template <class Out, bool CACHED, int SCR>
__global__ void __launch_bounds__(MAX_WARPS * 32)
select_kernel(const float* __restrict__ q,      // (T,C,3)
              const float* __restrict__ p,      // (T,M,3)
              const int* __restrict__ cand,     // (T,M)
              const int* __restrict__ qrow,     // (T,C)
              const int* __restrict__ valid,    // (T,M)
              Out out, int C, int M, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t t = blockIdx.x;
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const float* pt = p + t * M * 3;
  const int* ct = cand + t * M;
  const int* vt = valid + t * M;
  const Block b = carve(smem, CACHED, W, warp, pt, ct, vt, M, SCR);
  const unsigned long long* keys =
      reinterpret_cast<const unsigned long long*>(b.scratch);
  for (int c = warp; c < C; c += W) {
    const size_t qi = t * C + c;
    const float qx = q[qi * 3], qy = q[qi * 3 + 1], qz = q[qi * 3 + 2];
    const int qr = qrow[qi];
    if constexpr (CACHED) {
      fill_bits<SelectRule>(b.bits, b.row, qx, qy, qz, qr, M, lane);
      const int n = select_sorted(CachedBits{b.bits}, M, k, b.scratch, lane);
      out.write(b.row, keys, n, qi, k, lane);
    } else {
      const GlobalRow row{pt, ct, vt};
      const int n = select_sorted(
          RowBits<SelectRule, GlobalRow>{row, qx, qy, qz, qr}, M, k,
          b.scratch, lane);
      out.write(row, keys, n, qi, k, lane);
    }
    __syncwarp();
  }
}

// Shared bytes of a select_kernel launch at (C, M, k): positive where the
// row is staged (cached), negative (minus the scratch bytes) where it is
// streamed.
inline long long select_layout(int C, int M, int k) {
  const int W = min(MAX_WARPS, C), scr = scratch_bytes(k);
  return use_cache(W, M, scr, class_budget(scr))
             ? static_cast<long long>(smem_bytes(W, M, true, scr))
             : -static_cast<long long>(smem_bytes(W, M, false, scr));
}

// Raise a kernel's dynamic shared-memory limit to `most` bytes, once (a
// launch above 48 KB needs it); returns the CUDA error (0 = set).
template <class Kernel>
int raise_smem(Kernel kernel, size_t most, bool& raised) {
  if (raised || most <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(most));
  if (e != cudaSuccess) return static_cast<int>(e);
  raised = true;
  return 0;
}

// select_kernel of one scratch class: the row staged where it fits the
// class's budget, else streamed.
template <class Out, int SCR>
int launch_class(const float* q, const float* p, const int* cand,
                 const int* qrow, const int* valid, Out out, int T, int C,
                 int M, int k, cudaStream_t s) {
  const int W = min(MAX_WARPS, C);
  if (use_cache(W, M, SCR, class_budget(SCR))) {
    static bool raised = false;   // above 48 KB needs the attribute
    const int e = raise_smem(select_kernel<Out, true, SCR>,
                             class_budget(SCR), raised);
    if (e) return e;
    select_kernel<Out, true, SCR><<<T, W * 32, smem_bytes(W, M, true, SCR),
                                    s>>>(q, p, cand, qrow, valid, out, C, M,
                                         k);
  } else {
    static bool raised = false;
    const int e = raise_smem(select_kernel<Out, false, SCR>,
                             smem_bytes(MAX_WARPS, M, false, SCR), raised);
    if (e) return e;
    select_kernel<Out, false, SCR><<<T, W * 32,
                                     smem_bytes(W, M, false, SCR), s>>>(
        q, p, cand, qrow, valid, out, C, M, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch select_kernel over T cell rows on `stream`, in the scratch class
// of k (1 <= k <= 1024); returns cudaGetLastError() (0 = launched).
template <class Out>
int launch_select(const float* q, const float* p, const int* cand,
                  const int* qrow, const int* valid, Out out, int T, int C,
                  int M, int k, void* stream) {
  if (T <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scratch_bytes(k)) {
    case SCRATCH:
      return launch_class<Out, SCRATCH>(q, p, cand, qrow, valid, out, T, C,
                                        M, k, s);
    case 2048:
      return launch_class<Out, 2048>(q, p, cand, qrow, valid, out, T, C, M,
                                     k, s);
    case 4096:
      return launch_class<Out, 4096>(q, p, cand, qrow, valid, out, T, C, M,
                                     k, s);
    default:
      return launch_class<Out, 8192>(q, p, cand, qrow, valid, out, T, C, M,
                                     k, s);
  }
}

}  // namespace knn_warp
