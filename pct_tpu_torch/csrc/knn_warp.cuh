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
//
// Past k = 1024 the block class at the end of this file runs the same
// select with a whole block on one query slot (select_block_kernel, and
// band_select.cu's band_block_kernel); it takes any k.

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

// ---------------------------------------------------------------------------
// The block class, k > KWARP. Past 1024 keys a warp's sort scratch would take
// 16 KB (128 KB for a block of 8 warps), so one block of BLOCK_THREADS serves
// one query slot at a time and the block's shared memory is the query's:
// - the d2 bits of the query's M candidates go once into a shared slice of M
//   words where it fits the budget with the keys (else every pass
//   recomputes them from device memory, through L1 and L2);
// - the kth smallest tau by the same four 8-bit digit passes from the top,
//   each a block-wide 256-bin shared histogram and a block scan of it;
// - the compaction in candidate order, BLOCK_THREADS candidates a step:
//   every slot below tau and the first k - below at tau, ranked by a scan
//   of the warps' ballots, as keys (d2 bits << 32 | position), the k
//   smallest (d2, position) pairs, all unique;
// - a bitonic network in its all-ascending form: the first step of a merge
//   of `size` compares i with its mirror i ^ (size - 1), the later ones i
//   with i + stride, and every comparator puts the smaller key first. Keys
//   past n then act as +inf without being stored: a comparator that reaches
//   past n is skipped, so n keys need n slots. Up to SORT_KEYS keys (128
//   KB) the network runs in shared memory; past that the keys lie in a
//   device-memory workspace of the wrapper's, each aligned SORT_KEYS tile is
//   sorted in shared memory, and of every longer merge the steps that span
//   more than a tile run over device memory, the rest tile by tile.
// The output is the warp classes': the order the Pallas kernels' k rounds of
// min and first-argmin emit. No k ceiling is left (n <= min(k, M) keys).

constexpr int KWARP = 1024;              // the warp classes' largest k
constexpr int BLOCK_THREADS = 256;       // the block class: one query a block
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
constexpr int SORT_KEYS = 16384;         // keys sorted in shared memory

// The block class's fixed shared scratch (at the start of dynamic memory).
struct BlockScratch {
  unsigned hist[256];                    // a digit pass's histogram
  unsigned wsum[BLOCK_WARPS];            // its scan's warp totals
  unsigned pick[2];                      // the digit found, the count below
  int cnt[2][2][BLOCK_WARPS];            // the compaction's warp counts
};
constexpr size_t BLOCK_SCRATCH = (sizeof(BlockScratch) + 15) & ~size_t(15);

// The kk-th smallest (1 <= kk <= M) of src(m) over m < M, the whole block
// together; *below gets how many values are strictly smaller.
template <class Src>
__device__ unsigned block_radix_kth(const Src& src, int M, int kk,
                                    BlockScratch& s, int* below) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned prefix = 0, known = 0;
  int under = 0;
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    s.hist[tid] = 0;
    __syncthreads();
    for (int m = tid; m < M; m += BLOCK_THREADS) {
      const unsigned v = src(m);
      if ((v & known) == prefix) atomicAdd(&s.hist[(v >> shift) & 255u], 1u);
    }
    __syncthreads();
    const unsigned c = s.hist[tid];
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s.wsum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += s.wsum[w];
    const unsigned want = static_cast<unsigned>(kk);
    if (incl - c < want && want <= incl) {
      s.pick[0] = static_cast<unsigned>(tid);
      s.pick[1] = incl - c;
    }
    __syncthreads();
    const int lo = static_cast<int>(s.pick[1]);
    prefix |= s.pick[0] << shift;
    known |= 255u << shift;
    kk -= lo;
    under += lo;
  }
  *below = under;
  return prefix;
}

// Write the n keys of the winners (tau, below from block_radix_kth) to
// keys[0, n) in candidate order: src(m) the bits, pos(m) the key's low word.
template <class Src, class Pos>
__device__ void block_compact(const Src& src, const Pos& pos, int M,
                              unsigned tau, int n, int below,
                              unsigned long long* keys, BlockScratch& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;   // lanes below this one
  int base = 0, eq_left = n - below, par = 0;
  for (int m0 = 0; m0 < M && base < n; m0 += BLOCK_THREADS, par ^= 1) {
    const int m = m0 + tid;
    const unsigned v = m < M ? src(m) : ~0u;
    const unsigned lt = __ballot_sync(FULL, v < tau);
    const unsigned eq = __ballot_sync(FULL, v == tau);
    if (lane == 0) {
      s.cnt[par][0][warp] = __popc(lt);
      s.cnt[par][1][warp] = __popc(eq);
    }
    __syncthreads();   // the counts of step par are read before par's reuse
    int lt_pre = __popc(lt & lt_mask), eq_pre = __popc(eq & lt_mask);
    int lt_all = 0, eq_all = 0;
#pragma unroll
    for (int w = 0; w < BLOCK_WARPS; ++w) {
      const int a = s.cnt[par][0][w], b = s.cnt[par][1][w];
      if (w < warp) {
        lt_pre += a;
        eq_pre += b;
      }
      lt_all += a;
      eq_all += b;
    }
    if (v < tau || (v == tau && eq_pre < eq_left))
      keys[base + lt_pre + min(eq_pre, eq_left)] =
          (static_cast<unsigned long long>(v) << 32) | pos(m);
    const int took = min(eq_all, eq_left);
    base += lt_all + took;
    eq_left -= took;
  }
}

// One step of the all-ascending bitonic network over keys[0, n): the merge
// of `size`, comparators `stride` apart (the mirror step where stride is
// size / 2); comparators that reach past n are skipped.
__device__ __forceinline__ void sort_step(unsigned long long* keys, int n,
                                          int size, int stride) {
  const bool mirror = stride == (size >> 1);
  for (int t = threadIdx.x; t < n; t += BLOCK_THREADS) {
    const int i = 2 * t - (t & (stride - 1));
    const int j = mirror ? (i ^ (size - 1)) : i + stride;
    if (j < n) {
      const unsigned long long a = keys[i], b = keys[j];
      if (a > b) {
        keys[i] = b;
        keys[j] = a;
      }
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int P = 1;
  while (P < n) P <<= 1;
  return P;
}

// Sort keys[0, n) ascending, the whole block together; starts and ends with
// a barrier.
__device__ void block_sort(unsigned long long* keys, int n) {
  const int P = pow2_at_least(n);
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      sort_step(keys, n, size, stride);
      __syncthreads();
    }
}

// The same network over keys[0, n) in device memory, n > SORT_KEYS: the
// merges up to SORT_KEYS tile by tile in `tile` (SORT_KEYS shared keys);
// of each longer merge the steps whose comparators span more than a tile
// over device memory, then the rest tile by tile.
__device__ void block_sort_global(unsigned long long* keys, int n,
                                  unsigned long long* tile) {
  const int tid = threadIdx.x, P = pow2_at_least(n);
  for (int t0 = 0; t0 < n; t0 += SORT_KEYS) {
    const int len = min(SORT_KEYS, n - t0);
    __syncthreads();
    for (int i = tid; i < len; i += BLOCK_THREADS) tile[i] = keys[t0 + i];
    block_sort(tile, len);
    for (int i = tid; i < len; i += BLOCK_THREADS) keys[t0 + i] = tile[i];
  }
  __syncthreads();
  for (int size = 2 * SORT_KEYS; size <= P; size <<= 1) {
    int stride = size >> 1;
    for (; stride >= SORT_KEYS; stride >>= 1) {
      sort_step(keys, n, size, stride);
      __syncthreads();
    }
    for (int t0 = 0; t0 < n; t0 += SORT_KEYS) {
      const int len = min(SORT_KEYS, n - t0);
      for (int i = tid; i < len; i += BLOCK_THREADS) tile[i] = keys[t0 + i];
      __syncthreads();
      for (int st = stride; st > 0; st >>= 1) {
        sort_step(tile, len, size, st);
        __syncthreads();
      }
      for (int i = tid; i < len; i += BLOCK_THREADS) keys[t0 + i] = tile[i];
      __syncthreads();
    }
  }
}

// The winners of one query over src(m), m < M (M >= 1), kk = min(k, M):
// their sorted keys in keys[0, n), n returned. `tile` is the shared tile of
// the device-memory sort (unused with SHARED_SORT).
template <bool SHARED_SORT, class Src, class Pos>
__device__ int block_select(const Src& src, const Pos& pos, int M, int kk,
                            unsigned long long* keys,
                            unsigned long long* tile, BlockScratch& s) {
  int below;
  const unsigned tau = block_radix_kth(src, M, kk, s, &below);
  const int n = found_count(tau, below, kk);
  block_compact(src, pos, M, tau, n, below, keys, s);
  if constexpr (SHARED_SORT)
    block_sort(keys, n);
  else
    block_sort_global(keys, n, tile);
  return n;
}

struct SlotPos {
  __device__ unsigned operator()(int m) const {
    return static_cast<unsigned>(m);
  }
};

// Shared bytes of a block-class launch: the scratch, the bits slice
// (cached) and the sort's keys (min(k, M) of them, or the tile of the
// device-memory sort past SORT_KEYS).
inline size_t block_smem_bytes(int M, int k, bool cached) {
  const int kk = min(k, M);
  const size_t keys = kk <= SORT_KEYS ? kk : SORT_KEYS;
  return BLOCK_SCRATCH + (cached ? static_cast<size_t>(pitch(M)) * 4 : 0) +
         keys * 8;
}

inline bool block_cached(int M, int k) {
  return block_smem_bytes(M, k, true) <= WIDE_BUDGET;
}

// One block per query slot qi of the T*C (grid-stride): the query's
// winners sorted, then out.write_block(row, keys, n, qi, k). Without
// SHARED_SORT the keys go to ws + blockIdx.x * min(k, M) in device memory.
template <class Out, bool CACHED, bool SHARED_SORT>
__global__ void __launch_bounds__(BLOCK_THREADS)
select_block_kernel(const float* __restrict__ q,      // (T,C,3)
                    const float* __restrict__ p,      // (T,M,3)
                    const int* __restrict__ cand,     // (T,M)
                    const int* __restrict__ qrow,     // (T,C)
                    const int* __restrict__ valid,    // (T,M)
                    Out out, unsigned long long* __restrict__ ws,
                    size_t TC, int C, int M, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  BlockScratch& s = *reinterpret_cast<BlockScratch*>(smem);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + BLOCK_SCRATCH);
  unsigned long long* shared_keys = reinterpret_cast<unsigned long long*>(
      smem + BLOCK_SCRATCH +
      (CACHED ? static_cast<size_t>(pitch(M)) * 4 : 0));
  const int kk = min(k, M);
  unsigned long long* keys =
      SHARED_SORT ? shared_keys : ws + blockIdx.x * static_cast<size_t>(kk);
  for (size_t qi = blockIdx.x; qi < TC; qi += gridDim.x) {
    const size_t t = qi / C;
    const GlobalRow row{p + t * M * 3, cand + t * M, valid + t * M};
    const RowBits<SelectRule, GlobalRow> src{row, q[qi * 3], q[qi * 3 + 1],
                                             q[qi * 3 + 2],
                                             qrow[qi]};
    __syncthreads();   // the last query's bits and keys are read
    int n;
    if constexpr (CACHED) {
      for (int m = threadIdx.x; m < M; m += BLOCK_THREADS) bits[m] = src(m);
      __syncthreads();
      n = block_select<SHARED_SORT>(CachedBits{bits}, SlotPos{}, M, kk, keys,
                                    shared_keys, s);
    } else {
      n = block_select<SHARED_SORT>(src, SlotPos{}, M, kk, keys, shared_keys,
                                    s);
    }
    out.write_block(row, keys, n, qi, k);
  }
}

// Blocks of a block-class launch whose keys take the device-memory
// workspace: its min(k, M)-key slices are one a block.
constexpr int WS_BLOCKS = 264;           // two an SM on the H100's 132

template <class Out, bool CACHED, bool SHARED_SORT>
int launch_block_variant(const float* q, const float* p, const int* cand,
                         const int* qrow, const int* valid, Out out,
                         unsigned long long* ws, size_t TC, int C, int M,
                         int k, cudaStream_t s) {
  static bool raised = false;   // above 48 KB needs the attribute
  const int e = raise_smem(select_block_kernel<Out, CACHED, SHARED_SORT>,
                           WIDE_BUDGET, raised);
  if (e) return e;
  const size_t most = SHARED_SORT ? static_cast<size_t>(0x7fffffff)
                                  : static_cast<size_t>(WS_BLOCKS);
  const unsigned grid = static_cast<unsigned>(TC < most ? TC : most);
  select_block_kernel<Out, CACHED, SHARED_SORT>
      <<<grid, BLOCK_THREADS, block_smem_bytes(M, k, CACHED), s>>>(
          q, p, cand, qrow, valid, out, ws, TC, C, M, k);
  return static_cast<int>(cudaGetLastError());
}

// Launch the block class (k > KWARP) over the T*C query slots on `stream`;
// `ws` holds WS_BLOCKS * min(k, M) keys where min(k, M) > SORT_KEYS (else
// it may be null). Returns cudaGetLastError() (0 = launched).
template <class Out>
int launch_select_block(const float* q, const float* p, const int* cand,
                        const int* qrow, const int* valid, Out out,
                        unsigned long long* ws, int T, int C, int M, int k,
                        void* stream) {
  const size_t TC = static_cast<size_t>(T) * C;
  if (TC == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cached = block_cached(M, k);
  if (min(k, M) <= SORT_KEYS)
    return cached ? launch_block_variant<Out, true, true>(
                        q, p, cand, qrow, valid, out, ws, TC, C, M, k, s)
                  : launch_block_variant<Out, false, true>(
                        q, p, cand, qrow, valid, out, ws, TC, C, M, k, s);
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return cached ? launch_block_variant<Out, true, false>(
                      q, p, cand, qrow, valid, out, ws, TC, C, M, k, s)
                : launch_block_variant<Out, false, false>(
                      q, p, cand, qrow, valid, out, ws, TC, C, M, k, s);
}

// The selects' entry: the warp classes up to k = KWARP, else the block
// class (`ws` as launch_select_block takes it). Returns a CUDA error code
// (0 = launched).
template <class Out>
int launch_select_any(const float* q, const float* p, const int* cand,
                      const int* qrow, const int* valid, Out out, void* ws,
                      int T, int C, int M, int k, void* stream) {
  if (k < 1 || C < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (k > KWARP)
    return launch_select_block(q, p, cand, qrow, valid, out,
                               static_cast<unsigned long long*>(ws), T, C, M,
                               k, stream);
  return launch_select(q, p, cand, qrow, valid, out, T, C, M, k, stream);
}

}  // namespace knn_warp
