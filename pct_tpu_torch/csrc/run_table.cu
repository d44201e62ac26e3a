// The run table's suffix-min, for sm_90a (H100): t[i] = min(t[i], ..., t[size-1])
// over a 1-D int32 table, in place.
//
// Replaces no TPU kernel: the JAX package takes jax.lax.cummin(table,
// reverse=True) (pct_tpu/neighbors/cellknn.py:354), an XLA op. The port took
// torch.flip(torch.cummin(torch.flip(t))): PyTorch's innermost-dimension scan
// with indices runs a 1-D tensor as one row, in one block of 512 threads, and
// writes an int64 index a box that nothing reads (~10.7 ms a 2^22-box table).
// pct_tpu_torch/ops/run_table.py::suffix_min_plain is that expression, kept as
// the plain version; min is exact, so the two agree bit for bit on any input.
//
// What bounds it on the card: the table read and written once, 8 B a box
// (2^22 boxes: 33.6 MB, 0.010 ms at 3.35 TB/s). The design: two launches, no
// atomics and no waiting between blocks. A tile is 4,096 boxes, 16 a thread
// (four int4 loads) over 256 threads.
//   1. run_table_tile_min_kernel: one block a tile writes the tile's minimum
//      into mins[tile] (at most 2,048 ints at 2^23 boxes).
//   2. run_table_suffix_min_kernel: one block a tile reduces mins[tile+1 ..]
//      (from L2) to its carry, scans its 16 registers a thread from the last,
//      carries between threads by a warp suffix-scan (__shfl_down_sync) and
//      between warps through shared memory, and writes its own tile back. It
//      reads only its own tile and mins, so the write in place is safe.
// A ragged last tile, or a table whose address is not 16-byte aligned, takes
// scalar loads; boxes past the end read as INT_MAX, the identity of min.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 16;                    // boxes a thread
constexpr int TILE = THREADS * PER;        // boxes a block
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// The thread's 16 boxes, tile-relative boxes [16 * threadIdx.x, + 16).
__device__ __forceinline__ void load(const int* t, int size, int tile,
                                     int (&v)[PER]) {
  const long long first = (long long)tile * TILE + PER * threadIdx.x;
  const bool vec = first + PER <= size &&
                   (reinterpret_cast<uintptr_t>(t) & 15) == 0;
  if (vec) {
    const int4* p = reinterpret_cast<const int4*>(t + first);
#pragma unroll
    for (int j = 0; j < PER / 4; ++j) {
      const int4 q = p[j];
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      v[j] = first + j < size ? t[first + j] : INT_MAX;
    }
  }
}

__device__ __forceinline__ void store(int* t, int size, int tile,
                                      const int (&v)[PER]) {
  const long long first = (long long)tile * TILE + PER * threadIdx.x;
  const bool vec = first + PER <= size &&
                   (reinterpret_cast<uintptr_t>(t) & 15) == 0;
  if (vec) {
    int4* p = reinterpret_cast<int4*>(t + first);
#pragma unroll
    for (int j = 0; j < PER / 4; ++j) {
      p[j] = make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (first + j < size) t[first + j] = v[j];
    }
  }
}

// The minimum of x over the block, on every thread.
__device__ __forceinline__ int block_min(int x, int* shared) {
  x = __reduce_min_sync(FULL, x);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = x;
  __syncthreads();
  x = shared[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) x = min(x, shared[w]);
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(THREADS)
run_table_tile_min_kernel(const int* __restrict__ t, int* __restrict__ mins,
                          int size) {
  __shared__ int warp_min[WARPS];
  int v[PER];
  load(t, size, blockIdx.x, v);
  int m = v[0];
#pragma unroll
  for (int j = 1; j < PER; ++j) m = min(m, v[j]);
  m = block_min(m, warp_min);
  if (threadIdx.x == 0) mins[blockIdx.x] = m;
}

__global__ void __launch_bounds__(THREADS)
run_table_suffix_min_kernel(int* __restrict__ t,
                            const int* __restrict__ mins, int size,
                            int tiles) {
  __shared__ int warp_min[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the carry: the minimum of every tile after this one
  int carry = INT_MAX;
  for (int i = blockIdx.x + 1 + threadIdx.x; i < tiles; i += THREADS) {
    carry = min(carry, mins[i]);
  }
  carry = block_min(carry, warp_min);

  int v[PER];
  load(t, size, blockIdx.x, v);
#pragma unroll
  for (int j = PER - 2; j >= 0; --j) v[j] = min(v[j], v[j + 1]);
  // inclusive suffix-min of the threads' minima (v[0]) over the warp
  int x = v[0];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(FULL, x, off);
    if (lane + off < 32) x = min(x, y);
  }
  int after = __shfl_down_sync(FULL, x, 1);   // lanes after this one
  if (lane == 31) after = INT_MAX;
  if (lane == 0) warp_min[warp] = x;
  __syncthreads();
  for (int w = warp + 1; w < WARPS; ++w) after = min(after, warp_min[w]);
  after = min(after, carry);
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = min(v[j], after);
  store(t, size, blockIdx.x, v);
}

int tiles_of(int size) { return (size + TILE - 1) / TILE; }

}  // namespace

// Pass 1 over table[0, size): mins[i] = min of tile i, for the
// ceil(size / 4096) tiles. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int pct_run_table_tile_min(const int* table, int* mins, int size,
                                      cudaStream_t stream) {
  run_table_tile_min_kernel<<<tiles_of(size), THREADS, 0, stream>>>(
      table, mins, size);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: table[i] = min(table[i .. size)) in place, from pass 1's mins.
extern "C" int pct_run_table_suffix_min(int* table, const int* mins, int size,
                                        cudaStream_t stream) {
  const int tiles = tiles_of(size);
  run_table_suffix_min_kernel<<<tiles, THREADS, 0, stream>>>(table, mins, size,
                                                             tiles);
  return static_cast<int>(cudaGetLastError());
}
