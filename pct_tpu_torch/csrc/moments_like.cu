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
// __fadd_rn (no FMA, no TF32); each sum over the 256 columns is the
// halving tree the plain version writes out (column i + column i + h for
// h = 128, 64, ..., 1); the chunks' statistics are added into o in chunk
// order from +0. So the kernel and its plain version
// (micro/moments_like.py) agree bit for bit.
//
// What bounds it on the card: 2 T C M 256 flops against the 67 TFLOP/s
// of FP32 (the bytes, x + y + o once, take a fifth of that time); the bit
// rule costs two FP32 instructions (FMUL, FADD) a multiply-add, so no
// bit-identical design beats twice that bound (0.0334 ms at the script's
// (8, 266, 1024)). The first design (16 rows of x a block, 4 x 4 a thread,
// 136 blocks for 132 SMs, scalar staging behind two barriers a 32-deep
// slice, the product tile through shared memory) ran at a sixth of that.
// This one spends itself on keeping the FP32 pipes fed:
// - Balance. A unit is (tile, slab of 136 rows of x, chunk, column
//   residue r mod 2): 136 x 128 outputs, one block each, and one block an
//   SM (its 197 KB of shared memory). At the script's shape that is 8 x 2
//   x 4 x 2 = 128 equal units on 132 SMs: counted from the grid, the
//   busiest SM does 1 unit against a mean of 0.97 (3% above it), and the
//   8 warps of a unit do 17 rows each; the padded rows cost 272 / 266 - 1
//   = 2.3% of the work and none of the time (each SM does one unit).
// - Copy under math. The unit's x slab (136 x 256) stays in shared memory;
//   y's 128 rows come through a 3-slot ring of 32-deep slices with
//   cp.async (16-byte copies), slice s + 2 in flight while slice s is
//   multiplied: one barrier a slice, 8 a unit.
// - Math per load. A thread keeps a 17 x 4 tile (68 accumulators, 146
//   registers, no spill): per 4 steps of depth it reads 4 float4 of y
//   (conflict-free: pitch 36) and 17 float4 of x (one address a warp)
//   for 272 multiply-adds. What a warp's loads deliver (21 x 512 bytes a
//   4-step) still takes shared memory about 60% of the FP32 pipes' time.
// - The column tree splits without losing a bit: a unit holds the
//   chunk's columns n = r + 2m, m = 0..127, which hold both members of
//   every pair at levels h = 128 .. 2, so it finishes those 7 levels
//   itself, straight from the accumulators (lane l holds m = l + 32 i: two
//   levels in registers, five across lanes as butterflies that finish 32
//   trees in 31 shuffles), and writes one float4 (sum, max, sum of
//   squares, max |d|) a row to `part`. The last unit of its (tile, slab)
//   to arrive (an integer ticket, no float atomics) does level h = 1
//   (residue 0 + residue 1) and the chunk sum in chunk order, a lane a
//   row with every row's loads in flight, then sets the ticket back to 0
//   for the next call.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 256;              // columns of d a chunk, and the depth
constexpr int NOUT = 128;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RW = 17;                  // rows of x a warp
constexpr int SLAB = WARPS * RW;        // rows of x a unit
constexpr int COLS = CHUNK / 2;         // columns a unit: one residue mod 2
constexpr int CPL = COLS / 32;          // columns a lane
constexpr int BK = 32;                  // depth a slice
constexpr int SLICES = CHUNK / BK;
constexpr int RING = 3;
constexpr int XP = CHUNK + 4;           // x slab pitch, floats
constexpr int YP = BK + 4;              // y ring pitch, floats
constexpr int SMEM = (SLAB * XP + RING * COLS * YP) * sizeof(float);

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Add {
  __device__ float operator()(float a, float b) const {
    return __fadd_rn(a, b);
  }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// One level of the butterfly below: lanes l and l ^ H, 2H values to H.
template <int H, class Op>
__device__ __forceinline__ void butterfly_level(float (&v)[32], int lane,
                                                Op op) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = op(keep, __shfl_xor_sync(FULL, send, H));
  }
}

// The last five levels of 32 trees at once, one a value index (lane l holds
// tree position l of each): at lane offset H = 16 .. 1 each lane keeps half
// its values and takes its partner's for them, so 31 shuffles finish all
// 32 and lane l ends with tree l's root. Each pair is the tree's own (a
// position p < H with p + H: lanes l and l ^ H), and the two operands' order
// does not change an add's or a max's bits.
template <class Op>
__device__ __forceinline__ float butterfly(float (&v)[32], int lane, Op op) {
  butterfly_level<16>(v, lane, op);
  butterfly_level<8>(v, lane, op);
  butterfly_level<4>(v, lane, op);
  butterfly_level<2>(v, lane, op);
  butterfly_level<1>(v, lane, op);
  return v[0];
}

__global__ void __launch_bounds__(THREADS, 1)
moments_like_kernel(const float* __restrict__ x,   // (T,C,256)
                    const float* __restrict__ y,   // (T,M,256)
                    float4* __restrict__ part,     // (T,C,M/256,2)
                    unsigned* __restrict__ ticket, // (T,slabs), zero
                    float* __restrict__ out,       // (T,C,128)
                    int C, int M) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // SLAB x XP
  float* ys = smem + SLAB * XP;          // RING x COLS x YP
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = M / CHUNK, slabs = (C + SLAB - 1) / SLAB;
  const int r = blockIdx.x & 1;
  const int j = (blockIdx.x >> 1) % chunks;
  const int slab = (blockIdx.x >> 1) / chunks;
  const size_t t = blockIdx.y;
  const int row0 = slab * SLAB, rows = min(SLAB, C - row0);
  const float* xt = x + (t * C + row0) * CHUNK;
  // this unit's column m is chunk row n = r + 2 m of y, at yt + 2 m CHUNK
  const float* yt = y + (t * M + static_cast<size_t>(j) * CHUNK + r) * CHUNK;

  for (int i = rows * CHUNK + tid; i < SLAB * CHUNK; i += THREADS)
    xs[(i / CHUNK) * XP + i % CHUNK] = 0.f;   // rows past C
  const int q = (tid % (BK / 4)) * 4;        // this thread's 16 bytes a row
  auto fetch = [&](int s) {
    float* yslot = ys + (s % RING) * COLS * YP;
#pragma unroll
    for (int row = tid / (BK / 4); row < SLAB + COLS;
         row += THREADS / (BK / 4)) {
      if (row < SLAB) {
        if (row < rows)
          cp16(xs + row * XP + s * BK + q,
               xt + static_cast<size_t>(row) * CHUNK + s * BK + q);
      } else {
        const int m = row - SLAB;
        cp16(yslot + m * YP + q,
             yt + static_cast<size_t>(2 * m) * CHUNK + s * BK + q);
      }
    }
    cp_commit();
  };

  float acc[RW][CPL];
#pragma unroll
  for (int a = 0; a < RW; ++a)
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[a][i] = 0.f;
  fetch(0);
  fetch(1);
  for (int s = 0; s < SLICES; ++s) {
    if (s + 1 < SLICES) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();   // slice s is in; slice s - 1's slot is read
    if (s + 2 < SLICES) fetch(s + 2);
    const float* xw = xs + warp * RW * XP + s * BK;
    const float* yw = ys + (s % RING) * COLS * YP + lane * YP;
#pragma unroll 2
    for (int kq = 0; kq < BK; kq += 4) {
      float4 b[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        b[i] = *reinterpret_cast<const float4*>(yw + i * 32 * YP + kq);
#pragma unroll
      for (int a = 0; a < RW; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(xw + a * XP + kq);
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          acc[a][i] = __fadd_rn(acc[a][i], __fmul_rn(v.x, b[i].x));
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          acc[a][i] = __fadd_rn(acc[a][i], __fmul_rn(v.y, b[i].y));
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          acc[a][i] = __fadd_rn(acc[a][i], __fmul_rn(v.z, b[i].z));
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          acc[a][i] = __fadd_rn(acc[a][i], __fmul_rn(v.w, b[i].w));
      }
    }
  }

  // The tree over this unit's columns (lane l holds m = l + 32 i): levels
  // m + 64 and m + 32 in registers, then five across lanes. Rows 0..15
  // go through two butterflies (sums: s of rows 0..15, then s2; maxima: max
  // d, then max |d|), row 16 through a plain one (pairs l, l ^ off).
  float sum[32], mxs[32];
  float s16, q16, m16, a16;
#pragma unroll
  for (int a = 0; a < RW; ++a) {
    float v[CPL], sq[CPL], mx = acc[a][0], ma = fabsf(acc[a][0]);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      v[i] = acc[a][i];
      sq[i] = __fmul_rn(v[i], v[i]);
      mx = fmaxf(mx, v[i]);
      ma = fmaxf(ma, fabsf(v[i]));
    }
#pragma unroll
    for (int w = CPL / 2; w > 0; w >>= 1)
#pragma unroll
      for (int i = 0; i < w; ++i) {
        v[i] = __fadd_rn(v[i], v[i + w]);
        sq[i] = __fadd_rn(sq[i], sq[i + w]);
      }
    if (a < 16) {
      sum[a] = v[0];
      sum[16 + a] = sq[0];
      mxs[a] = mx;
      mxs[16 + a] = ma;
    } else {
      s16 = v[0];
      q16 = sq[0];
      m16 = mx;
      a16 = ma;
    }
  }
  float bs = butterfly(sum, lane, Add{}), bm = butterfly(mxs, lane, Max{});
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {   // every lane ends with the root
    s16 = __fadd_rn(s16, __shfl_xor_sync(FULL, s16, off));
    q16 = __fadd_rn(q16, __shfl_xor_sync(FULL, q16, off));
    m16 = fmaxf(m16, __shfl_xor_sync(FULL, m16, off));
    a16 = fmaxf(a16, __shfl_xor_sync(FULL, a16, off));
  }
  // lane l < 16: row l's (s, max d); lane 16 + l: its (s2, max |d|)
  const float bs2 = __shfl_xor_sync(FULL, bs, 16);
  const float bm2 = __shfl_xor_sync(FULL, bm, 16);
  float4 mine = make_float4(bs, bm, bs2, bm2);   // lane l < 16: row l
  const int crow = lane < 16 ? lane : 16;
  if (lane == 16) mine = make_float4(s16, m16, q16, a16);
  const int c = warp * RW + crow;
  if (lane <= 16 && c < rows)
    part[((t * C + row0 + c) * chunks + j) * 2 + r] = mine;

  // the last unit of (t, slab) to arrive finishes its rows
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(ticket + t * slabs + slab, 1u) == 2u * chunks - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // lane l < RW of warp w finishes the warp's row l, every row's loads in
  // flight at once; the rows' statistics then go out a row at a time,
  // broadcast over the warp
  float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
  if (lane < RW && warp * RW + lane < rows) {
    const float4* p = part + (t * C + row0 + warp * RW + lane) * chunks * 2;
#pragma unroll 4
    for (int jj = 0; jj < chunks; ++jj) {   // level h = 1, then chunk order
      const float4 a = __ldcg(p + 2 * jj), b = __ldcg(p + 2 * jj + 1);
      o0 = __fadd_rn(o0, __fadd_rn(a.x, b.x));
      o1 = __fadd_rn(o1, fmaxf(a.y, b.y));
      o2 = __fadd_rn(o2, __fadd_rn(a.z, b.z));
      o3 = __fadd_rn(o3, fmaxf(a.w, b.w));
    }
  }
#pragma unroll
  for (int a = 0; a < RW; ++a) {
    const float v0 = __shfl_sync(FULL, o0, a), v1 = __shfl_sync(FULL, o1, a),
                v2 = __shfl_sync(FULL, o2, a), v3 = __shfl_sync(FULL, o3, a);
    const int cc = warp * RW + a;
    if (cc < rows) {
      float* o = out + (t * C + row0 + cc) * NOUT;
      o[lane] = v0;
      o[32 + lane] = v1;
      o[64 + lane] = v2;
      o[96 + lane] = v3;
    }
  }
  if (tid == 0) ticket[t * slabs + slab] = 0u;
}

}  // namespace

// Row slabs a tile: the wrapper sizes the ticket array (T x slabs) with it.
extern "C" int pct_moments_like_slabs(int C) { return (C + SLAB - 1) / SLAB; }

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes: x (T,C,256), y (T,M,256), out (T,C,128) float32, contiguous;
// M a multiple of 256 (checked by the wrapper); part: T*C*(M/256)*2
// float4 of scratch; ticket: T * pct_moments_like_slabs(C) zeroed
// unsigned ints, left zeroed by the launch.
extern "C" int pct_moments_like(const float* x, const float* y, float* out,
                                void* part, unsigned* ticket, int T, int C,
                                int M, void* stream) {
  if (T <= 0 || C <= 0) return 0;
  if (M <= 0 || M % CHUNK != 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool raised = false;   // above 48 KB needs the attribute
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        moments_like_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  const dim3 grid(pct_moments_like_slabs(C) * (M / CHUNK) * 2, T);
  moments_like_kernel<<<grid, THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<float4*>(part), ticket, out, C, M);
  return static_cast<int>(cudaGetLastError());
}
