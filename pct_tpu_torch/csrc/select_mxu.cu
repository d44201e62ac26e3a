// The k-nearest coords select with the winner extraction as a matrix
// product on the tensor cores, for sm_90a (H100): an A/B instrument beside
// select_coords.cu, not on any entry point's path.
//
// Replaces the TPU kernel scripts/micro_select_mxu.py::_mxu_kernel. Per
// cell row t and query slot c, over the M candidate slots (slots with
// valid <= 0 and the query itself, cand == qrow, read d2 = 3e38):
//   d2 in the difference form ((dx*dx + dy*dy) + dz*dz), d = q - p;
//   k rounds of: the minimum, the FIRST slot holding it, that slot set to
//   3e38; dist = sqrt(max(min, 0));
//   the round's winner extracted as a one-hot row times the (M, 4) matrix
//   P = [x, y, z, float(cand)], so rows = int(float(cand)) (ids above
//   2^24 round as float32 does).
// Once the usable slots are used up every d2 reads 3e38, so a missing
// slot carries dist sqrt(3e38) and slot 0's coordinates and id.
//
// The rounds' winners are the k smallest (d2, slot) pairs in order; a warp
// finds them for one query as select_coords.cu does (knn_warp.cuh: d2 once
// into the bit cache, the radix select, compaction and the warp sort),
// unchanged. The extraction is the product the script times, dense: A
// (one one-hot row a query and round, C k rows) times B (M x 16), on the
// bf16 tensor cores (mma.sync m16n8k16, f32 accumulate).
//
// Exact in bf16: each float32 v of P is cut into three bf16 pieces by
// truncation, hi = v's top 8 significant bits, mid = the top 8 of the
// exact remainder v - hi, lo = the rest (at most 8 bits), so (hi + mid) +
// lo rebuilds v bit for bit. A one-hot row times B gives each piece as one
// exact product plus zeros, from +0 (so a -0.0 coordinate reads +0.0, as
// the script's product does). A piece below 2^-126 would be a bf16
// subnormal, which the tensor cores may flush; so a value below 2^-103 (a
// piece of a larger one is 2^-126 or above) is cut after scaling by 2^64
// (exact), a fourth column carries a flag of 1.0, and the rebuilt value is
// scaled back by 2^-64 on the FP32 pipe (exact: v is a float32): so every
// finite float32, subnormals too, comes back bit for bit. B's 16 columns:
// [hi, mid] of x, y, z, float(cand) in the first n8 tile, [lo, flag] in
// the second, so lane (g, t) of an mma holds all four for value t of rows
// g and g + 8 and rebuilds them without a shuffle. (P holds finite values:
// 0 times an infinite piece would spread NaN over the row, as it did in
// the script.)
//
// What bounds it on the card: select_coords.cu's pairs (9 flops each, on
// the FP32 pipes at 67 TFLOP/s) and bytes, beside the extraction's 2 * 4
// * M flops a query and round (8 k C M a cell row: the one-hot product
// done densely, as the script does) on the bf16 tensor cores at 989
// TFLOP/s; at the script's shape the bytes bound it. The first
// design took 38.0 ms at (8192, 128, 504), k = 20, against the production
// select's 4.36 ms (NVIDIA H100 80GB HBM3, 700.00 W): its extraction ran
// one query a warp, 126 dependent FP64 mma.sync steps into one
// accumulator for each 8 rounds, and rebuilt B's fragments from the
// staged row for each of a row's 128 queries. Now:
// - B is built once a cell row (a chunk of KC slots) into shared memory,
//   column-major with a pitch of KC + 8 (conflict-free 32-bit fragment
//   loads), and each fragment is loaded once a k-step for MT m16 tiles;
// - the row's warps first write their queries' sorted winner positions
//   into shared memory (groups of G queries, a multiple of the warps,
//   when C k is past POS_CAP); after one barrier each warp takes MT m16
//   tiles at a time (32 query rounds), 2 MT independent accumulators;
// - A's one-hot fragments come from registers: per row its winner's k-step
//   and the fragment words it holds there, so a k-step costs two compares
//   and four selects a tile;
// - past KC slots the product runs over the chunks of B in turn, and a
//   row's value is written from the chunk that holds its winner (the other
//   chunks add exact zeros to it);
// - the selection keeps the production select's occupancy, four blocks an
//   SM: at most 64 registers a thread (__launch_bounds__, no spill) and
//   carve's shared memory plus 16.6 KB of B and 4 KB of positions.
// Layout: block_cells cell rows a block, one after the other (the TPU
// takes block_cells rows a grid step); warps over a row's query slots.

#include "knn_warp.cuh"

namespace {

using namespace knn_warp;

constexpr int KMAX = 128;
constexpr int KC = 512;                 // slots of B in shared memory at once
constexpr int KCP = KC + 8;             // B's column pitch, bf16
constexpr int NCOL = 16;                // B's columns: 4 values x 4 pieces
constexpr int POS_CAP = 1024;           // winner positions a query group
constexpr int MT = 2;                   // m16 tiles a warp takes at a time
constexpr unsigned BF16_ONE = 0x3f80u;
constexpr unsigned TINY_EXP = 24;       // biased exponent of 2^-103
constexpr size_t EXTRA = NCOL * KCP * sizeof(unsigned short) +
                         POS_CAP * sizeof(int);

// usable when valid > 0, not the query itself and below the sentinel
struct MxuRule {
  __device__ static unsigned bits(int valid, int cand, int qr, unsigned b) {
    return (valid > 0 && cand != qr && b < sent_bits()) ? b : sent_bits();
  }
};

// B's column of piece `piece` (0 hi, 1 mid, 2 lo, 3 flag) of value q
__device__ __forceinline__ int bcol(int q, int piece) {
  return (piece >> 1) * 8 + 2 * q + (piece & 1);
}

// Cut v into its bf16 pieces and write them into slot i of B's 4 columns
// for value q.
__device__ __forceinline__ void put_pieces(unsigned short* tab, int i, int q,
                                           float v) {
  const bool tiny = ((__float_as_uint(v) >> 23) & 0xffu) < TINY_EXP;
  const float s = tiny ? __fmul_rn(v, 0x1p64f) : v;
  const float hi = __uint_as_float(__float_as_uint(s) & 0xffff0000u);
  const float r = __fsub_rn(s, hi);
  const float mid = __uint_as_float(__float_as_uint(r) & 0xffff0000u);
  const float lo = __fsub_rn(r, mid);
  tab[bcol(q, 0) * KCP + i] = __float_as_uint(hi) >> 16;
  tab[bcol(q, 1) * KCP + i] = __float_as_uint(mid) >> 16;
  tab[bcol(q, 2) * KCP + i] = __float_as_uint(lo) >> 16;
  tab[bcol(q, 3) * KCP + i] = tiny ? BF16_ONE : 0u;
}

// B for slots kc0 .. kc0 + KC - 1 (zero rows past M), all threads.
template <class Row>
__device__ void build_b(unsigned short* tab, const Row& row, int kc0, int M) {
  for (int i = threadIdx.x; i < KC; i += blockDim.x) {
    const int m = kc0 + i;
    if (m < M) {
      put_pieces(tab, i, 0, row.x(m));
      put_pieces(tab, i, 1, row.y(m));
      put_pieces(tab, i, 2, row.z(m));
      put_pieces(tab, i, 3, __int2float_rn(row.id(m)));
    } else {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) tab[c * KCP + i] = 0;
    }
  }
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One A row's one-hot: the k-step holding its winner (-1: none in this
// chunk) and the fragment words this lane holds there, columns 2t, 2t+1
// (lo) and 2t+8, 2t+9 (hi) of the m16n8k16 A fragment.
struct OneHot {
  int step;
  unsigned lo, hi;
  __device__ OneHot(int pos, int kc0, int t) {
    const int p = pos - kc0;
    step = (pos >= 0 && p >= 0 && p < KC) ? p >> 4 : -1;
    const int c = p & 15;
    const unsigned w = BF16_ONE << ((c & 1) << 4);
    lo = (c >> 1) == t ? w : 0u;
    hi = (c >> 1) == t + 4 ? w : 0u;
  }
};

// The product for rows [0, nrow) of the group against B's chunk at kc0;
// row i is output o = obase + i. Each warp takes MT m16 tiles at a time.
__device__ void extract(const unsigned short* tab, const int* pos, int nrow,
                        int kc0, int M, size_t obase, int W, int warp,
                        int lane, float* nbr, int* rows) {
  const int g = lane >> 2, t = lane & 3;
  const int steps = (min(KC, M - kc0) + 15) >> 4;   // K padded to 16
  const unsigned* tab32 = reinterpret_cast<const unsigned*>(tab);
  for (int r0 = warp * MT * 16; r0 < nrow; r0 += W * MT * 16) {
    float d[MT][2][4];
    int step[MT][2];
    unsigned lo[MT][2], hi[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + mt * 16 + g + 8 * h;
        const OneHot oh(i < nrow ? pos[i] : -1, kc0, t);
        step[mt][h] = oh.step;
        lo[mt][h] = oh.lo;
        hi[mt][h] = oh.hi;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][n][e] = 0.f;
    }
    for (int s = 0; s < steps; ++s) {
      // B fragments of both n8 tiles: slots 16 s + 2t (+1), + 8 (+9)
      const int w = (16 * s + 2 * t) >> 1;
      const unsigned b00 = tab32[(g * KCP >> 1) + w];
      const unsigned b01 = tab32[(g * KCP >> 1) + w + 4];
      const unsigned b10 = tab32[((8 + g) * KCP >> 1) + w];
      const unsigned b11 = tab32[((8 + g) * KCP >> 1) + w + 4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bool on0 = step[mt][0] == s, on1 = step[mt][1] == s;
        const unsigned a0 = on0 ? lo[mt][0] : 0u, a1 = on1 ? lo[mt][1] : 0u;
        const unsigned a2 = on0 ? hi[mt][0] : 0u, a3 = on1 ? hi[mt][1] : 0u;
        mma_bf16(d[mt][0], a0, a1, a2, a3, b00, b01);
        mma_bf16(d[mt][1], a0, a1, a2, a3, b10, b11);
      }
    }
    // lane (g, t): value t of rows g and g + 8, from the chunk holding
    // their winners
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + mt * 16 + g + 8 * h;
        if (i >= nrow || step[mt][h] < 0) continue;
        // hi, mid from the first n8 tile, lo, flag from the second
        float v = __fadd_rn(__fadd_rn(d[mt][0][2 * h], d[mt][0][2 * h + 1]),
                            d[mt][1][2 * h]);
        if (d[mt][1][2 * h + 1] != 0.f) v = __fmul_rn(v, 0x1p-64f);
        const size_t o = obase + i;
        if (t < 3) nbr[o * 3 + t] = v;
        else rows[o] = static_cast<int>(v);
      }
    }
  }
}

template <bool CACHED>
__global__ void __launch_bounds__(MAX_WARPS * 32, 4)
mxu_kernel(const float* __restrict__ q,      // (T,C,3)
           const float* __restrict__ p,      // (T,M,3)
           const int* __restrict__ cand,     // (T,M)
           const int* __restrict__ qrow,     // (T,C)
           const int* __restrict__ valid,    // (T,M)
           float* __restrict__ dist,         // (T,C,k)
           float* __restrict__ nbr,          // (T,C,k,3)
           int* __restrict__ rows,           // (T,C,k)
           int C, int M, int k, int bc, int G, int tab_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  // carve's area, then B's chunk, then the group's winner positions
  unsigned short* tab = reinterpret_cast<unsigned short*>(smem + tab_off);
  int* pos = reinterpret_cast<int*>(tab + NCOL * KCP);
  const float missing = __fsqrt_rn(SENT);
  for (int r = 0; r < bc; ++r) {
    const size_t t = static_cast<size_t>(blockIdx.x) * bc + r;
    if (r > 0) __syncthreads();   // every warp is done with the last row
    const float* pt = p + t * M * 3;
    const int* ct = cand + t * M;
    const int* vt = valid + t * M;
    const Block b = carve(smem, CACHED, W, warp, pt, ct, vt, M);
    const unsigned long long* keys =
        reinterpret_cast<const unsigned long long*>(b.scratch);
    const GlobalRow grow{pt, ct, vt};
    for (int c0 = 0; c0 < C; c0 += G) {
      const int cn = min(G, C - c0);
      if constexpr (CACHED) build_b(tab, b.row, 0, M);
      else build_b(tab, grow, 0, M);
      for (int c = c0 + warp; c < c0 + cn; c += W) {
        const size_t qi = t * C + c;
        const float qx = q[qi * 3], qy = q[qi * 3 + 1], qz = q[qi * 3 + 2];
        const int qr = qrow[qi];
        int n;
        if constexpr (CACHED) {
          fill_bits<MxuRule>(b.bits, b.row, qx, qy, qz, qr, M, lane);
          n = select_sorted(CachedBits{b.bits}, M, k, b.scratch, lane);
        } else {
          n = select_sorted(RowBits<MxuRule, GlobalRow>{grow, qx, qy, qz, qr},
                            M, k, b.scratch, lane);
        }
        int* pq = pos + (c - c0) * k;
        for (int j = lane; j < k; j += 32) {
          dist[qi * k + j] = j < n ? key_dist(keys[j]) : missing;
          pq[j] = j < n ? key_pos(keys[j]) : 0;   // missing: slot 0
        }
        __syncwarp();
      }
      __syncthreads();   // positions and B's first chunk are in
      const size_t obase = (t * C + c0) * k;
      for (int kc0 = 0;;) {
        extract(tab, pos, cn * k, kc0, M, obase, W, warp, lane, nbr, rows);
        kc0 += KC;
        if (kc0 >= M) break;
        __syncthreads();
        if constexpr (CACHED) build_b(tab, b.row, kc0, M);
        else build_b(tab, grow, kc0, M);
        __syncthreads();
      }
      __syncthreads();   // B and the positions are free for the next group
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes: q (T,C,3), p (T,M,3) float32; cand (T,M), qrow (T,C), valid (T,M)
// int32; outputs dist (T,C,k), nbr (T,C,k,3) float32, rows (T,C,k) int32;
// all contiguous. Requires T % bc == 0, 1 <= C <= 1024, M >= 1 and
// 1 <= k <= 128 (checked by the wrapper).
extern "C" int pct_select_coords_mxu(const float* q, const float* p,
                                     const int* cand, const int* qrow,
                                     const int* valid, float* dist,
                                     float* nbr, int* rows, int T, int C,
                                     int M, int k, int bc, void* stream) {
  if (T <= 0) return 0;
  if (k < 1 || k > KMAX || bc < 1 || T % bc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = min(MAX_WARPS, C);
  // queries a group: a multiple of W whose C k positions fit POS_CAP
  const int G = max(W, POS_CAP / k / W * W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool raised = false;   // above 48 KB needs the attribute
  if (!raised) {
    const int most = static_cast<int>(CACHE_BUDGET + EXTRA);
    cudaError_t e = cudaFuncSetAttribute(
        mxu_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mxu_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  const bool cached = use_cache(W, M);
  const int off = static_cast<int>(smem_bytes(W, M, cached));
  if (cached) {
    mxu_kernel<true><<<T / bc, W * 32, off + EXTRA, s>>>(
        q, p, cand, qrow, valid, dist, nbr, rows, C, M, k, bc, G, off);
  } else {
    mxu_kernel<false><<<T / bc, W * 32, off + EXTRA, s>>>(
        q, p, cand, qrow, valid, dist, nbr, rows, C, M, k, bc, G, off);
  }
  return static_cast<int>(cudaGetLastError());
}
