// Band k-nearest selection for row blocks of grid cells, for sm_90a (H100).
//
// Replaces the TPU kernel _band_kernel of pct_tpu/experimental/pallas_band.py
// (wrapper knn_band_select). A row block b holds bc cells of one grid (y,z)
// row, so the 27-cell windows of its cells are 9 contiguous bands of sorted
// rows: band j covers rows bs[b,j] .. bs[b,j]+band. For query slot s of the
// block (cell c = s / cap, qrow = qrow_base[b,c] + s % cap), over the
// concatenated positions i = j*band + p:
//   position p of band j is a candidate iff
//     rs_rel[b,c,j] <= p < rs_rel[b,c,j] + run_len[b,c,j]  and  bs[b,j]+p != qrow
//   d2 = ((dx*dx + dy*dy) + dz*dz),  d = q - plane[bs[b,j]+p]   (difference form)
//   emit the k smallest in ascending (d2, i) order: dist = sqrt(max(d2, 0)) and
//   row = bs[b, i/band] + i%band. Missing slots (fewer than k candidates) keep
//   (3e38, i = 0): distance sqrt(3e38) and row bs[b,0], which is what the
//   Pallas kernel's k rounds of min / first-argmin / mask-out give once every
//   position reads 3e38 (a d2 at or above 3e38 is never a candidate).
//   cover = min(min(min(qx-lox, hix-qx), min(qy-loy, hiy-qy)), min(qz-loz, hiz-qz))
//   with the edges of the slot's cell. Plane rows outside [0, npad) read 0.
// Without `counts` every query slot is computed, as the Pallas kernel does.
// With counts (NB,bc) int32, a slot with s % cap >= counts[b,c] (a padding
// slot) is not computed: it gets the missing-slot outputs (sqrt(3e38), row
// bs[b,0]) in all k places, and its cover as above.
//
// Bit-exactness: d2 uses __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract
// it into FMAs, and the distance is __fsqrt_rn; the plain PyTorch version in
// experimental/band_select.py does the same IEEE operations in the same order,
// so the two agree bit for bit on the card.
//
// What bounds it on the card: S = NB*bc*cap query slots must write k*8 bytes
// each (distance and row) plus a 4-byte cover, S*k*8 + S*4 bytes, and read
// the planes (12 B a row), the queries (12 B a slot) and the small per-cell
// tables once, against 3.35 TB/s; the pair work is one d2 (~9 float32
// operations) per (real query slot, run position) against the 67 TFLOP/s
// FP32 rate. On the 1M-point k=20 path the output bytes dominate: the bound
// is the bytes.
//
// The design (knn_warp.cuh): one block of 8 warps per row block.
// - Staging that does not follow `band`: per band j the block stages only
//   the hull of the runs of its cells that have a computed slot, rows
//   bs[b,j] + [min_c rs_rel, max_c (rs_rel + run_len)), into a tile of TILE
//   rows (x, y, z planes) whose size is fixed, so the block's shared memory
//   and the card's occupancy no longer depend on `band`. A block whose hulls
//   exceed the tile reads its runs from device memory instead (through L1
//   and L2), in every pass that needs a d2: correct and slower, for the few
//   blocks whose row has wide x gaps.
// - One warp per computed query slot. The block lists its computed slots
//   (a prefix sum of the per-cell counts) and the warps take them in turn,
//   so padding slots cost no select; a warp-wide pass writes their fill.
//   A query's candidates are its cell's 9 runs, concatenated in (j, p)
//   order: M = sum of the run lengths (~100-230 on the 1M torus). The warp
//   computes each d2 once into its slice of BITS words (past BITS it
//   recomputes d2 in each pass), finds the kth smallest bits tau and the
//   exact counts below and at it with the radix select, compacts in (j, p)
//   order the slots below tau and the first k - below at tau as keys
//   (d2 bits << 32 | i) with i = j*band + p, the Pallas kernel's
//   concatenated position (never the tile index), sorts the <= k keys
//   with the warp's bitonic network and writes them with consecutive lanes
//   on consecutive j. That is the set and the order of the Pallas kernel's
//   k rounds of min, first-argmin and mask-out.
// - Up to k = 1024 each warp's scratch (histogram, then the sort's keys)
//   is knn_warp.cuh's class of k, 1 KB up to k = 128, else 8 bytes a key
//   for the next power of two >= k; the kernel is instantiated once a
//   class. Past 1024, band_block_kernel (the block class) runs the same
//   set-up, then gives the whole block to one computed query slot at a
//   time: its M <= 9 * band candidates' bits in one shared slice,
//   knn_warp.cuh's block select in (j, p) order and the n <= min(k, M)
//   keys sorted in shared memory (at most 9 * 1024 of them, 72 KB). So
//   any k runs, as the Pallas kernel takes any k. The band's own limit is
//   the JAX package's window, band <= 1024; a block takes any bc * cap
//   query slots, as the JAX package's does.

#include "knn_warp.cuh"

namespace {

using namespace knn_warp;

constexpr int NINE = 9;
constexpr int BAND_WARPS = 8;
constexpr int TILE = 2048;   // staged rows a block (the 9 hulls together)
constexpr int BITS = 512;    // cached d2 bits a warp (candidates a query)
constexpr int SEG = 20;      // a warp's segment table: off[10], p0[9]

// dynamic shared bytes a block: the card's most, less the kernels' static
// 148 bytes (sbs, slo, shi, start)
constexpr size_t BAND_BUDGET = WIDE_BUDGET - 256;

// A block's dynamic shared bytes at `bc` cells and `scr` scratch bytes a
// warp.
size_t band_smem_bytes(int bc, int scr) {
  return static_cast<size_t>(BAND_WARPS) * (scr + BITS * 4 + SEG * 4) +
         static_cast<size_t>(3 * TILE) * 4 + static_cast<size_t>(bc + 1) * 4;
}

// Band j's rows p, read from the staged tile (row bs[b,j] + p at tile index
// off + p) ...
struct TileSeg {
  const float* x;
  const float* y;
  const float* z;
  int off;
  __device__ void at(int p, float& a, float& b, float& c) const {
    a = x[off + p];
    b = y[off + p];
    c = z[off + p];
  }
};

struct TileBand {
  const float* x;
  const float* y;
  const float* z;
  const int* start;   // tile index of band j's first hull row
  const int* lo;      // band j's first hull position
  __device__ TileSeg seg(int j) const {
    return TileSeg{x, y, z, start[j] - lo[j]};
  }
};

// ... or from the planes in device memory (row g = bs[b,j] + p).
struct GlobalSeg {
  const float* x;
  const float* y;
  const float* z;
  long long g0;
  int npad;
  __device__ void at(int p, float& a, float& b, float& c) const {
    const long long g = g0 + p;
    const bool in = g >= 0 && g < npad;
    a = in ? __ldg(x + g) : 0.f;
    b = in ? __ldg(y + g) : 0.f;
    c = in ? __ldg(z + g) : 0.f;
  }
};

struct GlobalBand {
  const float* x;
  const float* y;
  const float* z;
  const int* bs;
  int npad;
  __device__ GlobalSeg seg(int j) const {
    return GlobalSeg{x, y, z, static_cast<long long>(bs[j]), npad};
  }
};

// The bits of position p of band j for one query: d2, or the sentinel
// for the query itself and for d2 at or above it.
struct BandRule {
  const int* bs;
  float qx, qy, qz;
  int qr;
  template <class Seg>
  __device__ unsigned operator()(int j, const Seg& s, int p) const {
    float x, y, z;
    s.at(p, x, y, z);
    const unsigned b = d2_bits(qx, qy, qz, x, y, z);
    return (bs[j] + p != qr && b < sent_bits()) ? b : sent_bits();
  }
};

// The query's candidates as one flat index m < off[9]: segment j holds
// positions p0[j] + (m - off[j]) of band j (the streamed source).
template <class Band>
struct BandFlat {
  Band band;
  BandRule rule;
  const int* off;
  const int* p0;
  __device__ unsigned operator()(int m) const {
    int j = 0;
#pragma unroll
    for (int jj = 1; jj < NINE; ++jj) j += m >= off[jj];
    return rule(j, band.seg(j), p0[j] + m - off[j]);
  }
};

// One computed query slot: its k winners, written to dist[0, k) and
// rows[0, k). `seg` is the warp's table of the query's 9 runs.
template <class Band>
__device__ void band_query(const Band& band, const BandRule& rule,
                           const int* seg, unsigned* bits, int bandw, int k,
                           unsigned char* scratch, int lane, float* dist,
                           int* rows) {
  const int* off = seg;
  const int* p0 = seg + 10;
  const int M = off[NINE];
  const bool cached = M <= BITS;
  if (cached) {
    for (int j = 0; j < NINE; ++j) {
      const auto s = band.seg(j);
      const int a = off[j], len = off[j + 1] - a, pj = p0[j];
      for (int t = lane; t < len; t += 32) bits[a + t] = rule(j, s, pj + t);
    }
    __syncwarp();
  }
  int n = 0, below = 0;
  unsigned tau = sent_bits();
  if (M > 0) {
    const int kk = min(k, M);
    int equal;
    unsigned* hist = reinterpret_cast<unsigned*>(scratch);
    tau = cached ? radix_kth(CachedBits{bits}, M, kk, hist, lane, &below,
                             &equal)
                 : radix_kth(BandFlat<Band>{band, rule, off, p0}, M, kk, hist,
                             lane, &below, &equal);
    n = found_count(tau, below, kk);
  }
  // compaction in (j, p) order: the keys carry i = j*band + p
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(scratch);
  int base = 0, eq_left = n - below;
  for (int j = 0; j < NINE && base < n; ++j) {
    const auto s = band.seg(j);
    const int a = off[j], len = off[j + 1] - a, pj = p0[j];
    for (int u = 0; u < len && base < n; u += 32) {
      const int t = u + lane;
      unsigned v = ~0u;
      if (t < len) v = cached ? bits[a + t] : rule(j, s, pj + t);
      compact_group(v, static_cast<unsigned>(j * bandw + pj + t), tau, lane,
                    keys, base, eq_left);
    }
  }
  __syncwarp();
  warp_sort(keys, n, lane);
  const float missing = __fsqrt_rn(SENT);
  for (int j = lane; j < k; j += 32) {
    float d = missing;
    int r = rule.bs[0];
    if (j < n) {
      const int i = key_pos(keys[j]);
      const int jb = i / bandw;
      r = rule.bs[jb] + (i - jb * bandw);
      d = key_dist(keys[j]);
    }
    dist[j] = d;
    rows[j] = r;
  }
  __syncwarp();
}

// The block's set-up, every thread of it (8 warps): the band starts sbs,
// pre[c] = computed slots of the cells before c, the hull of each band's
// runs (slo, shi; start[j] its tile index), the tile staged where the hulls
// fit it (returns whether they do), every slot's cover and the padding
// slots' fill. Ends with a barrier.
__device__ __forceinline__ bool band_prologue(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const int* __restrict__ bs,
    const int* __restrict__ rs_rel, const int* __restrict__ run_len,
    const float* __restrict__ qpts, const float* __restrict__ lo_edge,
    const float* __restrict__ hi_edge, const int* __restrict__ counts,
    float* __restrict__ dist, int* __restrict__ rows,
    float* __restrict__ cover, int npad, int k, int bc, int cap, int bandw,
    int* sbs, int* slo, int* shi, int* start, int* pre, float* tx, float* ty,
    float* tz) {
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int Q = bc * cap;
  if (tid < NINE) {
    sbs[tid] = bs[b * NINE + tid];
    slo[tid] = bandw;
    shi[tid] = 0;
  }
  // pre[c] = computed slots of the cells before c (warp 0, 32 cells a step)
  if (warp == 0) {
    int carry = 0;
    for (int c0 = 0; c0 < bc; c0 += 32) {
      const int c = c0 + lane;
      int cnt = 0;
      if (c < bc)
        cnt = counts ? min(max(counts[b * bc + c], 0), cap) : cap;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      if (c < bc) pre[c + 1] = carry + incl;
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();
  // the hull of each band's runs over the cells with a computed slot
  for (int e = tid; e < bc * NINE; e += blockDim.x) {
    const int c = e / NINE, j = e - c * NINE;
    if (pre[c + 1] > pre[c]) {
      const size_t ce = (b * bc + c) * NINE + j;
      const int r = rs_rel[ce];
      const int lo = max(r, 0), hi = min(r + run_len[ce], bandw);
      if (hi > lo) {
        atomicMin(&slo[j], lo);
        atomicMax(&shi[j], hi);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int j = 0; j < NINE; ++j) {
      start[j] = t;
      t += max(shi[j] - slo[j], 0);
    }
    start[NINE] = t;
  }
  __syncthreads();
  const bool staged = start[NINE] <= TILE;
  if (staged) {
    for (int j = 0; j < NINE; ++j) {
      const int t0 = start[j], len = start[j + 1] - t0;
      const long long g0 = static_cast<long long>(sbs[j]) + slo[j];
      for (int t = tid; t < len; t += blockDim.x) {
        const long long g = g0 + t;
        const bool in = g >= 0 && g < npad;
        tx[t0 + t] = in ? px[g] : 0.f;
        ty[t0 + t] = in ? py[g] : 0.f;
        tz[t0 + t] = in ? pz[g] : 0.f;
      }
    }
  }
  // every slot's cover
  for (int s = tid; s < Q; s += blockDim.x) {
    const int c = s / cap;
    const size_t cell = b * bc + c;
    const size_t qi = b * Q + s;
    const float qx = qpts[qi * 3], qy = qpts[qi * 3 + 1], qz = qpts[qi * 3 + 2];
    const float* lo = lo_edge + cell * 3;
    const float* hi = hi_edge + cell * 3;
    cover[qi] = fminf(fminf(fminf(__fsub_rn(qx, lo[0]), __fsub_rn(hi[0], qx)),
                            fminf(__fsub_rn(qy, lo[1]), __fsub_rn(hi[1], qy))),
                      fminf(__fsub_rn(qz, lo[2]), __fsub_rn(hi[2], qz)));
  }
  // the padding slots of each cell are contiguous in the outputs: the fill
  const float missing = __fsqrt_rn(SENT);
  for (int c = warp; c < bc; c += W) {
    const size_t s0 = b * Q + static_cast<size_t>(c) * cap;
    const size_t e1 = (s0 + cap) * k;
    for (size_t e = (s0 + pre[c + 1] - pre[c]) * k + lane; e < e1; e += 32) {
      dist[e] = missing;
      rows[e] = sbs[0];
    }
  }
  __syncthreads();   // the tile is staged
  return staged;
}

template <int SCR>
__global__ void __launch_bounds__(BAND_WARPS * 32)
band_select_kernel(const float* __restrict__ px,
                   const float* __restrict__ py,
                   const float* __restrict__ pz,
                   const int* __restrict__ bs,          // (NB,9)
                   const int* __restrict__ rs_rel,      // (NB,bc,9)
                   const int* __restrict__ run_len,     // (NB,bc,9)
                   const float* __restrict__ qpts,      // (NB,Q,3)
                   const int* __restrict__ qrow_base,   // (NB,bc)
                   const float* __restrict__ lo_edge,   // (NB,bc,3)
                   const float* __restrict__ hi_edge,   // (NB,bc,3)
                   const int* __restrict__ counts,      // (NB,bc) or null
                   float* __restrict__ dist,            // (S,k)
                   int* __restrict__ rows,              // (S,k)
                   float* __restrict__ cover,           // (S,)
                   int npad, int k, int bc, int cap, int bandw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sbs[NINE], slo[NINE], shi[NINE], start[NINE + 1];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const size_t b = blockIdx.x;
  const int Q = bc * cap;
  unsigned char* scratch = smem + warp * SCR;
  unsigned* bits = reinterpret_cast<unsigned*>(smem + W * SCR) + warp * BITS;
  float* tx = reinterpret_cast<float*>(smem + W * (SCR + BITS * 4));
  float* ty = tx + TILE;
  float* tz = ty + TILE;
  int* seg = reinterpret_cast<int*>(tz + TILE) + warp * SEG;
  int* pre = reinterpret_cast<int*>(tz + TILE) + W * SEG;   // (bc+1,)

  const bool staged = band_prologue(px, py, pz, bs, rs_rel, run_len, qpts,
                                    lo_edge, hi_edge, counts, dist, rows,
                                    cover, npad, k, bc, cap, bandw, sbs, slo,
                                    shi, start, pre, tx, ty, tz);

  for (int r = warp; r < pre[bc]; r += W) {
    int c = 0, hi = bc - 1;   // the cell of computed slot r
    while (c < hi) {
      const int mid = (c + hi + 1) >> 1;
      if (pre[mid] <= r) c = mid;
      else hi = mid - 1;
    }
    const int slot = r - pre[c];
    const size_t cell = b * bc + c;
    const size_t qi = b * Q + static_cast<size_t>(c) * cap + slot;
    // the query's 9 runs: off[j] (prefix of run lengths), p0[j]
    int len = 0, p0 = 0;
    if (lane < NINE) {
      const int rr = rs_rel[cell * NINE + lane];
      p0 = max(rr, 0);
      len = max(min(rr + run_len[cell * NINE + lane], bandw) - p0, 0);
    }
    int incl = len;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane < NINE) {
      seg[1 + lane] = incl;
      seg[10 + lane] = p0;
    }
    if (lane == 0) seg[0] = 0;
    __syncwarp();
    const BandRule rule{sbs, qpts[qi * 3], qpts[qi * 3 + 1], qpts[qi * 3 + 2],
                        qrow_base[cell] + slot};
    if (staged)
      band_query(TileBand{tx, ty, tz, start, slo}, rule, seg, bits, bandw, k,
                 scratch, lane, dist + qi * k, rows + qi * k);
    else
      band_query(GlobalBand{px, py, pz, sbs, npad}, rule, seg, bits, bandw, k,
                 scratch, lane, dist + qi * k, rows + qi * k);
  }
}

// The band's candidates as keys: flat index m < off[9] is position
// p0[j] + (m - off[j]) of band j, concatenated position j * band + p.
struct BandPos {
  const int* off;
  const int* p0;
  int bandw;
  __device__ unsigned operator()(int m) const {
    int j = 0;
#pragma unroll
    for (int jj = 1; jj < NINE; ++jj) j += m >= off[jj];
    return static_cast<unsigned>(j * bandw + p0[j] + m - off[j]);
  }
};

// One computed query slot in the block class: the whole block on its M <=
// 9 * band candidates (bits in the shared slice), knn_warp.cuh's block
// select in (j, p) order, the n <= min(k, M) keys sorted in shared memory;
// its k winners to dist[0, k) and rows[0, k).
template <class Band>
__device__ void band_block_query(const Band& band, const BandRule& rule,
                                 const int* seg, unsigned* bits,
                                 unsigned long long* keys, BlockScratch& s,
                                 int bandw, int k, float* dist, int* rows) {
  const int* off = seg;
  const int* p0 = seg + 10;
  const int M = off[NINE];
  for (int j = 0; j < NINE; ++j) {
    const auto sg = band.seg(j);
    const int a = off[j], len = off[j + 1] - a, pj = p0[j];
    for (int t = threadIdx.x; t < len; t += BLOCK_THREADS)
      bits[a + t] = rule(j, sg, pj + t);
  }
  __syncthreads();
  int n = 0;
  if (M > 0)
    n = block_select<true>(CachedBits{bits}, BandPos{off, p0, bandw}, M,
                           min(k, M), keys, nullptr, s);
  const float missing = __fsqrt_rn(SENT);
  for (int j = threadIdx.x; j < k; j += BLOCK_THREADS) {
    float d = missing;
    int r = rule.bs[0];
    if (j < n) {
      const unsigned long long key = keys[j];
      const int i = key_pos(key);
      const int jb = i / bandw;
      r = rule.bs[jb] + (i - jb * bandw);
      d = key_dist(key);
    }
    dist[j] = d;
    rows[j] = r;
  }
}

// Dynamic shared bytes of a block-class block: the scratch, the tile, the
// segment table, pre (bc + 1, 16-byte rounded), the bits of 9 * band
// candidates and min(k, 9 * band) sort keys.
size_t band_block_smem_bytes(int bc, int k, int bandw) {
  const int mmax = NINE * bandw;
  return BLOCK_SCRATCH + static_cast<size_t>(3 * TILE) * 4 + SEG * 4 +
         static_cast<size_t>(pitch(bc + 1)) * 4 +
         static_cast<size_t>(pitch(mmax)) * 4 +
         static_cast<size_t>(min(k, mmax)) * 8;
}

// The block class of the band select (k > KWARP): one block per row block,
// the warp kernel's set-up, then the whole block on one computed query slot
// at a time.
__global__ void __launch_bounds__(BLOCK_THREADS)
band_block_kernel(const float* __restrict__ px,
                  const float* __restrict__ py,
                  const float* __restrict__ pz,
                  const int* __restrict__ bs,          // (NB,9)
                  const int* __restrict__ rs_rel,      // (NB,bc,9)
                  const int* __restrict__ run_len,     // (NB,bc,9)
                  const float* __restrict__ qpts,      // (NB,Q,3)
                  const int* __restrict__ qrow_base,   // (NB,bc)
                  const float* __restrict__ lo_edge,   // (NB,bc,3)
                  const float* __restrict__ hi_edge,   // (NB,bc,3)
                  const int* __restrict__ counts,      // (NB,bc) or null
                  float* __restrict__ dist,            // (S,k)
                  int* __restrict__ rows,              // (S,k)
                  float* __restrict__ cover,           // (S,)
                  int npad, int k, int bc, int cap, int bandw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sbs[NINE], slo[NINE], shi[NINE], start[NINE + 1];
  BlockScratch& s = *reinterpret_cast<BlockScratch*>(smem);
  float* tx = reinterpret_cast<float*>(smem + BLOCK_SCRATCH);
  float* ty = tx + TILE;
  float* tz = ty + TILE;
  int* seg = reinterpret_cast<int*>(tz + TILE);
  int* pre = seg + SEG;                                       // (bc+1,)
  unsigned* bits = reinterpret_cast<unsigned*>(pre + pitch(bc + 1));
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(bits + pitch(NINE * bandw));
  const size_t b = blockIdx.x;
  const int Q = bc * cap, lane = threadIdx.x & 31;

  const bool staged = band_prologue(px, py, pz, bs, rs_rel, run_len, qpts,
                                    lo_edge, hi_edge, counts, dist, rows,
                                    cover, npad, k, bc, cap, bandw, sbs, slo,
                                    shi, start, pre, tx, ty, tz);
  for (int r = 0; r < pre[bc]; ++r) {
    int c = 0, hi = bc - 1;   // the cell of computed slot r
    while (c < hi) {
      const int mid = (c + hi + 1) >> 1;
      if (pre[mid] <= r) c = mid;
      else hi = mid - 1;
    }
    const int slot = r - pre[c];
    const size_t cell = b * bc + c;
    const size_t qi = b * Q + static_cast<size_t>(c) * cap + slot;
    __syncthreads();   // the last query's segment table is read
    if (threadIdx.x < 32) {   // the query's 9 runs: off[j], p0[j]
      int len = 0, p0 = 0;
      if (lane < NINE) {
        const int rr = rs_rel[cell * NINE + lane];
        p0 = max(rr, 0);
        len = max(min(rr + run_len[cell * NINE + lane], bandw) - p0, 0);
      }
      int incl = len;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane < NINE) {
        seg[1 + lane] = incl;
        seg[10 + lane] = p0;
      }
      if (lane == 0) seg[0] = 0;
    }
    __syncthreads();
    const BandRule rule{sbs, qpts[qi * 3], qpts[qi * 3 + 1], qpts[qi * 3 + 2],
                        qrow_base[cell] + slot};
    if (staged)
      band_block_query(TileBand{tx, ty, tz, start, slo}, rule, seg, bits,
                       keys, s, bandw, k, dist + qi * k, rows + qi * k);
    else
      band_block_query(GlobalBand{px, py, pz, sbs, npad}, rule, seg, bits,
                       keys, s, bandw, k, dist + qi * k, rows + qi * k);
  }
}

// The kernel of one scratch class, or the block class past KWARP; raises
// its shared-memory limit to BAND_BUDGET on first use and refuses a block
// whose bytes exceed it (more than ~24,000 cells a block; a grid row holds
// at most 1024).
template <int SCR>
int launch_band(const float* px, const float* py, const float* pz,
                const int* bs, const int* rs_rel, const int* run_len,
                const float* qpts, const int* qrow_base, const float* lo,
                const float* hi, const int* counts, float* dist, int* rows,
                float* cover, int nb, int npad, int k, int bc, int cap,
                int band, cudaStream_t s) {
  static bool raised = false;   // above 48 KB needs the attribute
  const size_t bytes = SCR ? band_smem_bytes(bc, SCR)
                           : band_block_smem_bytes(bc, k, band);
  if (bytes > BAND_BUDGET) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (SCR == 0) {
    const int e = raise_smem(band_block_kernel, BAND_BUDGET, raised);
    if (e) return e;
    band_block_kernel<<<nb, BLOCK_THREADS, bytes, s>>>(
        px, py, pz, bs, rs_rel, run_len, qpts, qrow_base, lo, hi, counts,
        dist, rows, cover, npad, k, bc, cap, band);
  } else {
    const int e = raise_smem(band_select_kernel<SCR>, BAND_BUDGET, raised);
    if (e) return e;
    band_select_kernel<SCR><<<nb, BAND_WARPS * 32, bytes, s>>>(
        px, py, pz, bs, rs_rel, run_len, qpts, qrow_base, lo, hi, counts,
        dist, rows, cover, npad, k, bc, cap, band);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 = launched).
// Shapes: px/py/pz (npad,) float32; bs (nb,9), rs_rel/run_len (nb,bc,9),
// qrow_base (nb,bc) int32; qpts (nb,bc*cap,3), lo/hi (nb,bc,3) float32;
// counts (nb,bc) int32 or null (every slot computed); outputs dist (S,k)
// float32, rows (S,k) int32, cover (S,) float32 with S = nb*bc*cap; all
// contiguous. Require k >= 1, bc >= 1, cap >= 1 and 1 <= band <= 1024
// (checked by the wrapper).
extern "C" int pct_band_select(const float* px, const float* py,
                               const float* pz, const int* bs,
                               const int* rs_rel, const int* run_len,
                               const float* qpts, const int* qrow_base,
                               const float* lo, const float* hi,
                               const int* counts, float* dist, int* rows,
                               float* cover, int nb, int npad, int k, int bc,
                               int cap, int band, void* stream) {
  if (nb <= 0) return 0;
  if (k < 1 || bc < 1 || cap < 1 || band < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > KWARP)
    return launch_band<0>(px, py, pz, bs, rs_rel, run_len, qpts, qrow_base,
                          lo, hi, counts, dist, rows, cover, nb, npad, k, bc,
                          cap, band, s);
  switch (scratch_bytes(k)) {
    case SCRATCH:
      return launch_band<SCRATCH>(px, py, pz, bs, rs_rel, run_len, qpts,
                                  qrow_base, lo, hi, counts, dist, rows,
                                  cover, nb, npad, k, bc, cap, band, s);
    case 2048:
      return launch_band<2048>(px, py, pz, bs, rs_rel, run_len, qpts,
                               qrow_base, lo, hi, counts, dist, rows, cover,
                               nb, npad, k, bc, cap, band, s);
    case 4096:
      return launch_band<4096>(px, py, pz, bs, rs_rel, run_len, qpts,
                               qrow_base, lo, hi, counts, dist, rows, cover,
                               nb, npad, k, bc, cap, band, s);
    default:
      return launch_band<8192>(px, py, pz, bs, rs_rel, run_len, qpts,
                               qrow_base, lo, hi, counts, dist, rows, cover,
                               nb, npad, k, bc, cap, band, s);
  }
}
