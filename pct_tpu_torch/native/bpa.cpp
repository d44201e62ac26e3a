// Ball-Pivoting surface reconstruction (first-party C++).
//
// The port's own copy of the JAX package's native/bpa.cpp, with the same
// C ABI (bpa_reconstruct, bpa_reconstruct_passes, bpa_free): the one
// sequential, host-bound stage of the mesh path, replacing Open3D's
// create_from_point_cloud_ball_pivoting (ref utils.py:94).
// Bernardini et al. 1999: roll a ball of radius r over the cloud; each
// stable 3-point contact is a triangle; pivot around front edges to
// grow the surface. Multi-radius: retry remaining front edges with the
// next (larger) radius, as Open3D does with its radii list.
//
// Exposed as a flat C ABI, loaded with ctypes
// (pct_tpu_torch/mesh/reconstruct.py builds it with g++ at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <queue>
#include <unordered_map>
#include <vector>

// Optional section timers: compile with -DBPA_PROF and call
// bpa_prof_print() after bpa_reconstruct. Zero overhead when off.
#ifdef BPA_PROF
#include <cstdio>
#include <x86intrin.h>
namespace bpaprof {
unsigned long long t_pivot, n_pivot, t_empty, n_empty, t_seed, n_seed,
    t_build, n_center, n_cand;
struct Scoped {
  unsigned long long* acc;
  unsigned long long t0;
  explicit Scoped(unsigned long long* a) : acc(a), t0(__rdtsc()) {}
  ~Scoped() { *acc += __rdtsc() - t0; }
};
}  // namespace bpaprof
#define BPA_PROF_SCOPE(acc) bpaprof::Scoped _bpa_scope_(&bpaprof::acc)
#define BPA_PROF_COUNT(c) (++bpaprof::c)
#define BPA_PROF_ADD(c, v) (bpaprof::c += (v))
#else
#define BPA_PROF_SCOPE(acc) ((void)0)
#define BPA_PROF_COUNT(c) ((void)0)
#define BPA_PROF_ADD(c, v) ((void)0)
#endif

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float norm2(V3 a) { return dot(a, a); }
static inline float norm(V3 a) { return std::sqrt(norm2(a)); }
static inline V3 normalize(V3 a) {
  float n = norm(a);
  return n > 1e-20f ? a * (1.0f / n) : V3{0, 0, 1};
}

// ---------------- spatial grid (dense 3D, CSR layout) ----------------
// Counting-sort point ids into contiguous per-cell ranges: one uint32
// offsets table + SoA coordinate arrays in cell order. vs a
// vector-of-vectors: no per-cell allocations, contiguous scans the
// distance loops stream 8-wide, and an O(n + #cells) rebuild per
// radius rung. Cells along x are adjacent in the layout, so a box
// query's (z,y) row is ONE contiguous [b,e) range.
struct Grid {
  float cell;
  V3 origin;
  int nx, ny, nz;
  std::vector<uint32_t> off;  // #cells + 1 prefix offsets into the SoA
  std::vector<int32_t> ids;   // point ids grouped by cell
  std::vector<float> sx, sy, sz;  // coords in cell order as SoA

  void build(const std::vector<V3>& pts, float cell_size) {
    cell = cell_size;
    V3 lo = pts[0], hi = pts[0];
    for (const auto& p : pts) {
      lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
      hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
    }
    origin = lo - V3{cell, cell, cell} * 0.5f;
    nx = std::max(1, (int)((hi.x - origin.x) / cell) + 2);
    ny = std::max(1, (int)((hi.y - origin.y) / cell) + 2);
    nz = std::max(1, (int)((hi.z - origin.z) / cell) + 2);
    // cap the table so degenerate clouds don't explode memory (a finer
    // 128-cells/point cap was measured SLOWER at 1M: the rung-0 table
    // rebuild and off[] cache misses cost more than the scan savings)
    while ((long long)nx * ny * nz > (1LL << 24)) {
      cell *= 2.0f;
      nx = std::max(1, (int)((hi.x - origin.x) / cell) + 2);
      ny = std::max(1, (int)((hi.y - origin.y) / cell) + 2);
      nz = std::max(1, (int)((hi.z - origin.z) / cell) + 2);
    }
    size_t ncells = (size_t)nx * ny * nz;
    off.assign(ncells + 1, 0);
    for (const auto& p : pts) ++off[index_of(p) + 1];
    for (size_t c = 0; c < ncells; ++c) off[c + 1] += off[c];
    ids.resize(pts.size());
    sx.resize(pts.size());
    sy.resize(pts.size());
    sz.resize(pts.size());
    std::vector<uint32_t> cur(off.begin(), off.end() - 1);
    for (int i = 0; i < (int)pts.size(); ++i) {
      uint32_t slot = cur[index_of(pts[i])]++;
      ids[slot] = i;
      sx[slot] = pts[i].x;
      sy[slot] = pts[i].y;
      sz[slot] = pts[i].z;
    }
  }

  size_t index_of(V3 p) const {
    int ix = std::min(nx - 1, std::max(0, (int)((p.x - origin.x) / cell)));
    int iy = std::min(ny - 1, std::max(0, (int)((p.y - origin.y) / cell)));
    int iz = std::min(nz - 1, std::max(0, (int)((p.z - origin.z) / cell)));
    return ((size_t)iz * ny + iy) * nx + ix;
  }

  // Scan box around p covering |Δcoord| <= radius. ceil: |Δcoord| <=
  // radius implies |Δindex| <= ceil(radius/cell) (floor+1 scanned 7^3
  // cells for the pivot's 2r search where 5^3 suffice, and 5^3 for
  // ball_empty's r where 3^3 do).
  template <class FRow>
  void for_rows(V3 p, float radius, FRow&& frow) const {
    int r = (int)std::ceil(radius / cell);
    int ix = (int)((p.x - origin.x) / cell);
    int iy = (int)((p.y - origin.y) / cell);
    int iz = (int)((p.z - origin.z) / cell);
    int zlo = std::max(iz - r, 0), zhi = std::min(iz + r, nz - 1);
    int ylo = std::max(iy - r, 0), yhi = std::min(iy + r, ny - 1);
    int xlo = std::max(ix - r, 0), xhi = std::min(ix + r, nx - 1);
    for (int z = zlo; z <= zhi; ++z)
      for (int y = ylo; y <= yhi; ++y) {
        size_t row = ((size_t)z * ny + y) * nx;
        uint32_t b = off[row + xlo], e = off[row + xhi + 1];
        if (b < e && frow(b, e)) return;
      }
  }

  // any point with d2(p, c) < lim, excluding ids i1/i2/i3?  Branch-free
  // masked sum per row — the compiler vectorizes the SoA loop 8-wide.
  bool any_inside(V3 c, float radius, float lim, int i1, int i2,
                  int i3) const {
    const float* px = sx.data();
    const float* py = sy.data();
    const float* pz = sz.data();
    const int32_t* pid = ids.data();
    bool hit = false;
    for_rows(c, radius, [&](uint32_t b, uint32_t e) {
      int hits = 0;  // int sum-reduction: gcc vectorizes this where a
                     // float min-reduction is left scalar
      for (uint32_t t = b; t < e; ++t) {
        float dx = px[t] - c.x, dy = py[t] - c.y, dz = pz[t] - c.z;
        float d2 = dx * dx + dy * dy + dz * dz;
        bool skip = pid[t] == i1 || pid[t] == i2 || pid[t] == i3;
        hits += (d2 < lim) & !skip;
      }
      hit = hits > 0;
      return hit;  // short-circuit remaining rows
    });
    return hit;
  }

  // call f(id, pos, d2) for points with d2(p, c) < lim2 — a predictable
  // mostly-false branch over the contiguous SoA rows.
  template <class F>
  void scan_ball(V3 c, float radius, float lim2, F&& f) const {
    const float* px = sx.data();
    const float* py = sy.data();
    const float* pz = sz.data();
    for_rows(c, radius, [&](uint32_t b, uint32_t e) {
      for (uint32_t t = b; t < e; ++t) {
        float dx = px[t] - c.x, dy = py[t] - c.y, dz = pz[t] - c.z;
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < lim2) f(ids[t], V3{px[t], py[t], pz[t]}, d2);
      }
      return false;
    });
  }
};

// ---------------- flat edge-use table ----------------
// Open-addressing (linear probe) map keyed by ekey(a,b) = (hi<<32)|lo
// with hi > lo >= 0, so a real key is never 0 and 0 marks empty slots.
// Replaces std::unordered_map on the hot path: no node allocations, no
// pointer chases — at 1M points the map holds ~5M entries and the
// node-based probes were DRAM-latency-bound.
struct EdgeMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  size_t mask = 0, count = 0;

  void init(size_t expect) {
    size_t cap = 64;
    while (cap < expect * 2) cap <<= 1;
    keys.assign(cap, 0);
    vals.assign(cap, 0);
    mask = cap - 1;
    count = 0;
  }
  static inline size_t hashk(uint64_t k) {
    k ^= k >> 33; k *= 0xff51afd7ed558ccdULL; k ^= k >> 33;
    return (size_t)k;
  }
  void grow() {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<int32_t> ov = std::move(vals);
    keys.assign(ok.size() * 2, 0);
    vals.assign(ov.size() * 2, 0);
    mask = keys.size() - 1;
    for (size_t j = 0; j < ok.size(); ++j)
      if (ok[j]) {
        size_t i = hashk(ok[j]) & mask;
        while (keys[i]) i = (i + 1) & mask;
        keys[i] = ok[j];
        vals[i] = ov[j];
      }
  }
  int32_t& slot(uint64_t k) {
    if (count * 2 >= keys.size()) grow();
    size_t i = hashk(k) & mask;
    while (keys[i] != 0 && keys[i] != k) i = (i + 1) & mask;
    if (keys[i] == 0) { keys[i] = k; ++count; }
    return vals[i];
  }
  int get(uint64_t k) const {  // use count; 0 when absent
    size_t i = hashk(k) & mask;
    while (keys[i] != 0) {
      if (keys[i] == k) return vals[i];
      i = (i + 1) & mask;
    }
    return 0;
  }
};

// ---------------- BPA state ----------------
enum PState : uint8_t { ORPHAN = 0, FRONT = 1, INSIDE = 2 };

struct Edge {
  int a, b, opposite;
  V3 center;  // ball center of the triangle this edge came from
};

struct BPA {
  const std::vector<V3>& pts;
  const std::vector<V3>& nrm;
  Grid grid;
  std::vector<uint8_t> state;
  std::vector<int32_t> tris;
  // directed-edge bookkeeping: key = (min,max); value: #times used
  EdgeMap edge_uses;
  std::deque<Edge> front;
  float r;

  BPA(const std::vector<V3>& p, const std::vector<V3>& n)
      : pts(p), nrm(n), state(p.size(), ORPHAN) {
    // ~3 edges/point on a closed surface; pre-size so the hot loop
    // never pays a rehash storm (measured: seconds at 1M points)
    edge_uses.init(4 * p.size());
    tris.reserve(7 * p.size());
  }

  static uint64_t ekey(int a, int b) {
    uint32_t lo = (uint32_t)std::min(a, b), hi = (uint32_t)std::max(a, b);
    return ((uint64_t)hi << 32) | lo;
  }

  // ball center touching p1,p2,p3 with radius r, on the side agreeing with
  // the vertex normals; returns false if the ball doesn't fit
  bool ball_center(int i1, int i2, int i3, V3* out) const {
    V3 p1 = pts[i1], p2 = pts[i2], p3 = pts[i3];
    V3 e1 = p2 - p1, e2 = p3 - p1;
    V3 nt = cross(e1, e2);
    float nt2 = norm2(nt);
    if (nt2 < 1e-24f) return false;  // degenerate triangle
    // circumcenter (relative to p1)
    V3 cc = (cross(nt, e1) * norm2(e2) + cross(e2, nt) * norm2(e1)) * (0.5f / nt2);
    float rc2 = norm2(cc);
    float h2 = r * r - rc2;
    if (h2 <= 0) return false;  // circumradius exceeds ball radius
    V3 nhat = normalize(nt);
    // orient with the average vertex normal
    V3 avg = nrm[i1] + nrm[i2] + nrm[i3];
    if (dot(nhat, avg) < 0) nhat = nhat * -1.0f;
    *out = p1 + cc + nhat * std::sqrt(h2);
    return true;
  }

  bool ball_empty(V3 c, int i1, int i2, int i3) const {
    BPA_PROF_SCOPE(t_empty);
    BPA_PROF_COUNT(n_empty);
    float lim = r * r * (1.0f - 1e-4f);
    return !grid.any_inside(c, r, lim, i1, i2, i3);
  }

  bool normals_compatible(int i1, int i2, int i3) const {
    V3 nt = cross(pts[i2] - pts[i1], pts[i3] - pts[i1]);
    V3 avg = nrm[i1] + nrm[i2] + nrm[i3];
    return std::fabs(dot(normalize(nt), normalize(avg))) > 0.1f ||
           norm2(avg) < 1e-12f;
  }

  void emit(int a, int b, int c, V3 center) {
    // wind so the triangle normal agrees with the ball side
    V3 nt = cross(pts[b] - pts[a], pts[c] - pts[a]);
    V3 mid = (pts[a] + pts[b] + pts[c]) * (1.0f / 3.0f);
    if (dot(nt, center - mid) < 0) std::swap(b, c);
    tris.push_back(a); tris.push_back(b); tris.push_back(c);
    state[a] = state[b] = state[c] = INSIDE;
    push_edge(a, b, c, center);
    push_edge(b, c, a, center);
    push_edge(c, a, b, center);
  }

  void push_edge(int a, int b, int opp, V3 center) {
    int32_t& uses = edge_uses.slot(ekey(a, b));
    ++uses;
    if (uses == 1) front.push_back({a, b, opp, center});
  }

  bool edge_open(int a, int b) const {
    return edge_uses.get(ekey(a, b)) == 1;
  }

  // try to find a seed triangle among unused points.
  //
  // seed_cursor: within one radius pass the seeding outcome for a point
  // is static (positions/normals never change; state only transitions
  // ORPHAN -> INSIDE), so a point that failed once fails for the rest
  // of the pass — resume scanning where the last seed search stopped
  // instead of from 0. Without this, S components cost O(S*n) rescans
  // (measured: the 1M torus spent ~15 min mostly here).
  int seed_cursor = 0;

  bool find_seed() {
    BPA_PROF_SCOPE(t_seed);
    BPA_PROF_COUNT(n_seed);
    for (int& i = seed_cursor; i < (int)pts.size(); ++i) {
      if (state[i] != ORPHAN) continue;
      // candidate ids + LOCAL coordinate copies: the pair loop's chord
      // tests then read contiguous stack data instead of re-gathering
      // pts[] (cache-miss-bound at 1M points), and the seed cap sorts
      // on the scan's already-computed center distance
      std::vector<int> cand;
      std::vector<V3> cpos;
      std::vector<float> cd2;
      grid.scan_ball(pts[i], 2 * r, 4 * r * r, [&](int idx, V3 p, float d2) {
        if (idx != i) {
          cand.push_back(idx);
          cpos.push_back(p);
          cd2.push_back(d2);
        }
      });
      // a valid seed triangle has circumradius <= r, so its two other
      // vertices are almost always among the nearest points; bound the
      // O(|cand|^2) pair loop by trying the nearest pairs first (dense
      // regions at the ladder's large radii otherwise see |cand| in the
      // thousands). Below the cap the pair loop keeps grid order: a
      // full nearest-first sort was measured to seed sliver triangles
      // on the dupin cyclide (F/V 1.62 -> 1.42).
      constexpr size_t kSeedCap = 64;
      if (cand.size() > kSeedCap) {
        std::vector<int> perm(cand.size());
        for (size_t t = 0; t < perm.size(); ++t) perm[t] = (int)t;
        std::partial_sort(perm.begin(), perm.begin() + kSeedCap, perm.end(),
                          [&](int x, int y) { return cd2[x] < cd2[y]; });
        std::vector<int> c2(kSeedCap);
        std::vector<V3> p2(kSeedCap);
        for (size_t t = 0; t < kSeedCap; ++t) {
          c2[t] = cand[perm[t]];
          p2[t] = cpos[perm[t]];
        }
        cand.swap(c2);
        cpos.swap(p2);
      }
      // side (j,k) longer than the ball diameter forces circumradius > r
      // (ball_center would reject): cull pairs on the squared chord
      // before the normal/center/empty checks — the pair loop is the
      // seed stage's hot spot at the small rungs
      float side2 = 4.0f * r * r * (1.0f + 1e-5f);
      for (size_t a = 0; a < cand.size(); ++a) {
        for (size_t b = a + 1; b < cand.size(); ++b) {
          if (norm2(cpos[a] - cpos[b]) > side2) continue;
          int j = cand[a], k = cand[b];
          V3 c;
          if (!ball_center(i, j, k, &c)) continue;
          if (!normals_compatible(i, j, k)) continue;
          if (!ball_empty(c, i, j, k)) continue;
          emit(i, j, k, c);
          return true;
        }
      }
    }
    return false;
  }

  // pivot candidate buffer, reused across calls (no per-pivot allocs)
  struct Cand {
    float ang;
    int id;
    V3 c;
  };
  std::vector<Cand> cands;

  // pivot the ball around front edge e; returns contact point or -1.
  //
  // Two-phase: collect every geometric contact with its rolling angle,
  // sort by (angle, id), then run the expensive validity checks
  // (normal compatibility, empty-ball scan) best-first and stop at the
  // first pass. The winner is the min-(angle,id) candidate among those
  // passing both checks — the same argmin the previous incremental
  // walk computed, but ~1 ball_empty per pivot instead of one per
  // running-best improvement (measured ~2.4x at 1M points).
  int pivot(const Edge& e, V3* new_center) {
    BPA_PROF_SCOPE(t_pivot);
    BPA_PROF_COUNT(n_pivot);
    V3 a = pts[e.a], b = pts[e.b];
    V3 m = (a + b) * 0.5f;
    V3 u = normalize(b - a);
    V3 v0 = e.center - m;
    v0 = v0 - u * dot(v0, u);  // component ⊥ edge
    float v0n = norm(v0);
    if (v0n < 1e-12f) return -1;
    V3 v0h = v0 * (1.0f / v0n);
    V3 wdir = cross(u, v0h);  // completes right-handed frame (u, v0h, wdir)

    float search = 2.0f * r;
    // any contact x satisfies |x-m| <= |x-c'| + |c'-m| = r + sqrt(r^2 -
    // |ab|^2/4) <= 2r — reject the scan cube's corners (~10x the ball's
    // volume) in the vectorized distance pass before ball_center
    float lim2 = 4.0f * r * r * (1.0f + 1e-5f);
    // a triangle side longer than the ball diameter forces circumradius
    // > r, so ball_center would reject — cull on the squared sides
    // first (conservative epsilon: never rejects a fitting ball)
    float side2 = 4.0f * r * r * (1.0f + 1e-5f);
    cands.clear();
    grid.scan_ball(m, search, lim2, [&](int x, V3 px, float) {
      BPA_PROF_COUNT(n_cand);
      if (x == e.a || x == e.b || x == e.opposite) return;
      if (norm2(px - a) > side2 || norm2(px - b) > side2) return;
      BPA_PROF_COUNT(n_center);
      // interior points may be re-glued; non-manifold overuse is rejected
      // by the edge_uses >= 2 checks in run()
      V3 c;
      if (!ball_center(e.a, e.b, x, &c)) return;
      V3 w = c - m;
      w = w - u * dot(w, u);
      float wy = dot(w, v0h), wx = dot(w, wdir);
      // rolling direction: away from the old triangle = positive wdir side
      float ang = std::atan2(wx, wy);           // 0 at current center
      if (ang <= 1e-6f) ang += 2.0f * (float)M_PI;
      cands.push_back({ang, x, c});
    });
    // (angle, id) lexicographic: exact float-angle ties (symmetric
    // contacts at the large rungs) resolve by point id, making the
    // winner a function of the candidate set alone
    std::sort(cands.begin(), cands.end(), [](const Cand& p, const Cand& q) {
      return p.ang < q.ang || (p.ang == q.ang && p.id < q.id);
    });
    for (const Cand& cd : cands) {
      if (!normals_compatible(e.a, e.b, cd.id)) continue;
      if (!ball_empty(cd.c, e.a, e.b, cd.id)) continue;
      *new_center = cd.c;
      return cd.id;
    }
    return -1;
  }

  void run(float radius) {
    r = radius;
    seed_cursor = 0;  // a larger ball can seed points that failed before
    {
      BPA_PROF_SCOPE(t_build);
      grid.build(pts, std::max(radius, 1e-6f));
    }
    // resume: re-activate open edges from earlier (smaller-radius) passes
    std::deque<Edge> carried = std::move(front);
    front.clear();
    for (auto& e : carried)
      if (edge_open(e.a, e.b)) front.push_back(e);

    while (true) {
      while (!front.empty()) {
        Edge e = front.front();
        front.pop_front();
        if (!edge_open(e.a, e.b)) continue;
        V3 c;
        int x = pivot(e, &c);
        if (x < 0) continue;  // boundary edge (for this radius)
        // adding triangle (a, b, x): the shared edge gets its 2nd use
        if (!edge_open(e.a, e.b)) continue;
        // avoid non-manifold overuse of the new edges
        if (edge_uses.get(ekey(e.a, x)) >= 2 ||
            edge_uses.get(ekey(e.b, x)) >= 2)
          continue;
        ++edge_uses.slot(ekey(e.a, e.b));  // now closed
        emit_pivot(e.a, e.b, x, c);
      }
      if (!find_seed()) break;
    }
#ifdef BPA_PROF
    std::printf(
        "  rung r=%g: seeds+%llu Gcyc(seed)=%.2f Gcyc(pivot)=%.2f "
        "Gcyc(empty)=%.2f faces=%zu\n",
        r, bpaprof::n_seed, bpaprof::t_seed * 1e-9, bpaprof::t_pivot * 1e-9,
        bpaprof::t_empty * 1e-9, tris.size() / 3);
    bpaprof::n_seed = 0;
    bpaprof::t_seed = bpaprof::t_pivot = bpaprof::t_empty = 0;
#endif
  }

  void emit_pivot(int a, int b, int x, V3 center) {
    // orientation handled in emit(); do not re-push the closing edge
    V3 nt = cross(pts[b] - pts[a], pts[x] - pts[a]);
    V3 mid = (pts[a] + pts[b] + pts[x]) * (1.0f / 3.0f);
    int va = a, vb = b;
    if (dot(nt, center - mid) < 0) std::swap(va, vb);
    tris.push_back(va); tris.push_back(vb); tris.push_back(x);
    state[a] = state[b] = state[x] = INSIDE;
    push_edge(a, x, b, center);
    push_edge(b, x, a, center);
  }
};

}  // namespace

extern "C" {

// Returns number of triangles; fills *out (malloc'd, caller frees via
// bpa_free) with t*3 int32 vertex ids. radii must be ascending.
// passes > 1 repeats the whole radius ladder while the mesh still grows:
// the classic single sweep visits each radius once, but gluing done by a
// LATER (larger) rung can unlock seeds and pivots for EARLIER radii —
// front edges carried between rungs are re-activated by run(), and
// seeding outcomes change once neighboring orphans became INSIDE. A
// repeat pass is purely additive (state only moves ORPHAN -> INSIDE,
// edge_uses only grows), so faces from pass 1 are unchanged.
int bpa_reconstruct_passes(const float* points, const float* normals, int n,
                           const float* radii, int n_radii, int passes,
                           int32_t** out) {
  if (n < 3 || n_radii < 1) { *out = nullptr; return 0; }
  std::vector<V3> pts(n), nrm(n);
  std::memcpy(pts.data(), points, sizeof(V3) * n);
  std::memcpy(nrm.data(), normals, sizeof(V3) * n);
  BPA bpa(pts, nrm);
  size_t prev = 0;
  for (int p = 0; p < (passes < 1 ? 1 : passes); ++p) {
    for (int i = 0; i < n_radii; ++i) bpa.run(radii[i]);
    if (bpa.tris.size() == prev) break;  // converged: nothing new grew
    prev = bpa.tris.size();
  }
  int t = (int)(bpa.tris.size() / 3);
  if (t == 0) { *out = nullptr; return 0; }
  *out = (int32_t*)std::malloc(sizeof(int32_t) * bpa.tris.size());
  std::memcpy(*out, bpa.tris.data(), sizeof(int32_t) * bpa.tris.size());
  return t;
}

int bpa_reconstruct(const float* points, const float* normals, int n,
                    const float* radii, int n_radii, int32_t** out) {
  return bpa_reconstruct_passes(points, normals, n, radii, n_radii, 1, out);
}

void bpa_free(int32_t* buf) { std::free(buf); }

#ifdef BPA_PROF
void bpa_prof_print(void) {
  using namespace bpaprof;
  std::printf(
      "bpa_prof: pivot %llu calls %.2fGcyc | ball_empty %llu calls %.2fGcyc "
      "| seed %llu calls %.2fGcyc | build %.2fGcyc | cand %llu center %llu\n",
      n_pivot, t_pivot * 1e-9, n_empty, t_empty * 1e-9, n_seed, t_seed * 1e-9,
      t_build * 1e-9, n_cand, n_center);
}
#endif

}  // extern "C"
