"""Boundary-loop detection and small-hole filling.

The port's own numpy/scipy copy of ``pct_tpu.mesh.boundary``: the same
inputs give the same loops, fills and face lists.

Parity with ref utils.py:407-436 ``detect_boundary_loops`` (edges used
by fewer than 2 triangles are boundary; loops = connected components)
and the hole-fill pass of ``create_mesh_with_curvature``
(ref utils.py:151-232): loops whose perimeter is below
0.5 × mean-bbox-extent are planarity-tested (SVD), projected to their
dominant plane, and triangulated (Delaunay, convex-hull fallback).

Boundary loops are tiny (hundreds of edges at most) — this stays on
host numpy/scipy by design (SURVEY §2 native-replacement table: "host
union-find, fine to keep in Python"); scipy's Qhull handles the small
Delaunay instances exactly as the reference's did.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def boundary_edges(faces: np.ndarray) -> np.ndarray:
    """(T,3) -> (B,2) edges appearing in exactly one face (ref :418-427).

    Edges are packed into ONE int64 key before np.unique: the axis=0
    row-unique sorts void-dtype records, ~4x slower (measured 1.8 of a
    2.9 s hole pass at 300k was that sort)."""
    e = np.concatenate([faces[:, (0, 1)], faces[:, (1, 2)], faces[:, (2, 0)]])
    e = np.sort(e, axis=1)
    key = (e[:, 0].astype(np.int64) << 32) | e[:, 1].astype(np.int64)
    uk, counts = np.unique(key, return_counts=True)
    b = uk[counts < 2]
    return np.stack([b >> 32, b & 0xFFFFFFFF], axis=1).astype(faces.dtype)


def _loop_partition(be: np.ndarray):
    """Partition boundary edges into loops (connected components).

    Returns (loops, edge_loop): loops as sorted vertex-id arrays and
    each boundary edge's loop index. One O(B α(B)) union-find pass over
    index-compressed ids — the previous per-loop ``np.isin`` over the
    full edge set made hole passes O(loops × edges) (measured 46 s for
    8.5k holes on a 300k-point torus; BPA leaves ~1 tiny hole per 35
    points on random samplings, not the "handful of loops" the original
    design assumed).
    """
    verts = np.unique(be)
    a = np.searchsorted(verts, be[:, 0]).astype(np.int64)
    b = np.searchsorted(verts, be[:, 1]).astype(np.int64)
    parent = np.arange(len(verts), dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i in range(len(a)):
        ra, rb = find(int(a[i])), find(int(b[i]))
        if ra != rb:
            parent[ra] = rb
    labels = np.fromiter((find(i) for i in range(len(verts))),
                         np.int64, len(verts))
    _, lab = np.unique(labels, return_inverse=True)
    order = np.argsort(lab, kind="stable")
    splits = np.searchsorted(lab[order], np.arange(1, lab.max() + 1))
    loops = [verts[np.sort(g)] for g in np.split(order, splits)]
    return loops, lab[a]


def detect_boundary_loops(faces: np.ndarray) -> List[np.ndarray]:
    """Connected components of the boundary-edge graph (ref :430-436),
    union-find instead of networkx."""
    be = boundary_edges(faces)
    if be.size == 0:
        return []
    return _loop_partition(be)[0]


def loop_perimeter(vertices: np.ndarray, loop: np.ndarray,
                   faces: np.ndarray,
                   be: np.ndarray | None = None) -> float:
    """Sum of boundary-edge lengths belonging to the loop (ref :170).
    Pass precomputed ``boundary_edges(faces)`` to avoid re-extracting
    the (loop-independent) edge set per loop."""
    if be is None:
        be = boundary_edges(faces)
    sel = np.isin(be[:, 0], loop) & np.isin(be[:, 1], loop)
    e = be[sel]
    return float(np.linalg.norm(vertices[e[:, 0]] - vertices[e[:, 1]],
                                axis=1).sum())


def is_planar(points: np.ndarray, tol: float = 1e-2) -> bool:
    """SVD planarity test (ref utils.py:22-38): smallest singular value of
    the centered cloud below tol × largest."""
    c = points - points.mean(0)
    s = np.linalg.svd(c, compute_uv=False)
    if s[0] <= 0:
        return True
    return bool(s[-1] / s[0] < tol)


def fill_hole(vertices: np.ndarray, loop: np.ndarray) -> np.ndarray:
    """Triangulate one small hole: project the loop onto its dominant
    plane (drop the smallest-variance axis, ref :183-184), Delaunay in
    2D, keep triangles whose vertices are all on the loop; convex-hull
    fan fallback (ref :187-206). Returns (F,3) int64 faces (global ids).
    """
    if loop.size < 3:
        return np.zeros((0, 3), np.int64)
    if loop.size == 3:
        # Delaunay of a triangle is that triangle; skip the Qhull call
        # (3-edge holes dominate BPA output — ~1 ms each adds up)
        return loop[None, :].astype(np.int64)
    pts = vertices[loop]
    c = pts - pts.mean(0)
    _, _, Vt = np.linalg.svd(c, full_matrices=False)
    plane = c @ Vt[:2].T          # project out the normal direction
    try:
        from scipy.spatial import Delaunay

        tri = Delaunay(plane)
        faces = loop[tri.simplices]
    except Exception:
        try:
            from scipy.spatial import ConvexHull

            hull = ConvexHull(plane)
            order = hull.vertices
            fan = [(order[0], order[i], order[i + 1])
                   for i in range(1, len(order) - 1)]
            faces = loop[np.asarray(fan, dtype=np.int64)]
        except Exception:
            return np.zeros((0, 3), np.int64)
    return faces.astype(np.int64)


def order_loop(be: np.ndarray, loop: np.ndarray) -> np.ndarray | None:
    """Walk a loop's boundary edges into an ordered vertex cycle.

    Returns None when the loop is not a simple cycle (some vertex has
    != 2 boundary edges — e.g. two holes sharing a vertex)."""
    sel = np.isin(be[:, 0], loop) & np.isin(be[:, 1], loop)
    adj: dict = {}
    for a, b in be[sel]:
        adj.setdefault(int(a), []).append(int(b))
        adj.setdefault(int(b), []).append(int(a))
    if len(adj) != loop.size or any(len(v) != 2 for v in adj.values()):
        return None
    start = int(loop[0])
    cyc = [start]
    prev, cur = None, start
    while True:
        nxts = [v for v in adj[cur] if v != prev]
        if not nxts:
            return None
        nxt = nxts[0]
        if nxt == start:
            break
        cyc.append(nxt)
        prev, cur = cur, nxt
        if len(cyc) > loop.size:
            return None
    if len(cyc) != loop.size or len(cyc) < 3:
        return None
    return np.asarray(cyc, dtype=np.int64)


def _min_area_triangulation(P: np.ndarray) -> List[Tuple[int, int, int]]:
    """Minimum-total-area triangulation of an ordered 3D polygon chain
    (classic interval DP, O(L³)) — well-behaved on NON-planar loops
    where a projected Delaunay would fold. The inner argmin runs as one
    numpy vector op per (i, j) span (the scalar form cost ~3 s for a
    single 100-vertex loop)."""
    L = len(P)
    D = P[None, :, :] - P[:, None, :]          # D[i, m] = P[m] - P[i]
    dp = np.zeros((L, L))
    choice = np.zeros((L, L), dtype=np.int64)
    for span in range(2, L):
        for i in range(L - span):
            j = i + span
            m = slice(i + 1, j)
            cr = np.cross(D[i, m], D[i, j])
            areas = 0.5 * np.sqrt((cr * cr).sum(-1))
            cost = dp[i, m] + dp[m, j] + areas
            bm = int(np.argmin(cost))
            dp[i, j] = cost[bm]
            choice[i, j] = i + 1 + bm
    tris: List[Tuple[int, int, int]] = []

    def rec(i, j):
        if j - i < 2:
            return
        m = int(choice[i][j])
        tris.append((i, m, j))
        rec(i, m)
        rec(m, j)

    rec(0, L - 1)
    return tris


def fill_holes_by_size(vertices: np.ndarray, faces: np.ndarray,
                       hole_size: float,
                       max_loop: int = 256) -> Tuple[np.ndarray, int]:
    """Final large-hole pass (ref utils.py:338-345: pyvista
    ``fill_holes(hole_size=bbox_avg/10)`` after Taubin smoothing).

    Fills every simple boundary loop whose bounding radius is below
    ``hole_size`` — planar or not: the loop is ordered by edge-walking
    and triangulated by minimum-area interval DP (fan from vertex 0 for
    loops longer than ``max_loop``, where O(L³) DP stops paying).
    Returns (faces', n_filled).
    """
    be = boundary_edges(faces)
    if be.size == 0:
        return faces, 0
    loops, edge_loop = _loop_partition(be)
    edge_order = np.argsort(edge_loop, kind="stable")
    edge_splits = np.searchsorted(edge_loop[edge_order],
                                  np.arange(1, len(loops)))
    loop_edges = np.split(edge_order, edge_splits)
    new_faces = [faces.astype(np.int64)]
    filled = 0
    # batch the dominant case: 3-vertex loops with exactly 3 boundary
    # edges are triangles (order/triangulation trivial) — at 1M points
    # ~10k of them pay ~2 ms each through the generic walk + DP path
    n_edges = np.bincount(edge_loop, minlength=len(loops))
    tri3 = [li for li, loop in enumerate(loops)
            if loop.size == 3 and n_edges[li] == 3]
    if tri3:
        P3 = vertices[np.stack([loops[li] for li in tri3])]   # (B, 3, 3)
        radius3 = np.linalg.norm(
            P3 - P3.mean(1, keepdims=True), axis=2).max(1)
        ok3 = np.asarray(tri3)[radius3 <= hole_size]
        if ok3.size:
            new_faces.append(np.stack([loops[li] for li in ok3]))
            filled += ok3.size
    tri3_set = set(tri3)
    for li, loop in enumerate(loops):
        if loop.size < 3 or li in tri3_set:
            continue
        pts = vertices[loop]
        radius = float(np.linalg.norm(pts - pts.mean(0), axis=1).max())
        if radius > hole_size:
            continue
        cyc = order_loop(be[loop_edges[li]], loop)
        if cyc is None:
            continue
        if cyc.size <= max_loop:
            tris = _min_area_triangulation(vertices[cyc])
        else:
            tris = [(0, i, i + 1) for i in range(1, cyc.size - 1)]
        if tris:
            new_faces.append(cyc[np.asarray(tris, dtype=np.int64)])
            filled += 1
    return np.concatenate(new_faces, axis=0), filled


def fill_small_holes(vertices: np.ndarray, faces: np.ndarray,
                     perimeter_factor: float = 0.5,
                     planar_tol: float = 1e-2) -> Tuple[np.ndarray, int]:
    """Detect loops, fill those with perimeter < factor × mean bbox extent
    (ref :173) and passing the planarity test; returns (faces', n_filled).
    """
    bbox = vertices.max(0) - vertices.min(0)
    threshold = perimeter_factor * float(bbox.mean())
    be = boundary_edges(faces)
    if be.size == 0:
        return faces, 0
    loops, edge_loop = _loop_partition(be)
    # all loop perimeters in one segment sum (an edge's endpoints are in
    # the same component by construction, so this matches the per-loop
    # both-endpoints-in-loop edge selection exactly)
    elen = np.linalg.norm(vertices[be[:, 0]] - vertices[be[:, 1]], axis=1)
    perims = np.bincount(edge_loop, weights=elen, minlength=len(loops))
    sizes = np.fromiter((lp.size for lp in loops), np.int64, len(loops))
    new_faces = [faces]
    filled = 0
    # group loops by size: one BATCHED SVD planarity test per size class
    # (BPA leaves tens of thousands of 3-5 edge holes at 1M points —
    # a per-loop svd/Delaunay round-trip costs ~2 ms each)
    for s in np.unique(sizes):
        if s < 3:
            continue
        cand = np.flatnonzero((sizes == s) & (perims < threshold))
        if cand.size == 0:
            continue
        P = vertices[np.stack([loops[i] for i in cand])]     # (B, s, 3)
        c = P - P.mean(1, keepdims=True)
        sv = np.linalg.svd(c, compute_uv=False)              # (B, 3)
        planar = (sv[:, 0] <= 0) | (
            sv[:, -1] / np.maximum(sv[:, 0], 1e-300) < planar_tol)
        ok = cand[planar]
        if ok.size == 0:
            continue
        if s == 3:
            # Delaunay of a triangle is that triangle — fill in one batch
            new_faces.append(
                np.stack([loops[i] for i in ok]).astype(np.int64))
            filled += ok.size
        else:
            for i in ok:
                f = fill_hole(vertices, loops[i])
                if f.size:
                    new_faces.append(f)
                    filled += 1
    return np.concatenate(new_faces, axis=0), filled
