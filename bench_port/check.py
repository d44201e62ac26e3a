"""The comparison that decides ``correct``: the program's outputs at a
seeded sample of rows against the plain reference at the same rows.

Every number is a widest gap or a share over the sampled rows. A row is
certified where the program says its kNN is exact (``exact``, on routes
that return it) and on every row of routes that return no certificate;
the kNN, normal and curvature gaps are taken over certified rows, and
``knn_bad_share`` counts the rows that are uncertified or whose kth
distance is off, so a certificate that gives up shows too.

A row is tied where the reference's kth and (k+1)th squared distances
lie within TIE_REL of each other: float32 distances, the precision the
configuration states, cannot order the two, so either is the kth
neighbour, and the fit moves with the choice (one swapped neighbour of a
noisy neighbourhood moves K by a few %). Tied rows are left out of the
numbers that read the neighbour set (``nbr_gap``, the normal, the sign
and the curvature), by this rule on the reference's distances alone.

- ``kth_rel``: |kth − kth_ref| / kth_ref, the kth neighbour's distance;
- ``knn_bad_share``: share of rows uncertified or with kth_rel > BAD_KTH;
- ``nbr_gap`` (routes that return neighbours): the rows' neighbour sets
  re-measured in float64 from the benchmark's points and sorted,
  max_j |d²_j − d²_ref,j| / d²_ref,k; an id out of range, the query
  itself or a repeated id reads inf;
- ``nbr_dist`` (same): the reported distances against the reference's,
  rank by rank, max_j |d_j − d_ref,j| / kth_ref;
- ``normal_ang``: the angle in radians between the normals, up to sign;
- ``sign_flip_share``: share of rows whose normal points against the
  reference's (the sign fix reads the farthest minus the nearest
  neighbour, so rounding flips a few rows);
- ``K_err``, ``H_err``, ``k12_err``: |x − x_ref| / (|x_ref| + median
  |x_ref|), H and (k1, k2) taken with the sign of the reference's normal
  (a flipped normal negates H and swaps k1, k2 into −k2, −k1);
- ``K_p99``, ``H_p99``: the 99th percentile of the same K and H gaps
  over the certified rows, steady from seed to seed where the widest
  gap swings with a rare row;
- ``K_p99_all``: the same K percentile over every untied row, certified
  or not, so the answers on rows a route leaves uncertified are held
  too.

A number that is NaN reads inf.
"""

from __future__ import annotations

import numpy as np

BAD_KTH = 1e-4
TIE_REL = 2.0 ** -20   # ~4 float32 ulps of a squared distance


def _max(x: np.ndarray) -> float:
    if x.size == 0:
        return 0.0
    x = np.where(np.isnan(x), np.inf, x)
    return float(np.max(x))


def _p99(x: np.ndarray) -> float:
    if x.size == 0:
        return 0.0
    return float(np.percentile(np.where(np.isnan(x), np.inf, x), 99))


def _rel(err: np.ndarray, ref: np.ndarray) -> np.ndarray:
    scale = np.median(np.abs(ref)) if ref.size else 0.0
    return np.abs(err) / (np.abs(ref) + scale)


def neighbour_numbers(points: np.ndarray, rows: np.ndarray, ids: np.ndarray,
                      dists: np.ndarray, ref_d2: np.ndarray,
                      kth_ref: np.ndarray):
    """(nbr_gap per row, nbr_dist per row) for the program's neighbour
    ids and reported distances (ascending)."""
    n = points.shape[0]
    ids = ids.astype(np.int64)
    bad = (ids < 0) | (ids >= n) | (ids == rows[:, None])
    srt = np.sort(ids, axis=1)
    bad |= np.concatenate([np.zeros_like(srt[:, :1], dtype=bool),
                           srt[:, 1:] == srt[:, :-1]], axis=1)
    p = points.astype(np.float64)
    diff = p[np.clip(ids, 0, n - 1)] - p[rows][:, None, :]
    d2 = (diff * diff).sum(-1)
    gap = np.abs(np.sort(d2, axis=1) - ref_d2) / ref_d2[:, -1:]
    gap = np.where(bad.any(1), np.inf, gap.max(1))
    dist = np.abs(dists.astype(np.float64) - np.sqrt(ref_d2)) / kth_ref[:, None]
    return gap, np.where(np.isnan(dist), np.inf, dist).max(1)


def numbers(sample: dict, ref: dict, points_of) -> dict:
    """The check's numbers. ``sample``: the program's outputs at the
    sampled rows (host arrays: cloud, row, K, H, k1, k2, normals, kth and
    optionally exact, ids, dists); ``ref``: the reference at the same
    rows (d2 (R, k), normals, K, H, k1, k2); ``points_of(j)``: the host
    points of pool cloud j."""
    rows = sample["row"]
    cert = sample.get("exact")
    cert = np.ones(rows.shape, bool) if cert is None else cert.astype(bool)
    kth_ref = np.sqrt(ref["d2"][:, -1])
    tied = ref["d2_next"] - ref["d2"][:, -1] <= TIE_REL * ref["d2"][:, -1]
    settled = cert & ~tied
    kth_err = np.abs(sample["kth"].astype(np.float64) - kth_ref) / kth_ref
    kth_err = np.where(np.isnan(kth_err), np.inf, kth_err)
    out = {
        "kth_rel": _max(kth_err[cert]),
        "knn_bad_share": float(np.mean(~cert | ~(kth_err <= BAD_KTH)))
        if rows.size else 1.0,
    }
    if "ids" in sample:
        gap = np.empty(rows.shape)
        dist = np.empty(rows.shape)
        for j in np.unique(sample["cloud"]):
            m = sample["cloud"] == j
            gap[m], dist[m] = neighbour_numbers(
                points_of(int(j)), rows[m], sample["ids"][m],
                sample["dists"][m], ref["d2"][m], kth_ref[m])
        out["nbr_gap"] = _max(gap[settled])
        out["nbr_dist"] = _max(dist[cert])
    n = sample["normals"].astype(np.float64)
    nr = ref["normals"]
    dot = (n * nr).sum(1)
    cross = np.linalg.norm(np.cross(n, nr), axis=1)
    ang = np.arctan2(cross, np.abs(dot))
    out["normal_ang"] = _max(np.where(np.isfinite(dot), ang, np.inf)[settled])
    flip = ~(dot >= 0)
    out["sign_flip_share"] = (float(np.mean(flip[settled])) if settled.any()
                              else 1.0)
    sgn = np.where(flip, -1.0, 1.0)
    K = sample["K"].astype(np.float64)
    H = sample["H"].astype(np.float64) * sgn
    k1 = np.where(flip, -sample["k2"], sample["k1"]).astype(np.float64)
    k2 = np.where(flip, -sample["k1"], sample["k2"]).astype(np.float64)
    k_all = _rel(K - ref["K"], ref["K"])
    k_gap = k_all[settled]
    h_gap = _rel(H - ref["H"], ref["H"])[settled]
    out["K_err"], out["H_err"] = _max(k_gap), _max(h_gap)
    out["K_p99"], out["H_p99"] = _p99(k_gap), _p99(h_gap)
    out["K_p99_all"] = _p99(k_all[~tied])
    kmax = np.maximum(np.abs(ref["k1"]), np.abs(ref["k2"]))
    k12 = np.maximum(np.abs(k1 - ref["k1"]), np.abs(k2 - ref["k2"]))
    out["k12_err"] = _max(_rel(k12, kmax)[settled])
    out["tied_rows"] = int(tied.sum())
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limited numbers;
    a limited number the route cannot give raises KeyError."""
    checks = {name: {"value": nums[name], "limit": limit}
              for name, limit in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
