"""CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with nvcc and skip elsewhere. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pct_tpu_torch.neighbors import ball_grid, knn_bruteforce, knn_grid
from pct_tpu_torch.neighbors.grid import build_grid
from pct_tpu_torch.experimental.band_select import (
    band_select_plain,
    knn_band_select,
)
from pct_tpu_torch.ops.moments import (
    knn_moments,
    moments_plain,
    stats_agreement,
)
from pct_tpu_torch.ops.select import (
    knn_select,
    knn_select_coords,
    knn_select_rows,
    select_coords_plain,
    select_pos_plain,
    select_rows_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _tile(seed, T, C, M, dup=False, sparse=False):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((T, M, 3)).astype(np.float32)
    if dup:
        p[:, 1::2] = p[:, 0::2][:, :M // 2]
    q = p[:, :C].copy() if C <= M else rng.standard_normal(
        (T, C, 3)).astype(np.float32)
    cand = np.tile(np.arange(M, dtype=np.int32), (T, 1))
    qrow = np.tile(np.arange(C, dtype=np.int32), (T, 1))   # self = slot c
    valid = (rng.random((T, M)) < (0.05 if sparse else 0.9)).astype(np.int32)
    return q, p, cand, qrow, valid


@pytest.mark.parametrize("T,C,M,k,dup,sparse", [
    (64, 8, 48, 5, False, False),       # one chunk, C < warp
    (33, 37, 300, 20, False, False),    # two chunks, C not a warp multiple
    (20, 64, 700, 63, False, False),    # three chunks, largest k
    (16, 40, 256, 1, False, False),     # k = 1, M exactly one chunk
    (24, 16, 96, 20, True, False),      # exact distance ties
    (24, 16, 96, 20, False, True),      # fewer than k valid candidates
    (8, 256, 520, 20, False, False),    # the probe's largest capacity
    (16, 8, 8, 20, False, False),       # fewer candidate slots than k
    (8, 64, 700, 100, False, False),    # the 128-entry list
    (4, 37, 300, 128, False, False),    # the largest k
])
def test_select_coords_kernel_bit_identical(cuda, T, C, M, k, dup, sparse):
    ops = [torch.from_numpy(a).to(cuda)
           for a in _tile(T * C + M, T, C, M, dup, sparse)]
    before = knn_select_coords.launches
    d_k, n_k = knn_select_coords(*ops, k)
    torch.cuda.synchronize()
    assert knn_select_coords.launches == before + 1
    d_p, n_p = select_coords_plain(*ops, k)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(n_k.view(torch.int32), n_p.view(torch.int32))
    if sparse:
        assert (d_k > 1e18).any()


def _ids_tile(seed, T, C, M, dup=False, empty=False, lattice=False,
              p_valid=0.9):
    """Random tile with distinct candidate ids; the first min(C, M) query
    slots are candidates themselves (self hits); ``dup`` makes every
    point appear twice (exact ties between distinct ids); ``empty`` makes
    every other row's candidates all invalid; ``lattice`` puts every
    point on a 1/4 lattice (exact d², ties at every distance); a slot is
    valid with probability ``p_valid``."""
    rng = np.random.default_rng(seed)
    if lattice:
        p = (rng.integers(0, 8, (T, M, 3)) * 0.25).astype(np.float32)
    else:
        p = rng.standard_normal((T, M, 3)).astype(np.float32)
    if dup:
        p[:, 1::2] = p[:, 0::2][:, :M // 2]
    q = rng.standard_normal((T, C, 3)).astype(np.float32)
    cand = np.stack([rng.permutation(10 * M)[:M] for _ in range(T)]
                    ).astype(np.int32)
    qrow = rng.integers(10 * M, 20 * M, (T, C)).astype(np.int32)
    s = min(C, M)
    q[:, :s], qrow[:, :s] = p[:, :s], cand[:, :s]
    if lattice:
        q = (np.round(q * 4) / 4).astype(np.float32)
    valid = (rng.random((T, M)) < p_valid).astype(np.int32)
    if empty:
        valid[::2] = 0
    return q, p, cand, qrow, valid


@pytest.mark.parametrize("want", ["rows", "pos"])
@pytest.mark.parametrize("T,C,M,k,dup,empty", [
    (16, 1, 300, 1, False, False),      # C = 1, k = 1
    (12, 37, 520, 20, False, False),    # C % 32 != 0, three chunks
    (3, 400, 700, 64, False, False),    # C = 400, k = 64
    (6, 64, 1100, 100, False, False),   # the k=100 list, five chunks
    (4, 128, 1064, 128, False, False),  # the largest k, 128-entry list
    (8, 16, 40, 64, False, False),      # fewer candidate slots than k
    (12, 32, 200, 20, True, False),     # exact distance ties
    (8, 24, 400, 100, False, True),     # empty rows
])
def test_select_ids_kernels_bit_identical(cuda, want, T, C, M, k, dup,
                                          empty):
    ops = [torch.from_numpy(a).to(cuda)
           for a in _ids_tile(T * C + M + k, T, C, M, dup, empty)]
    kernel, plain = ((knn_select_rows, select_rows_plain) if want == "rows"
                     else (knn_select, select_pos_plain))
    before = kernel.launches
    d_k, w_k = kernel(*ops, k)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    d_p, w_p = plain(*ops, k)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(w_k, w_p)
    if want == "pos":     # the rows kernel's ids are cand[pos]
        _, rows = knn_select_rows(*ops, k)
        assert torch.equal(rows, torch.gather(
            ops[2], 1, w_k.reshape(T, -1).long()).reshape(T, C, k))
    if empty or M < k:
        assert (d_k > 1e18).any()


# the warp design's limits and paths: the streamed source (M past the
# shared-memory cache), C = 1024, k = 128, lattice ties that straddle the
# kth at k=100, rows with fewer than k usable slots, all-invalid rows, C = 1
IDS_CASES = {
    "streamed_M6000_k100": (2, 16, 6000, 100, {}),
    "streamed_M6000_k128_lattice": (2, 40, 6000, 128, {"lattice": True}),
    "C1024_k20": (2, 1024, 300, 20, {}),
    "C1024_k100": (1, 1024, 1064, 100, {}),
    "k128_M1064": (4, 64, 1064, 128, {}),
    "lattice_k100": (8, 48, 1064, 100, {"lattice": True}),
    "lattice_k20": (16, 16, 232, 20, {"lattice": True}),
    "under_k_k100": (8, 32, 900, 100, {"p_valid": 0.05}),
    "all_invalid_k100": (6, 24, 700, 100, {"empty": True}),
    "C1_k100": (16, 1, 1064, 100, {}),
}


@pytest.mark.parametrize("want", ["rows", "pos"])
@pytest.mark.parametrize("case", sorted(IDS_CASES))
def test_select_ids_warp_design_cases(cuda, want, case):
    T, C, M, k, kw = IDS_CASES[case]
    ops = [torch.from_numpy(a).to(cuda)
           for a in _ids_tile(T * C + M + k, T, C, M, **kw)]
    kernel, plain = ((knn_select_rows, select_rows_plain) if want == "rows"
                     else (knn_select, select_pos_plain))
    before = kernel.launches
    d_k, w_k = kernel(*ops, k)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    d_p, w_p = plain(*ops, k)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(w_k, w_p)
    found = d_k < 1e18
    if kw.get("lattice"):          # ties straddle the kth distance
        kth = d_k[..., k - 1:k]
        assert ((d_k[..., :-1] == kth) & found[..., :-1]).any()
    if "p_valid" in kw or kw.get("empty"):
        assert (~found[..., -1]).any()
        cand0 = ops[2][:, :1, None].expand_as(w_k)
        assert torch.equal(w_k[~found], (cand0 if want == "rows"
                                         else torch.zeros_like(w_k))[~found])


# the coords select on the same warp design: the streamed source at
# M=6000, C = 1 and C = 1024, k = 128, rows with fewer than k usable
# slots, all-invalid rows, lattice ties at the kth distance
COORDS_CASES = {
    "streamed_M6000_k20": (2, 16, 6000, 20, {}),
    "streamed_M6000_k128_lattice": (2, 40, 6000, 128, {"lattice": True}),
    "C1_k20": (16, 1, 232, 20, {}),
    "C1024_k20": (2, 1024, 300, 20, {}),
    "k128_M1064": (4, 64, 1064, 128, {}),
    "under_k_k20": (8, 32, 232, 20, {"p_valid": 0.05}),
    "all_invalid_k20": (6, 24, 232, 20, {"empty": True}),
    "lattice_k20": (16, 16, 232, 20, {"lattice": True}),
    "lattice_k100": (8, 48, 1064, 100, {"lattice": True}),
}


@pytest.mark.parametrize("case", sorted(COORDS_CASES))
def test_select_coords_warp_design_cases(cuda, case):
    """Bit for bit against the plain version, and the coordinates are the
    candidates at the positions kernel's winners (slot 0 where missing)."""
    T, C, M, k, kw = COORDS_CASES[case]
    ops = [torch.from_numpy(a).to(cuda)
           for a in _ids_tile(T * C + M + k, T, C, M, **kw)]
    before = knn_select_coords.launches
    d_k, n_k = knn_select_coords(*ops, k)
    torch.cuda.synchronize()
    assert knn_select_coords.launches == before + 1
    d_p, n_p = select_coords_plain(*ops, k)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(n_k.view(torch.int32), n_p.view(torch.int32))
    d_pos, pos = knn_select(*ops, k)
    assert torch.equal(d_pos.view(torch.int32), d_k.view(torch.int32))
    picked = torch.gather(ops[1], 1, pos.reshape(T, C * k, 1).long()
                          .expand(-1, -1, 3)).reshape(T, C, k, 3)
    assert torch.equal(n_k.view(torch.int32), picked.view(torch.int32))
    found = d_k < 1e18
    if kw.get("lattice"):          # ties straddle the kth distance
        kth = d_k[..., k - 1:k]
        assert ((d_k[..., :-1] == kth) & found[..., :-1]).any()
    if "p_valid" in kw or kw.get("empty"):
        assert (~found[..., -1]).any()
        slot0 = ops[1][:, None, None, 0, :].expand_as(n_k)
        assert torch.equal(n_k[~found], slot0[~found])


def _moment_tile(seed, T, C, M, lattice=False, p_valid=0.9, empty=False):
    """Random tile; ``lattice`` puts every point on a dyadic lattice
    (exact d², many exact ties at the kth distance); ``empty`` makes
    every other tile's candidates all invalid."""
    rng = np.random.default_rng(seed)
    if lattice:
        p = (rng.integers(0, 16, (T, M, 3)) * 2.0**-4).astype(np.float32)
    else:
        p = rng.standard_normal((T, M, 3)).astype(np.float32)
    q = p[:, :C].copy() if C <= M else rng.standard_normal(
        (T, C, 3)).astype(np.float32)
    cand = np.tile(np.arange(M, dtype=np.int32), (T, 1))
    qrow = np.tile(np.arange(C, dtype=np.int32), (T, 1))   # self = slot c
    valid = (rng.random((T, M)) < p_valid).astype(np.int32)
    if empty:
        valid[::2] = 0
    return q, p, cand, qrow, valid


@pytest.mark.parametrize("T,C,M,k,lattice,p_valid,empty", [
    (16, 1, 300, 64, False, 0.9, False),      # C = 1, one chunk
    (8, 37, 512, 100, False, 0.9, False),     # C % 32 != 0, M = one chunk
    (4, 400, 1500, 100, False, 0.9, False),   # C = 400, three chunks
    (6, 64, 2100, 200, False, 0.9, False),    # k = 200, five chunks
    (8, 40, 700, 100, True, 0.9, False),      # exact ties: fractional weights
    (8, 32, 600, 100, False, 0.1, False),     # under-k rows
    (8, 24, 400, 64, False, 0.9, True),       # empty rows
    (4, 8, 50, 64, False, 0.9, False),        # fewer candidate slots than k
])
def test_moments_kernel_matches_plain(cuda, T, C, M, k, lattice, p_valid,
                                      empty):
    ops = [torch.from_numpy(a).to(cuda)
           for a in _moment_tile(T * C + M + k, T, C, M, lattice, p_valid,
                                 empty)]
    before = knn_moments.launches
    got = knn_moments(*ops, k)
    torch.cuda.synchronize()
    assert knn_moments.launches == before + 1
    want = moments_plain(*ops, k)
    differing, ratio, _ = stats_agreement(got, want)
    assert differing == 0 and ratio <= 1.0, (differing, ratio)
    found = want[..., 45] > 0
    if lattice:
        eq = want[..., 37] - want[..., 36]
        assert (found & (eq > 1)).any()       # ties split at the kth
    if p_valid < 0.5 or M < k:
        assert not found.any() and (want[..., 37] > 0).any()
    if empty:
        assert (want[::2, :, 35] == 0).all() and (want[::2, :, :35] == 0).all()


MOMENT_CASES = {
    "streamed_M6000_k100": (2, 16, 6000, 100, {}),
    "streamed_M6000_lattice": (2, 24, 6000, 100, {"lattice": True}),
    "C512_k100": (2, 512, 700, 100, {}),
    "k128_M1064": (4, 64, 1064, 128, {}),
    "lattice_k100_M1064": (6, 48, 1064, 100, {"lattice": True}),
    "under_k_k100": (8, 32, 900, 100, {"p_valid": 0.05}),
    "all_invalid_k100": (6, 24, 700, 100, {"empty": True}),
    "C1_lattice_k100": (16, 1, 1064, 100, {"lattice": True}),
}


@pytest.mark.parametrize("case", sorted(MOMENT_CASES))
def test_moments_warp_design_cases(cuda, case):
    """The warp design's limits and paths, as IDS_CASES for the selects:
    columns 35–47 bit for bit, the sums within count_le²·2⁻²⁴."""
    T, C, M, k, kw = MOMENT_CASES[case]
    ops = [torch.from_numpy(a).to(cuda)
           for a in _moment_tile(T * C + M + k, T, C, M, **kw)]
    before = knn_moments.launches
    got = knn_moments(*ops, k)
    torch.cuda.synchronize()
    assert knn_moments.launches == before + 1
    want = moments_plain(*ops, k)
    differing, ratio, _ = stats_agreement(got, want)
    assert differing == 0 and ratio <= 1.0, (differing, ratio)
    found = want[..., 45] > 0
    if kw.get("lattice"):
        assert (found & (want[..., 37] - want[..., 36] > 1)).any()
    if "p_valid" in kw:
        assert not found.any() and (want[..., 37] > 0).any()
    if kw.get("empty"):
        assert (want[::2, :, :36] == 0).all()


def tied_lattice():
    """A 12×12×2 integer lattice plus two far outliers, shuffled, and 4
    padding rows: (padded (N,3) float32, valid count n). Every distance
    is an exact small integer in the difference and the expanded form,
    so every backend sees the same d² and ties abound (6 neighbors at 1,
    12 at √2, ...); the outliers' windows hold fewer than k points, so
    their lists end in masked inf slots. tests/test_torch_knn.py holds
    the port to the JAX package on it."""
    g = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([g, [[40, 40, 40], [40, 40, 42]]])
    pts = pts[np.random.default_rng(0).permutation(len(pts))]
    return (np.concatenate([pts, np.zeros((4, 3))]).astype(np.float32),
            len(pts))


@pytest.mark.parametrize("case", ["knn_grid", "ball_grid", "knn_bruteforce"])
def test_tie_order_same_on_card(cuda, case):
    """The stable top-k (lower column first on equal d²) gives the card
    the CPU's indices in order on the tied lattice."""
    pts, n = tied_lattice()
    out = []
    for dev in ("cpu", cuda):
        p = torch.from_numpy(pts).to(dev)
        if case == "knn_bruteforce":
            out.append(knn_bruteforce(p, n, n + 2))
            continue
        g = build_grid(p, n, torch.tensor(np.float32(2.0), device=dev))
        q, qi = g.sorted_points[:n], g.order[:n]
        out.append(knn_grid(g, q, 10, query_indices=qi, capacity=9)
                   if case == "knn_grid"
                   else ball_grid(g, q, 1.5, 24, capacity=16))
    (i_c, d_c), (i_g, d_g) = (r[:2] for r in out)
    assert torch.equal(i_g.cpu(), i_c)
    # the same d² on both; PyTorch's float32 square root on the CPU can be
    # 1 ulp from the correctly rounded one the card gives (sqrt(4285))
    torch.testing.assert_close(d_g.cpu(), d_c, rtol=2.4e-7, atol=0)


# csrc/band_select.cu's staging tile (rows a block stages) and a warp's
# cached d2 bits (candidates a query); past them the kernel streams
BAND_TILE = 2048
BAND_BITS = 512


def _band_tile(seed, nb, bc, cap, band, lattice=False, sparse=False,
               runs="random"):
    """Random band-select operands: overlapping bands, runs of random
    offset and length (some empty), the last cell of every other block a
    padding cell (no runs), each cell's first query slots on rows of its
    centre run (self hits), edges at ±1e30 on some axes. ``lattice``
    puts every point on a 1/4 lattice (exact distance ties); ``sparse``
    cuts every run to at most one row (fewer than k candidates).
    ``runs="wide"`` scatters short runs (<= 24 rows) over the whole band,
    so a block's run hulls exceed the staging tile while each query's
    candidates fit its bit slice; ``runs="long"`` gives every cell runs
    over the whole band, so its queries exceed the bit slice."""
    rng = np.random.default_rng(seed)
    npad = nb * band // 2 + band
    if lattice:
        pl = (rng.integers(0, 8, (3, npad)) * 0.25).astype(np.float32)
    else:
        pl = rng.standard_normal((3, npad)).astype(np.float32)
    bs = rng.integers(0, npad - band // 2, (nb, 9)).astype(np.int32)
    rs_rel = rng.integers(0, band, (nb, bc, 9)).astype(np.int32)
    if runs == "wide":
        run_len = rng.integers(1, 25, (nb, bc, 9)).astype(np.int32)
        run_len = np.minimum(run_len, band - rs_rel)
    elif runs == "long":
        rs_rel[:] = 0
        run_len = np.full((nb, bc, 9), band, np.int32)
    else:
        run_len = rng.integers(0, band - rs_rel + 1).astype(np.int32)
        run_len[rng.random((nb, bc, 9)) < 0.2] = 0
    if sparse:
        run_len = np.minimum(run_len, 1)
    run_len[::2, -1] = 0
    qbase = np.clip(bs[:, None, 4] + rs_rel[:, :, 4], 0, npad - 1)
    qrow = np.minimum(qbase[..., None] + np.arange(cap), npad - 1)
    qpts = pl.T[qrow.reshape(nb, bc * cap)].copy()
    qpts[:, 1::3] += np.float32(0.125)
    lo = (qpts.reshape(nb, bc, cap, 3).min(2) - 0.5).astype(np.float32)
    hi = (qpts.reshape(nb, bc, cap, 3).max(2) + 0.5).astype(np.float32)
    lo[:, ::3, 0] = -1e30
    hi[:, 1::3, 2] = 1e30
    return (pl[0], pl[1], pl[2], bs, rs_rel, run_len, qpts,
            qbase.astype(np.int32), lo, hi)


def _band_counts(seed, nb, bc, cap):
    """(nb, bc) int32 points a cell: random in [0, cap], the first cell of
    every block holding one point, a padding cell (0) in every block."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, cap + 1, (nb, bc)).astype(np.int32)
    counts[:, 0] = 1
    counts[:, -1] = 0
    return counts


def _band_paths(ops, counts, bc, cap, band):
    """(blocks past the tile, computed query slots past the bit slice),
    as the kernel decides them."""
    rs, rl = ops[4].long(), ops[5].long()
    nb = rs.shape[0]
    cnt = (torch.full((nb, bc), cap, device=rs.device) if counts is None
           else counts.long().clamp(0, cap))
    p0 = rs.clamp(min=0)
    p1 = torch.minimum(rs + rl, torch.full_like(rs, band))
    ne = (p1 > p0) & (cnt[..., None] > 0)
    hull = (torch.where(ne, p1, 0).max(1).values
            - torch.where(ne, p0, band).min(1).values).clamp(min=0).sum(-1)
    m = (p1 - p0).clamp(min=0).sum(-1)
    return int((hull > BAND_TILE).sum()), int(((m > BAND_BITS) * cnt).sum())


BAND_CASES = {
    "k1_q32": (16, 8, 4, 128, 1, {}),
    "k10": (12, 8, 16, 128, 10, {}),
    "torus_shape_k20": (10, 8, 32, 384, 20, {}),   # the 1M torus at k=20
    "band1024_k64": (6, 4, 64, 1024, 64, {}),
    "k100": (4, 8, 16, 1024, 100, {}),
    "k128_q_odd": (4, 2, 37, 256, 128, {}),        # Q % 32 != 0
    "q1024_k20": (2, 8, 128, 1024, 20, {}),        # 1024 query slots a block
    "lattice_k20": (8, 8, 16, 256, 20, {"lattice": True}),
    "under_k_k20": (8, 8, 8, 128, 20, {"sparse": True}),
    "under_k_k128": (6, 8, 8, 256, 128, {"sparse": True}),
    "hull_past_tile_k20": (6, 8, 16, 1024, 20, {"runs": "wide"}),
    "query_past_bits_k20": (4, 8, 8, 200, 20, {"runs": "long"}),
}


@pytest.mark.parametrize("mode", ["all_slots", "counts"])
@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_select_kernel_bit_identical(cuda, case, mode):
    nb, bc, cap, band, k, kw = BAND_CASES[case]
    seed = nb * cap + band + k
    ops = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
           for a in _band_tile(seed, nb, bc, cap, band, **kw)]
    counts = (None if mode == "all_slots" else
              torch.from_numpy(_band_counts(seed, nb, bc, cap)).to(cuda))
    before = knn_band_select.launches
    d_k, r_k, c_k = knn_band_select(*ops, k=k, bc=bc, cap=cap, band=band,
                                    counts=counts)
    torch.cuda.synchronize()
    assert knn_band_select.launches == before + 1
    d_p, r_p, c_p = band_select_plain(*ops, k, bc, cap, band, counts)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(r_k, r_p)
    assert torch.equal(c_k.view(torch.int32), c_p.view(torch.int32))
    missing = d_k > 1e18
    assert missing.any()                    # the padding cells at least
    bs0 = ops[3][:, 0].repeat_interleave(bc * cap)[:, None].expand_as(r_k)
    assert torch.equal(r_k[missing], bs0[missing])
    if counts is not None:                  # padding slots: all k missing
        slot = torch.arange(cap, device=cuda)
        pad = (slot >= counts[..., None]).reshape(-1)
        assert missing[pad].all()
    past_tile, past_bits = _band_paths(ops, counts, bc, cap, band)
    if kw.get("runs") == "wide":
        assert past_tile > 0 and past_bits == 0
    if kw.get("runs") == "long":
        assert past_tile == 0 and past_bits > 0
    if kw.get("sparse"):
        assert missing[:, -1].all()
    if kw.get("lattice"):
        assert (d_k[:, 1:] == d_k[:, :-1])[~missing[:, 1:]].any()


# --- the mesh path on the card against its CPU run --------------------------

def _torus_cloud(n):
    from pct_tpu_torch.shapes import generate_shape

    return generate_shape("torus", n, perturbation_strength=1e-3, seed=1)[1]


@pytest.mark.parametrize("k", [16, 50], ids=["list_route", "moments_route"])
def test_normals_card_vs_cpu(cuda, monkeypatch, k):
    """The hierarchical path (threshold lowered to 2000) on a 5k torus:
    one launch a bucket of the plan's layouts at each k (the moments at
    k, the rows at kv, or at k on the list route, and at kc), and the
    card's normals have the CPU run's signs and directions to 1e-5."""
    import pct_tpu_torch.mesh.normals as tn
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.ops.moments import knn_moments as mom

    monkeypatch.setattr(tn, "_HIER_THRESHOLD", 2000)
    pts = _torus_cloud(5000)
    cloud = from_numpy(pts, device=cuda)
    plan = tn.plan_normals(cloud.points, cloud.num_points, k)
    assert plan.hierarchical
    want_rows = {}
    for kk, n in ((plan.kc, 1),
                  (plan.kv if k >= 32 else plan.k, len(plan.rows[0]))):
        want_rows[kk] = want_rows.get(kk, 0) + n
    knn_select_rows.launches_by_k.clear()
    before = mom.launches
    got = tn.estimate_and_orient_normals(cloud, k=k,
                                         device=cuda)[:5000].cpu().numpy()
    assert knn_select_rows.launches_by_k == want_rows
    assert mom.launches - before == (len(plan.moments[0]) if k >= 32 else 0)
    want = tn.estimate_and_orient_normals(from_numpy(pts, device="cpu"), k=k,
                                          device="cpu")[:5000].numpy()
    dot = np.sum(got * want, axis=1)
    assert (dot > 0).all()
    assert dot.min() >= 1 - 1e-5


def _torus_mesh(nu, nv):
    u = 2 * np.pi * np.arange(nu) / nu
    v = 2 * np.pi * np.arange(nv) / nv
    U, V = np.meshgrid(u, v, indexing="ij")
    rho = 1.0 + np.cos(V) / 3.0
    verts = np.stack([rho * np.cos(U), rho * np.sin(U), np.sin(V) / 3.0],
                     -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    cc = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, cc], -1).reshape(-1, 3),
                            np.stack([a, cc, d], -1).reshape(-1, 3)])
    return verts, faces.astype(np.int32)


def test_taubin_smooth_card_vs_cpu(cuda):
    from pct_tpu_torch.mesh import mesh_energies, taubin_smooth

    v, f = _torus_mesh(300, 100)
    v = v + np.random.default_rng(0).standard_normal(v.shape).astype(
        np.float32) * 1e-3
    vt, ft = torch.from_numpy(v), torch.from_numpy(f)
    got = taubin_smooth(vt.to(cuda), ft.to(cuda)).cpu()
    want = taubin_smooth(vt, ft)
    diag = float(np.linalg.norm(v.max(0) - v.min(0)))
    assert float((got - want).abs().max()) <= 1e-6 * diag
    ones = torch.ones(len(v))
    e_g = mesh_energies(vt.to(cuda), ft.to(cuda), ones.to(cuda), ones.to(cuda))
    e_c = mesh_energies(vt, ft, ones, ones)
    for a, b in zip(e_g, e_c):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_mesh_pipeline_card_vs_cpu(cuda):
    """``create_mesh_with_curvature`` on a 5000-point torus at its
    defaults, on the card and on the CPU: BPA and the hole passes run on
    the host from each run's normals and smoothed vertices, so the face
    sets are equal. Taubin's ``index_add_`` adds with float atomics on the
    card, which reorders its sums, so the energies agree to a tolerance:
    area and bending to 1e-4 relative; the stretching Σ K_f A_f, which
    cancels towards the torus' analytic 0 (0.479 here), to 1e-4 of its
    absolute mass Σ |K|_f A_f (26.0), where a relative bound on the small
    remainder would magnify rounding (measured on the card: 2.2e-4 of
    0.479, 8.6e-6 of the mass)."""
    from pct_tpu_torch.mesh import mesh_energies
    from pct_tpu_torch.ops.moments import knn_moments as mom
    from pct_tpu_torch.pipeline import create_mesh_with_curvature

    pts = _torus_cloud(5000)
    before = (mom.launches, knn_select_rows.launches,
              knn_select_coords.launches)
    got = create_mesh_with_curvature(pts, device=cuda)
    assert mom.launches > before[0] and knn_select_rows.launches > before[1]
    assert knn_select_coords.launches > before[2]
    want = create_mesh_with_curvature(pts, device="cpu")
    face_set = [set(map(tuple, np.sort(r.faces, axis=1).tolist()))
                for r in (got, want)]
    assert face_set[0] == face_set[1] and len(face_set[0]) > 9000
    assert got.n_holes_filled == want.n_holes_filled
    assert (np.sum(got.normals * want.normals, axis=1) > 0).all()
    g, w = got.energies, want.energies
    assert abs(g.total_area - w.total_area) <= 1e-4 * w.total_area
    assert abs(g.bending - w.bending) <= 1e-4 * w.bending
    mass = float(mesh_energies(
        torch.from_numpy(want.vertices), torch.from_numpy(want.faces),
        torch.from_numpy(np.abs(want.K)), torch.from_numpy(want.H)).stretching)
    assert abs(g.stretching - w.stretching) <= 1e-4 * mass
    assert not np.isnan(got.K).any() and not np.isnan(got.H).any()


# --- the validation harness on the card against its CPU run -----------------

@pytest.mark.parametrize("mode", ["mesh_free", "mesh"])
def test_validate_cloud_card_vs_cpu(cuda, mode):
    """``validate_cloud`` on the card and on the CPU, held to the harness
    tolerances of tests/test_torch_validate.py: mesh-free (the study and
    ``fast_curvature`` k=20 on the perturbed 3000-point torus, the coords
    kernel) area and bending to 1e-4 relative, the cancelling stretching
    to 1e-4 of Σ|K|·a; the mesh protocol (k=12 on the 2000-point sphere:
    the moments, rows and coords kernels) to 1e-4 relative, the
    stretching to 1e-4 of Σ|K|_f·A_f (Taubin's float atomics, as in
    ``test_mesh_pipeline_card_vs_cpu``)."""
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.mesh import mesh_energies
    from pct_tpu_torch.ops.moments import knn_moments as mom
    from pct_tpu_torch.pipeline import create_mesh_with_curvature
    from pct_tpu_torch.pipeline import fast_curvature
    from pct_tpu_torch.shapes import generate_shape
    from pct_tpu_torch.validate import validate_cloud

    if mode == "mesh_free":
        pts = generate_shape("torus", 3000, perturbation_strength=1e-3,
                             seed=0)[1]
        kw = dict(shape="torus", radius=1.0, k_neighbors=20, auto_k=True,
                  use_mesh=False)
    else:
        pts, _ = generate_shape("sphere", 2000, radius=1.0)
        kw = dict(shape="sphere", radius=1.0, k_neighbors=12, auto_k=False,
                  outlier_filter=True)
    before = (mom.launches, knn_select_rows.launches,
              knn_select_coords.launches)
    got = validate_cloud(pts, device=cuda, **kw)
    assert knn_select_coords.launches > before[2]
    if mode == "mesh":
        assert mom.launches > before[0]
        assert knn_select_rows.launches > before[1]
    want = validate_cloud(pts, device="cpu", **kw)
    assert got.aborted == want.aborted == ""
    assert got.nan_fraction == want.nan_fraction == 0.0
    assert got.study_kmax == want.study_kmax
    assert abs(got.converged_k - want.converged_k) <= 2
    assert list(got.stage_timings) == list(want.stage_timings)
    for f in ("total_area", "bending_energy"):
        g, w = getattr(got, f), getattr(want, f)
        assert abs(g - w) <= 1e-4 * abs(w), f
    n = len(pts)
    if mode == "mesh_free":
        r = fast_curvature(from_numpy(pts, device="cpu"), 20, device="cpu")
        a = np.pi * r.kth_dist[:n].numpy() ** 2 / 20
        mass = float(np.sum(np.abs(r.curv.K[:n].numpy()) * a))
    else:
        m = create_mesh_with_curvature(pts, k_neighbors=12, device="cpu")
        mass = float(mesh_energies(
            torch.from_numpy(m.vertices), torch.from_numpy(m.faces),
            torch.from_numpy(np.abs(m.K)), torch.from_numpy(m.H)).stretching)
    assert abs(got.stretching_energy - want.stretching_energy) <= 1e-4 * mass
