"""CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with nvcc and skip elsewhere. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from collections import Counter

import numpy as np
import pytest
import torch

from pct_tpu_torch.neighbors import ball_grid, knn_bruteforce, knn_grid
from pct_tpu_torch.neighbors.grid import build_grid
from pct_tpu_torch.experimental.band_select import (
    band_select_plain,
    knn_band_select,
)
from pct_tpu_torch.fit.moments import MOMENT_EXPS
from pct_tpu_torch.ops.epilogue import epilogue_plain, moments_epilogue
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
from pct_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


def _launches() -> Counter:
    """Kernel launches so far by entry point: the ``launches.<symbol>``
    counters of ``trace.counters()`` as ``<symbol>``, a select's
    ``launches.<symbol>.k<k>`` as ``<symbol>.k<k>``. The difference of
    two readings counts the launches between them."""
    return Counter({key.removeprefix("launches."): n
                    for key, n in trace.counters().items()
                    if key.startswith("launches.")})


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
    (4, 37, 300, 128, False, False),    # the largest k of the 1 KB class
    (4, 37, 300, 129, False, False),    # the 2 KB scratch class
    (3, 64, 1064, 256, False, False),   # the 2 KB class's largest k
    (2, 16, 1100, 1024, False, False),  # the 8 KB class, the largest k
    (4, 24, 700, 1024, False, True),    # fewer than k valid, k = 1024
])
def test_select_coords_kernel_bit_identical(cuda, T, C, M, k, dup, sparse):
    ops = [torch.from_numpy(a).to(cuda)
           for a in _tile(T * C + M, T, C, M, dup, sparse)]
    before = _launches()
    d_k, n_k = knn_select_coords(*ops, k)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_select_coords"] == 1
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
    (4, 37, 300, 129, False, False),    # the 2 KB scratch class
    (3, 64, 1064, 256, False, False),   # the 2 KB class's largest k
    (2, 40, 2136, 200, True, False),    # k = 200 at the 1M torus's
                                        # largest M, exact ties
    (2, 16, 1100, 1024, False, False),  # the 8 KB class, the largest k
])
def test_select_ids_kernels_bit_identical(cuda, want, T, C, M, k, dup,
                                          empty):
    ops = [torch.from_numpy(a).to(cuda)
           for a in _ids_tile(T * C + M + k, T, C, M, dup, empty)]
    kernel, plain, symbol = (
        (knn_select_rows, select_rows_plain, "pct_select_rows")
        if want == "rows"
        else (knn_select, select_pos_plain, "pct_select_pos"))
    before = _launches()
    d_k, w_k = kernel(*ops, k)
    torch.cuda.synchronize()
    assert (_launches() - before)[symbol] == 1
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
    # past 128 neighbors: the streamed source in the 4 KB and 8 KB
    # classes, C = 4096 (the probes' cap at k = 1024), under-k and ties
    "streamed_M5000_k512": (2, 16, 5000, 512, {}),
    "streamed_M6000_k1024_lattice": (1, 24, 6000, 1024, {"lattice": True}),
    "C4096_k200": (1, 4096, 300, 200, {}),
    "under_k_k256": (4, 32, 900, 256, {"p_valid": 0.05}),
    "lattice_k200": (4, 48, 2136, 200, {"lattice": True}),
    # past 1024 neighbors, the block class: its first k, k = 1536 and 2048
    # at the 1M torus's widths, lattice ties at the kth, under-k and
    # all-invalid rows, fewer slots than k, C = 1, the streamed source
    # past the 227 KB budget, and past 16,384 winners the device-memory
    # sort (its tile sort alone where under k)
    "block_k1025": (3, 37, 1100, 1025, {}),
    "block_k1536_M5000": (2, 24, 5000, 1536, {}),
    "block_k2048_M9500": (2, 16, 9500, 2048, {}),
    "block_lattice_k2048": (2, 24, 4000, 2048, {"lattice": True}),
    "block_under_k_k1100": (4, 16, 3000, 1100, {"p_valid": 0.2}),
    "block_all_invalid_k1100": (4, 8, 2000, 1100, {"empty": True}),
    "block_M_below_k_k2048": (3, 8, 1100, 2048, {}),
    "block_C1_k4096": (4, 1, 6000, 4096, {}),
    "block_streamed_M60000_k2048": (1, 3, 60000, 2048, {}),
    "block_global_sort_k20000": (1, 3, 24000, 20000, {}),
    "block_global_sort_under_k": (1, 2, 24000, 20000, {"p_valid": 0.5}),
    "block_streamed_global_sort": (1, 2, 30000, 20000, {}),
}


@pytest.mark.parametrize("want", ["rows", "pos"])
@pytest.mark.parametrize("case", sorted(IDS_CASES))
def test_select_ids_warp_design_cases(cuda, want, case):
    T, C, M, k, kw = IDS_CASES[case]
    ops = [torch.from_numpy(a).to(cuda)
           for a in _ids_tile(T * C + M + k, T, C, M, **kw)]
    kernel, plain, symbol = (
        (knn_select_rows, select_rows_plain, "pct_select_rows")
        if want == "rows"
        else (knn_select, select_pos_plain, "pct_select_pos"))
    before = _launches()
    d_k, w_k = kernel(*ops, k)
    torch.cuda.synchronize()
    assert (_launches() - before)[symbol] == 1
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
    # past 1024 neighbors, the block class
    "block_k1025": (3, 37, 1100, 1025, {}),
    "block_lattice_k2048": (2, 24, 4000, 2048, {"lattice": True}),
    "block_under_k_k1100": (4, 16, 3000, 1100, {"p_valid": 0.2}),
    "block_streamed_M60000_k2048": (1, 3, 60000, 2048, {}),
    "block_global_sort_k20000": (1, 2, 24000, 20000, {}),
}


@pytest.mark.parametrize("case", sorted(COORDS_CASES))
def test_select_coords_warp_design_cases(cuda, case):
    """Bit for bit against the plain version, and the coordinates are the
    candidates at the positions kernel's winners (slot 0 where missing)."""
    T, C, M, k, kw = COORDS_CASES[case]
    ops = [torch.from_numpy(a).to(cuda)
           for a in _ids_tile(T * C + M + k, T, C, M, **kw)]
    before = _launches()
    d_k, n_k = knn_select_coords(*ops, k)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_select_coords"] == 1
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
    before = _launches()
    got = knn_moments(*ops, k)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_knn_moments"] == 1
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
    before = _launches()
    got = knn_moments(*ops, k)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_knn_moments"] == 1
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
    # past 128 neighbors: the 2, 4 and 8 KB scratch classes
    "k129": (4, 8, 16, 1024, 129, {}),
    "k256_q_odd": (4, 2, 37, 256, 256, {}),
    "k1024": (2, 8, 16, 1024, 1024, {}),
    "under_k_k200": (4, 8, 8, 256, 200, {"sparse": True}),
    # past 1024 neighbors, the block class: its first k, k above every
    # window (9 * 256 positions), a hull past the tile, queries over the
    # whole 9 * 1024 window, bc * cap past the old 1024 slots a block (in
    # a warp class too)
    "k1025": (4, 8, 16, 1024, 1025, {}),
    "k2500_q_odd": (3, 2, 37, 256, 2500, {}),
    "hull_past_tile_k1100": (4, 8, 16, 1024, 1100, {"runs": "wide"}),
    "long_runs_k1100": (2, 4, 8, 224, 1100, {"runs": "long"}),
    "under_k_k1100": (4, 8, 8, 256, 1100, {"sparse": True}),
    "q1280_k20": (2, 8, 160, 1024, 20, {}),
    "q1280_k1100": (2, 8, 160, 1024, 1100, {}),
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
    before = _launches()
    d_k, r_k, c_k = knn_band_select(*ops, k=k, bc=bc, cap=cap, band=band,
                                    counts=counts)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_band_select"] == 1
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


@pytest.mark.parametrize("C,M,k,cached", [
    (64, 1064, 100, True),      # the 1M torus's k=100 buckets: 1 KB class
    (64, 1864, 128, False),     # past CACHE_BUDGET in the 1 KB class
    (248, 2136, 200, True),     # the 1M torus's largest k=200 bucket
    (1144, 11360, 1024, False),  # its largest k=1024 bucket
    (8, 5000, 1024, False),     # the 8 KB class past the card's 227 KB
    (1, 9000, 1024, True),      # one warp: 8 KB + 24 B a slot fit
    (2300, 22700, 2048, True),  # the block class: bits and keys fit
    (8, 60000, 2048, False),    # its bits past the budget: streamed
    (3, 24000, 20000, True),    # a 16,384-key tile beside the bits
    (3, 30000, 20000, False),   # past it
    (4, 1000, 4096, True),      # min(k, M) = M keys
])
def test_select_layout_classes(cuda, C, M, k, cached):
    """The layout each class takes (knn_warp.cuh's select_layout): 1 KB
    a warp up to k = 128 under a 100 KB budget, else 8·P bytes under the
    card's 227 KB a block; past k = 1024 the block class: its scratch,
    the query's bits and min(k, M) keys (at most a 16,384-key tile) under
    the same 227 KB."""
    from pct_tpu_torch.ops.select import select_layout

    mp = (M + 3) & ~3
    if k > 1024:
        keys = 8 * min(k, M, 16384)
        scratch = (4 * (256 + 8 + 2 + 32) + 15) & ~15
        staged = scratch + 4 * mp + keys
        assert (staged <= 227 * 1024) == cached
        assert select_layout(C, M, k) == (staged if cached
                                          else -(scratch + keys))
        return
    W = min(8, C)
    scr = 1024 if k <= 128 else 8 * max(256, 1 << (k - 1).bit_length())
    staged = W * scr + W * mp * 4 + mp * 20
    assert (staged <= (100 if k <= 128 else 227) * 1024) == cached
    assert select_layout(C, M, k) == (staged if cached else -W * scr)


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

    monkeypatch.setattr(tn, "_HIER_THRESHOLD", 2000)
    pts = _torus_cloud(5000)
    cloud = from_numpy(pts, device=cuda)
    plan = tn.plan_normals(cloud.points, cloud.num_points, k)
    assert plan.hierarchical
    want_rows = {}
    for kk, n in ((plan.kc, 1),
                  (plan.kv if k >= 32 else plan.k, len(plan.rows[0]))):
        want_rows[kk] = want_rows.get(kk, 0) + n
    before = _launches()
    got = tn.estimate_and_orient_normals(cloud, k=k,
                                         device=cuda)[:5000].cpu().numpy()
    launched = _launches() - before
    assert {key: n for key, n in launched.items()
            if key.startswith("pct_select_rows.k")} == {
        f"pct_select_rows.k{kk}": n for kk, n in want_rows.items()}
    assert launched["pct_knn_moments"] == (len(plan.moments[0]) if k >= 32
                                           else 0)
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
    from pct_tpu_torch.pipeline import create_mesh_with_curvature

    pts = _torus_cloud(5000)
    before = _launches()
    got = create_mesh_with_curvature(pts, device=cuda)
    launched = _launches() - before
    assert launched["pct_knn_moments"] > 0
    assert launched["pct_select_rows"] > 0
    assert launched["pct_select_coords"] > 0
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
    before = _launches()
    got = validate_cloud(pts, device=cuda, **kw)
    launched = _launches() - before
    assert launched["pct_select_coords"] > 0
    if mode == "mesh":
        assert launched["pct_knn_moments"] > 0
        assert launched["pct_select_rows"] > 0
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


# --- the distributed layer in a NCCL world of one ---------------------------

@pytest.fixture(scope="module")
def card_mesh():
    """``make_mesh()``: a NCCL world of one on cuda:0, destroyed after the
    module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import torch.distributed as dist

    from pct_tpu_torch.distributed import make_mesh

    mesh = make_mesh()
    yield mesh
    dist.destroy_process_group()


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("k", [20, 100], ids=["list", "moments"])
def test_sharded_curvature_world_of_one_bit_identical(card_mesh, k):
    """``sharded_curvature`` on ``plan_engine``'s layout of a 20k torus is
    ``fused_curvature`` on that layout bit for bit, with one launch a
    bucket of the moments kernel, or one a chunk of
    ``cellknn.list_select_cells`` cells of a bucket of the coords
    select (``cellknn.list_select_launches``)."""
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.distributed import sharded_curvature
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import estimate_cell_size
    from pct_tpu_torch.pipeline import fused_curvature
    from pct_tpu_torch.pipeline.fused import SPLIT_TO, plan_engine

    c = from_numpy(_torus_cloud(20000), device="cuda")
    cell = estimate_cell_size(c.points, c.num_points, k)
    engine, spec, mc, factor = plan_engine(
        build_grid(c.points, c.num_points, cell), k)
    assert engine == ("list" if k < 64 else "moments")
    kw = dict(bucket_spec=spec, max_cells=mc, engine=engine,
              split=(SPLIT_TO, factor))
    symbol = "pct_select_coords" if engine == "list" else "pct_knn_moments"
    launches = (cellknn.list_select_launches(spec) if engine == "list"
                else len(spec))
    before = _launches()
    got = sharded_curvature(card_mesh, c.points, c.num_points, cell, k, **kw)
    assert (_launches() - before)[symbol] == launches
    want = fused_curvature(c.points, c.num_points, cell, k, **kw)
    for a, b in zip((*got.curv, got.normals, got.exact, got.kth_dist),
                    (*want.curv, want.normals, want.exact, want.kth_dist)):
        assert _same_bits(a, b)
    assert float(got.stats.nan_fraction) == 0.0
    assert float(got.stats.mean_abs_K) > 0.5


def test_slab_world_of_one_matches_fused(card_mesh):
    """``slab_curvature_unsorted`` (probed halo, one coords launch a chunk
    of its one bucket) on the 20k torus: the distributed sort's result is
    the replicated sort's bit for bit; exact equals the un-bucketed
    ``fused_curvature`` on the same axis-permuted points and cell size,
    and K agrees to rtol 1e-5, atol 1e-7. The un-bucketed layout's
    default cell table is sized for a surface sampled like the analytic
    torus (tests/test_slab.py); on the perturbed torus of the tests above
    it overflows and certifies no row, in both paths alike."""
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.distributed import slab_curvature_unsorted
    from pct_tpu_torch.distributed.slab import best_axis_order, probe_slab_halo
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
    from pct_tpu_torch.pipeline import fused_curvature
    from pct_tpu_torch.shapes import generate_shape

    c = from_numpy(generate_shape("torus", 20000, radius=1.0)[0],
                   device="cuda")
    n = c.num_points
    order = best_axis_order(c.points, n)
    cell = estimate_cell_size(c.points, n, 20)
    halo = probe_slab_halo(build_grid(c.points[:, list(order)], n, cell), 1)
    (sp,), _ = cellknn.all_points_spec(c.points.shape[0] + 2 * halo, 20)
    chunks = cellknn.list_select_launches([sp])
    before = _launches()
    curv, nrm, ex = slab_curvature_unsorted(card_mesh, c, k=20)
    assert (_launches() - before)["pct_select_coords"] == chunks
    curv_d, nrm_d, ex_d = slab_curvature_unsorted(card_mesh, c, k=20,
                                                  distributed_sort=True)
    for a, b in zip((*curv, nrm, ex), (*curv_d, nrm_d, ex_d)):
        assert _same_bits(a, b)
    single = fused_curvature(c.points[:, list(order)], n, cell, 20)
    assert torch.equal(ex[:n], single.exact[:n])
    assert float(ex[:n].float().mean()) == 1.0
    assert torch.isclose(curv.K[:n], single.curv.K[:n], rtol=1e-5,
                         atol=1e-7).all()


# ---- the TPU scripts' kernels (pct_tpu_torch.micro) ------------------------

def _variant_tile(seed, T=6, C=40, M=300, case="random"):
    """Moments operands for the stage-split variants: ``lattice`` puts
    every point on a dyadic lattice (exact ties at the kth distance),
    duplicates query 0 under another id (d² = 0) and sends the last slot
    to x = 2⁶³ (d² = 2¹²⁶: the fixed-round searches stop unconverged);
    ``sparse`` leaves every row under k usable slots; ``empty`` makes
    every other tile's candidates all invalid; ``ties`` puts 80 copies
    of one point (always valid) behind 30 nearer slots and before the
    rest, and every query within 0.01 of the origin, so more than 64
    usable slots share each query's kth d² at k = 64 (the bracket never
    holds 32 slots or fewer, and the kernel never packs it). Past C = M
    the queries are drawn apart from the candidates."""
    rng = np.random.default_rng(seed)
    if case == "lattice":
        p = (rng.integers(0, 16, (T, M, 3)) * 2.0**-4).astype(np.float32)
    else:
        p = rng.standard_normal((T, M, 3)).astype(np.float32)
    q = p[:, :C].copy() if C <= M else rng.standard_normal(
        (T, C, 3)).astype(np.float32)
    if case == "ties":
        u = p / np.linalg.norm(p, axis=-1, keepdims=True)
        p = (u * rng.uniform(3.0, 4.0, (T, M, 1))).astype(np.float32)
        p[:, :30] = u[:, :30] * rng.uniform(0.2, 0.5, (T, 30, 1))
        p[:, 30:110] = (1.0, 0.0, 0.0)
        q = (rng.standard_normal((T, C, 3)) * 0.005).astype(np.float32)
    cand = np.tile(np.arange(M, dtype=np.int32), (T, 1))
    qrow = np.tile(np.arange(C, dtype=np.int32), (T, 1))   # self = slot c
    valid = (rng.random((T, M)) < (0.05 if case == "sparse" else 0.9)
             ).astype(np.int32)
    if case == "lattice":
        p[:, C + 1] = q[:, 0]
        p[:, -1, 0] = np.float32(2.0**63)
        valid[:, -1] = 1
    if case == "empty":
        valid[::2] = 0
    if case == "ties":
        valid[:, 30:110] = 1
    return q, p, cand, qrow, valid


VARIANT_MODES = ("full", "fixed26", "quad", "quad_fixed", "oct_fixed",
                 "interp4", "no_bisect", "no_moments", "no_am", "d2_only")


# (case, M, C): M on each side of the kernel's register classes (6, 8, 10
# bits a lane: M <= 192, 256, 320), in its shared-memory path (321, 1100)
# and past the shared-memory budget (2000: d² recomputed from device
# memory); C past M at the wrapper's largest C (512), whose query slots the
# register paths stage beside the row
VARIANT_CASES = ([("random", m, 40) for m in (40, 192, 193, 256, 257, 300,
                                              320, 321, 1100, 2000)]
                 + [("lattice", m, 40) for m in (300, 1100, 2000)]
                 + [("sparse", 300, 40), ("sparse", 1100, 40),
                    ("empty", 300, 40), ("ties", 300, 40), ("ties", 1100, 40),
                    ("random", 40, 512), ("random", 300, 512)])


@pytest.mark.parametrize("case,M,C", VARIANT_CASES)
@pytest.mark.parametrize("mode", VARIANT_MODES)
def test_moments_variant_kernel_matches_plain(cuda, mode, case, M, C):
    """Every stage-split mode against its plain version: columns 35–47
    bit for bit, the sums within count_le²·2⁻²⁴; ``tb`` = 1 and 4 give
    the same bits; ``full`` is knn_moments' kernel on columns 35–47."""
    from pct_tpu_torch.micro.moments_split import (
        moments_variant,
        moments_variant_plain,
        variant_info,
    )

    k = 64
    ops = [torch.from_numpy(a).to(cuda)
           for a in _variant_tile(len(mode) + 7, C=C, M=M, case=case)]
    before = _launches()
    got = moments_variant(*ops, k, mode=mode)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_moments_variant"] == 1
    if C > M:   # the register path; 12 C slots (a shape only the C entry
        # takes) would not fit its shared memory and go to device memory
        assert variant_info(C, M, mode)["path"] in (6, 10)
        assert variant_info(12 * C, M, mode)["path"] == -1
    want = moments_variant_plain(*ops, k, mode=mode)
    differing, ratio, _ = stats_agreement(got, want)
    assert differing == 0 and ratio <= 1.0, (differing, ratio)
    got4 = moments_variant(*ops, k, tb=4, mode=mode)
    assert torch.equal(got4.view(torch.int32), got.view(torch.int32))
    if mode == "full":
        differing, ratio, _ = stats_agreement(got, knn_moments(*ops, k))
        assert differing == 0 and ratio <= 1.0, (differing, ratio)
    if case == "lattice" and mode in ("fixed26", "quad_fixed"):
        full = moments_variant_plain(*ops, k)
        assert (got[..., 35] > full[..., 35]).any()   # stopped unconverged
    if case == "ties" and mode == "full":   # > 64 slots at every kth d²
        assert (want[..., 37] - want[..., 36] > 64).all()


def _mxu_tile(seed, T=16, C=40, M=300, case="random"):
    rng = np.random.default_rng(seed)
    if case == "lattice":
        p = ((rng.integers(-3, 4, (T, M, 3))) * 2.0**-3).astype(np.float32)
    else:
        p = rng.standard_normal((T, M, 3)).astype(np.float32)
    if case == "tiny":   # -0.0, values about 2^-110 and subnormals
        p[:, 0::4, 0] = -0.0
        p[:, 1::4, 1] *= np.float32(2.0**-110)
        p[:, 2::4, 2] = (p[:, 2::4, 2] * np.float32(2.0**-130)).astype(
            np.float32)
        p[:, 3::4] *= np.float32(2.0**-100)
    q = p[:, :C].copy() if C <= M else rng.standard_normal(
        (T, C, 3)).astype(np.float32)
    lo = (1 << 24) + 1 if case == "big_ids" else 0
    cand = np.stack([lo + rng.permutation(1 << 16)[:M] for _ in range(T)]
                    ).astype(np.int32)
    qrow = np.full((T, C), -1, np.int32)
    qrow[:, :min(C, M)] = cand[:, :C]
    valid = (rng.random((T, M)) < (0.03 if case == "sparse" else 0.9)
             ).astype(np.int32)
    return q, p, cand, qrow, valid


@pytest.mark.parametrize("case,k,T,C,M", [
    *[(case, k, 16, 40, 300)
      for case in ("random", "lattice", "sparse", "big_ids", "tiny")
      for k in (1, 20, 100)],
    ("random", 20, 8, 128, 504),      # the script's C and M
    ("random", 5, 16, 40, 17),        # M not a multiple of 16
    ("tiny", 20, 8, 128, 504),
    ("random", 128, 4, 1024, 504),    # C k past one group of positions
    ("lattice", 128, 4, 1024, 300),
    ("random", 20, 8, 37, 600),       # two chunks of B
    ("sparse", 20, 8, 40, 1100),
    ("random", 20, 4, 40, 2000),      # past the cache: the streamed rows
])
def test_select_coords_mxu_kernel_bit_identical(cuda, case, k, T, C, M):
    """The tensor-core extraction against the plain version, bit for bit
    on every slot (missing ones: slot 0's coordinates and id; -0.0 reads
    +0.0, subnormals and values below 2^-103 come back whole), and
    against the production coords select on distances and coordinates."""
    from pct_tpu_torch.micro.select_mxu import (
        select_coords_mxu,
        select_coords_mxu_plain,
    )

    seed = k + len(case) + abs(C + M - 340)
    ops = [torch.from_numpy(a).to(cuda)
           for a in _mxu_tile(seed, T, C, M, case=case)]
    before = _launches()
    got = select_coords_mxu(*ops, k, block_cells=4)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_select_coords_mxu"] == 1
    want = select_coords_mxu_plain(*ops, k)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    d_c, n_c = knn_select_coords(*ops, k)
    assert torch.equal(got[0].view(torch.int32), d_c.view(torch.int32))
    assert torch.equal(got[1], n_c)
    if case == "sparse" and k > 1:   # ~9 usable slots a row
        assert (got[0] > 1e18).any()
    if case == "big_ids":   # ids in (2^24, 2^24 + 2^16]: float32 keeps evens
        assert (ops[2] % 2 == 1).any() and (got[2] % 2 == 0).all()
    if case == "tiny":
        nz = got[1][got[1] != 0].abs()
        assert (nz < 2.0**-126).any() and (nz < 2.0**-103).any()
        assert (ops[1].view(torch.int32) == -2**31).any()   # -0.0 given
        assert not (got[1].view(torch.int32) == -2**31).any()


@pytest.mark.parametrize("T,C,M", [(8, 266, 1024), (3, 37, 512),
                                   (2, 1, 256), (1, 266, 256),
                                   (4, 37, 2048), (64, 266, 1024),
                                   (64, 1, 256), (1, 137, 2048)])
def test_moments_like_kernel_bit_identical(cuda, T, C, M):
    from pct_tpu_torch.micro.moments_like import (
        moments_like,
        moments_like_plain,
    )

    rng = np.random.default_rng(T * C + M)
    x = torch.from_numpy(rng.standard_normal((T, C, 256)).astype(
        np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((T, M, 256)).astype(
        np.float32)).to(cuda)
    before = _launches()
    got = moments_like(x, y)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_moments_like"] == 1
    want = moments_like_plain(x, y)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the arrival tickets are left zeroed: a second call finishes too
    again = moments_like(x, y)
    assert torch.equal(again.view(torch.int32), want.view(torch.int32))


def test_moments_like_kernel_takes_unaligned_views(cuda):
    """Views that start off the kernel's 16-byte copy grain are copied
    first: the result is the plain version's, bit for bit."""
    from pct_tpu_torch.micro.moments_like import (
        moments_like,
        moments_like_plain,
    )

    nx, ny = 2 * 37 * 256, 2 * 512 * 256
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.standard_normal(1 + nx + ny).astype(
        np.float32)).to(cuda)
    x = flat[1:1 + nx].view(2, 37, 256)
    y = flat[1 + nx:].view(2, 512, 256)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = moments_like(x, y)
    want = moments_like_plain(x, y)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---- the moments route's epilogue kernel ----------------------------------

def _epilogue_rows(seed):
    """(rows, 48) stats of several kinds, 4,069 rows (not a multiple of the
    kernel's 128-row block): the moments kernel's stats of random tiles
    (under-k and empty rows among them), Gaussian stats, all-zero padding
    rows, and exactly planar neighbourhoods whose normal is ±z."""
    rng = np.random.default_rng(seed)
    ops = [torch.from_numpy(a) for a in _tile(seed, 40, 64, 300,
                                               sparse=False)]
    ops[4][::5] = 0                                 # empty rows
    ops[4][1::5, 50:] = 0                           # under-k rows
    real = moments_plain(*ops, 20).reshape(-1, 48)
    gauss = torch.from_numpy(rng.standard_normal((1500, 48)).astype(
        np.float32))
    gauss[:, 0] = gauss[:, 0].abs() * 50.0
    g = np.arange(-2, 3) / 4.0
    x, y = (a.ravel() for a in np.meshgrid(g, g))
    plane = np.zeros((2, 48), np.float32)
    for r, sign in enumerate((1.0, -1.0)):     # the sign fix: +z, then -z
        for i, (a, b, c) in enumerate(MOMENT_EXPS):
            plane[r, i] = np.sum(x**a * y**b * 0.0**c)
        plane[r, 38] = 1.0
        plane[r, 44] = sign                         # kth − nearest along z
    return torch.cat([real, gauss, torch.zeros(7, 48),
                      torch.from_numpy(plane)]).contiguous()


def test_epilogue_kernel_bit_identical(cuda):
    """The kernel against ``epilogue_plain`` run on the card: the same
    bits on every column, padding rows' NaNs included."""
    stats = _epilogue_rows(11).to(cuda)
    before = _launches()
    got = moments_epilogue(stats)
    torch.cuda.synchronize()
    assert (_launches() - before)["pct_moments_epilogue"] == 1
    want = epilogue_plain(stats)
    assert torch.isnan(want[-9:-2, :5]).all()
    assert torch.equal(want[-2:, 5:].abs(), torch.tensor(
        [[0.0, 0.0, 1.0]] * 2, device=cuda))
    differing = (got.view(torch.int32) != want.view(torch.int32)).sum(0)
    assert differing.sum() == 0, differing.tolist()
    assert moments_epilogue(stats[:0]).shape == (0, 8)


def _kernel_names(fn):
    """The names of the CUDA kernels ``fn()`` launches, one per launch."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("Memcpy")
            and not e.name.startswith("Memset")]


@pytest.fixture(scope="module")
def torus_1m_epilogue():
    """A warm fast_curvature(k=100) on the 1M torus: the stats the
    epilogue got (every bucket's rows, padding slots included), the
    epilogue's launches in that call, the call's result, and the kernels
    of a profiled call, of its epilogue stage alone and of its cell-size
    estimate alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import pct_tpu_torch.pipeline.fused as fused
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.neighbors.grid import estimate_cell_size

    cloud = from_numpy(_torus_cloud(1_000_000), device="cuda")
    fused.fast_curvature(cloud, 100)
    seen = []
    orig = fused._moments_epilogue

    def spy(out):
        seen.append(out[0].clone())
        return orig(out)

    fused._moments_epilogue = spy
    try:
        before = _launches()
        res = fused.fast_curvature(cloud, 100)
        torch.cuda.synchronize()
        launches = (_launches() - before)["pct_moments_epilogue"]
    finally:
        fused._moments_epilogue = orig
    kernels = {
        "call": _kernel_names(lambda: fused.fast_curvature(cloud, 100)),
        "fit": _kernel_names(lambda: orig((seen[0],))),
        "cell_size": _kernel_names(lambda: estimate_cell_size(
            cloud.points, cloud.num_points, 100)),
    }
    return seen, launches, kernels, res


def test_epilogue_kernel_bit_identical_on_torus_1m(torus_1m_epilogue):
    """Every row of a 1M-point fast_curvature(k=100) call, in one
    ``post_fn`` call: the kernel's bits are the plain version's."""
    seen, launches, _, res = torus_1m_epilogue
    assert len(seen) == 1 and launches == 1
    stats = seen[0]
    assert stats.shape[0] > 1_000_000
    got = moments_epilogue(stats)
    want = epilogue_plain(stats)
    differing = (got.view(torch.int32) != want.view(torch.int32)).sum(0)
    assert differing.sum() == 0, differing.tolist()
    assert torch.isfinite(res.curv.K).all()


def test_fused_fit_is_one_launch_and_no_cublas(torus_1m_epilogue):
    """The fused k=100 call's fit stage (``pct.fit`` on the moments route)
    is the epilogue kernel alone, one launch; the call's only cuBLAS
    kernels are the cell-size estimate's (its sampled 1-NN distances)."""
    _, _, kernels, _ = torus_1m_epilogue
    assert len(kernels["fit"]) == 1 and "epilogue_kernel" in kernels["fit"][0]

    def blas(names):
        return [n for n in names
                if any(t in n.lower() for t in ("gemm", "cublas", "xmma"))]

    assert sum("epilogue_kernel" in n for n in kernels["call"]) == 1
    assert sorted(blas(kernels["call"])) == sorted(blas(kernels["cell_size"]))


# ---- the list engine's fit kernel -------------------------------------------

def _list_fit_rows(seed, k, rows=2_500):
    """(nbrs (rows, k, 3), qpts (rows, 3)), ``rows`` not a multiple of any
    block: Gaussian neighbourhoods about their queries, flattened along
    z and distance-sorted, at scales from 1e-3 to 1e2, and 5 all-zero
    padding rows."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, 3)).astype(np.float32)
    off = rng.standard_normal((rows, k, 3)) * np.array([1.0, 0.7, 0.1])
    off *= 10.0 ** rng.uniform(-3, 2, (rows, 1, 1))
    off = off[np.arange(rows)[:, None],
              np.argsort((off ** 2).sum(-1), axis=1, kind="stable")]
    nbrs = (q[:, None, :] + off).astype(np.float32)
    nbrs[-5:], q[-5:] = 0.0, 0.0
    return torch.from_numpy(nbrs), torch.from_numpy(q)


def _list_fit_guarded():
    """The CPU tests' guarded rows (tests/test_torch_list_fit.py), each
    (1, k, 3) about a query at the origin: padding, a lattice line whose
    last pivot dies, the isotropic +z fallback, the paraboloid with its
    normal on +z and on -z (the identity rotation)."""
    g = np.arange(-2, 3) / 4.0
    x, y = (a.ravel() for a in np.meshgrid(g, g))
    line = np.zeros((16, 3))
    line[:, 0] = np.resize([0.5, -0.5], 16)
    e = 0.5 * np.eye(3)
    iso = np.tile(np.stack([e[0], e[1], e[2], -e[1], -e[2], -e[0]]), (4, 1))
    par = np.stack([x, y, (x * x + y * y) / 2], 1)
    par = par[np.argsort(x * x + y * y, kind="stable")]
    return {"padding": np.zeros((25, 3)), "collinear": line,
            "isotropic": iso, "plus_z": par, "minus_z": par[::-1].copy()}


@pytest.mark.parametrize("k", [1, 16, 20, 100, 127, 128, 200, 1100])
def test_list_fit_kernel_bit_identical(cuda, k):
    """The kernel against ``list_fit_plain`` run on the card, every
    column's bits, in the staged variant (k <= 127: 128, 64 or 32 rows a
    block) and the streamed one (k >= 128, as the k=1100 list calls), on
    a 16-byte-aligned and an unaligned source."""
    from pct_tpu_torch.ops.list_fit import (
        list_fit,
        list_fit_layout,
        list_fit_plain,
    )

    nbrs, q = _list_fit_rows(24 + k, k, rows=2_500 if k <= 200 else 300)
    nbrs, q = nbrs.to(cuda), q.to(cuda)
    assert (list_fit_layout(k) > 0) == (k <= 127)
    buf = torch.empty(nbrs.numel() + 1, device=cuda)
    buf[1:] = nbrs.reshape(-1)
    for src in (nbrs, buf[1:].view(nbrs.shape)):
        before = _launches()
        got = list_fit(src, q)
        torch.cuda.synchronize()
        assert (_launches() - before)["pct_list_fit"] == 1
        want = list_fit_plain(src, q)
        differing = (got.view(torch.int32) != want.view(torch.int32)).sum(0)
        assert differing.sum() == 0, differing.tolist()
    assert torch.isfinite(want[-5:]).all()
    assert list_fit(nbrs[:0], q[:0]).shape == (0, 8)


@pytest.mark.parametrize("name", sorted(_list_fit_guarded()))
def test_list_fit_kernel_guarded_rows(cuda, name):
    from pct_tpu_torch.ops.list_fit import list_fit, list_fit_plain

    nbrs = torch.tensor(_list_fit_guarded()[name][None], dtype=torch.float32,
                        device=cuda)
    q = torch.zeros(1, 3, device=cuda)
    got = list_fit(nbrs, q)
    want = list_fit_plain(nbrs, q)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(want).all()


@pytest.fixture(scope="module")
def torus_1m_list():
    """A warm fast_curvature(k=20) on the 1M torus with ``list_fit``
    watched: every select's winners, queries and kernel output, the
    kernel's launches in that call, the call's spec, its result, and the
    kernels of a profiled call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import pct_tpu_torch.pipeline.fused as fused
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.neighbors.grid import estimate_cell_size
    from pct_tpu_torch.ops.list_fit import list_fit

    cloud = from_numpy(_torus_cloud(1_000_000), device="cuda")
    fused.fast_curvature(cloud, 20)
    cell = estimate_cell_size(cloud.points, cloud.num_points, 20)
    engine, spec, _, _ = fused.plan_engine(
        build_grid(cloud.points, cloud.num_points, cell), 20)
    assert engine == "list"
    seen = []

    def watched(nbrs, qpts):
        out = list_fit(nbrs, qpts)
        seen.append((nbrs.clone(), qpts.clone(), out.clone()))
        return out

    fused.list_fit = watched
    try:
        before = _launches()
        res = fused.fast_curvature(cloud, 20)
        torch.cuda.synchronize()
        launches = (_launches() - before)["pct_list_fit"]
    finally:
        fused.list_fit = list_fit
    kernels = _kernel_names(lambda: fused.fast_curvature(cloud, 20))
    return seen, launches, spec, res, kernels


def test_list_fit_kernel_bit_identical_on_torus_1m(torus_1m_list):
    """Every select of a 1M-point fast_curvature(k=20) call: the
    kernel's bits are the plain version's, one launch a select,
    ``cellknn.list_select_launches`` of them."""
    from pct_tpu_torch.neighbors import cellknn
    from pct_tpu_torch.ops.list_fit import list_fit_plain

    seen, launches, spec, res, _ = torus_1m_list
    assert launches == len(seen) == cellknn.list_select_launches(spec)
    assert sum(q.shape[0] * q.shape[1] for _, q, _ in seen) > 1_000_000
    for nbrs, qpts, got in seen:
        want = list_fit_plain(nbrs, qpts)
        differing = (got.view(torch.int32) != want.view(torch.int32)).sum(
            (0, 1))
        assert differing.sum() == 0, differing.tolist()
    assert torch.isfinite(res.curv.K).all()


def test_list_fit_is_one_launch_a_select(torus_1m_list):
    """The profiled k=20 call launches the list fit kernel once a coords
    select and no epilogue or moments kernel."""
    _, launches, _, _, kernels = torus_1m_list
    assert sum("list_fit_kernel" in n for n in kernels) == launches
    assert not any("epilogue_kernel" in n or "moments_kernel" in n
                   for n in kernels)


def test_implicit_list_route_launches_no_list_fit(cuda):
    """The implicit method keeps the eager chain on the list engine."""
    import pct_tpu_torch.pipeline.fused as fused
    from pct_tpu_torch.core import from_numpy

    cloud = from_numpy(_torus_cloud(100_000), device="cuda")
    before = _launches()
    res = fused.fast_curvature(cloud, 20, "implicit")
    torch.cuda.synchronize()
    launched = _launches() - before
    assert launched["pct_select_coords"] > 0
    assert launched["pct_list_fit"] == 0
    assert torch.isfinite(res.curv.K[:cloud.num_points]).all()
