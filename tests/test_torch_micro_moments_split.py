"""The moments stage-split variants of the port against the JAX script's
kernel, on the CPU.

``pct_tpu_torch.micro.moments_split.moments_variant`` (its plain version
here) against ``moments_variant(..., interpret=True)`` of the JAX
package's TPU script ``scripts/micro_moments_split.py``, mode by mode:

- on a dyadic lattice tile, where every d² is exact with or without FMA
  (as in tests/test_torch_moments.py), with exact ties, a duplicate of a
  query (d² = 0), one far candidate (d² = 2¹²⁶, so the fixed-round modes
  stop before they converge), under-k and empty rows: columns 35–47
  equal (by value: the script's masked sums may give −0.0 where the
  port gives +0.0), the 35 sums within count_le²·2⁻²⁴;
- on a random tile of the script's own recipe (``make_args``), where the
  JAX side may contract d² into FMAs: to the tolerances of
  tests/test_torch_moments.py's cell-tile test.

The script is loaded from its file with its compile-cache call patched
out, so the test worker's JAX configuration is left as it was.
"""

import importlib.util
import pathlib
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pct_tpu.utils.cache as jax_cache
from pct_tpu_torch.micro.moments_split import (
    MODES,
    SENT_BITS,
    moments_variant,
    search_tau,
)
from pct_tpu_torch.ops.moments import moments_plain, plain_d2, stats_agreement

ROOT = pathlib.Path(__file__).resolve().parent.parent
K = 8
FIXED = ("fixed26", "quad_fixed", "oct_fixed")


@pytest.fixture(scope="module")
def script():
    path = sys.path[:]
    try:
        with mock.patch.object(jax_cache, "enable_compilation_cache",
                               lambda *a, **kw: None):
            spec = importlib.util.spec_from_file_location(
                "micro_moments_split",
                ROOT / "scripts" / "micro_moments_split.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    # the script puts its own root first on sys.path; gloo ranks spawned
    # later on this worker inherit sys.path, so it must not outlive the load
    assert sys.path == path
    return mod


def _lattice_tile(T=4, C=8, M=64):
    """Integer coordinates scaled by 2⁻⁴ within ±6 steps of a base point
    (exact d², many exact ties); queries are the first C candidates
    (self-exclusion). Slot C + 1 duplicates query 0 under another id
    (d² = 0: lo0 = −1); the last slot sits at x = 2⁶³ (d² = 2¹²⁶ exactly:
    a bracket of ~2³¹ bit patterns). Tile 0 fully valid, tile 1 with 5
    valid slots (under-k rows), tile 2 with none, tile 3 80% valid."""
    rng = np.random.default_rng(11)
    base = rng.integers(8, 56, (T, 1, 3))
    p = ((base + rng.integers(-6, 7, (T, M, 3))) * 2.0**-4).astype(np.float32)
    q = p[:, :C].copy()
    p[:, C + 1] = q[:, 0]
    p[:, -1, 0] = np.float32(2.0**63)
    cand = np.stack([rng.permutation(4096)[:M] for _ in range(T)]
                    ).astype(np.int32)
    qrow = cand[:, :C].copy()
    valid = np.ones((T, M), np.int32)
    valid[1, 5:] = 0
    valid[1, -1] = 1
    valid[2] = 0
    valid[3] = rng.random(M) < 0.8
    valid[3, -1] = 1
    return q, p, cand, qrow, valid


def _t(tile):
    return [torch.from_numpy(np.array(a)) for a in tile]


@pytest.fixture(scope="module")
def lattice(script):
    """The lattice tile and the JAX script's output for every mode."""
    tile = _lattice_tile()
    jt = [jnp.asarray(a) for a in tile]
    want = {mode: np.asarray(script.moments_variant(*jt, K, tb=1, mode=mode,
                                                    interpret=True))
            for mode in MODES}
    return tile, want


@pytest.fixture(scope="module")
def random_tile(script):
    return [np.asarray(a) for a in script.make_args(4, 8, 64, seed=3)]


@pytest.mark.parametrize("mode", MODES)
def test_variant_plain_matches_jax_on_lattice(lattice, mode):
    tile, want = lattice
    got = moments_variant(*_t(tile), K, mode=mode)
    j = torch.from_numpy(np.array(want[mode]))
    np.testing.assert_array_equal(got[..., 35:].numpy(), want[mode][..., 35:])
    _, ratio, _ = stats_agreement(got, j)
    assert ratio <= 1.0, ratio
    if mode == "d2_only":
        np.testing.assert_array_equal(got[..., 0].numpy(), want[mode][..., 0])
        assert (got[..., 1:] == 0).all()
        # count at hi0: every usable slot (the query itself excluded)
        assert (got[1, :, 0] == torch.tensor([5.0] * 5 + [6.0] * 3)).all()
        return
    found = got[..., 45] > 0
    assert found[0].all() and not found[1].any() and not found[2].any()
    # under-k rows take the largest usable d², the far slot's 2^126
    assert (got[1, :, 35] == 2.0**126).all() and (got[2, :, 35] == 0).all()
    if mode in ("no_moments", "no_am"):
        assert (got[..., 39:45] == 0).all()
    if mode == "no_moments":
        assert (got[..., :35] == 0).all()
    full = want["full"][..., 35]
    if mode in FIXED + ("no_bisect",):
        # the search stops above the kth d²: the mode's own result
        assert (got[..., 35].numpy() != full).any()
    else:
        np.testing.assert_array_equal(got[..., 35].numpy(), full)
    if mode in ("fixed26", "quad_fixed"):
        # the found rows of tile 0 are bracketed, not converged: tau above
        # the kth d²
        assert (got[0, :, 35].numpy() > full[0]).any()


def test_fixed_round_modes_follow_the_integer_sequence(lattice):
    """The fixed-round τ bits are hi after the last round: one row worked
    by hand from its bracket, against the vectorised search."""
    tile, want = lattice
    _, d2, _ = plain_d2(*_t(tile))
    bits = d2.view(torch.int32)[0, 2]                    # one query row
    lo = int(bits.min()) - 1
    hi = int(torch.where(bits == SENT_BITS, -1, bits).max())
    for _ in range(26):
        mid = lo + (hi - lo) // 2
        if int((bits <= mid).sum()) >= K:
            hi = mid
        else:
            lo = mid
    got = search_tau(d2.view(torch.int32), K, "fixed26")[0, 2]
    assert int(got) == hi == int(np.float32(want["fixed26"][0, 2, 35])
                                 .view(np.int32))
    assert hi - lo > 1                     # not converged after 26 rounds


@pytest.mark.parametrize("mode", ["full", "quad", "interp4"])
def test_variant_plain_matches_jax_on_random_tile(script, random_tile, mode):
    jt = [jnp.asarray(a) for a in random_tile]
    want = np.asarray(script.moments_variant(*jt, K, tb=1, mode=mode,
                                             interpret=True))
    got = moments_variant(*_t(random_tile), K, mode=mode).numpy()
    assert (got[..., 45] > 0).mean() > 0.9
    np.testing.assert_array_equal(got[..., [36, 37, 45, 46, 47]],
                                  want[..., [36, 37, 45, 46, 47]])
    np.testing.assert_allclose(got[..., 35:45], want[..., 35:45], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got[..., :35], want[..., :35], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("which", ["lattice", "random"])
def test_full_variant_equals_moments_plain(lattice, random_tile, which):
    """The bisection lands on knn_moments' τ (its plain version takes it
    with torch.kthvalue): the same 48 columns bit for bit."""
    tile = lattice[0] if which == "lattice" else random_tile
    for mode in ("full", "quad", "interp4"):
        got = moments_variant(*_t(tile), K, mode=mode)
        want = moments_plain(*_t(tile), K)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_tb_changes_no_output(script, lattice):
    tile, want = lattice
    jt = [jnp.asarray(a) for a in tile]
    j3 = np.asarray(script.moments_variant(*jt, K, tb=3, mode="full",
                                           interpret=True))
    assert np.array_equal(j3.view(np.int32), want["full"].view(np.int32))
    t1 = moments_variant(*_t(tile), K, tb=1)
    t3 = moments_variant(*_t(tile), K, tb=3)
    assert torch.equal(t1.view(torch.int32), t3.view(torch.int32))


def test_moments_variant_checks_its_arguments(lattice):
    tile = _t(lattice[0])
    with pytest.raises(ValueError, match="mode"):
        moments_variant(*tile, K, mode="bisect")
    with pytest.raises(ValueError, match="tb"):
        moments_variant(*tile, K, tb=0)
    with pytest.raises(ValueError, match="positive"):
        moments_variant(*tile, 0)
    with pytest.raises(ValueError, match="int32"):
        moments_variant(*tile[:2], tile[2].long(), *tile[3:], K)
