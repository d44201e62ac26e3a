"""The selects past 1024 neighbors, on the CPU, against the JAX package.

Past k = 1024 the port's kernels take their block class (one block a
query slot); on the CPU the same plain versions run as at any k. On a
2000-point torus (perturbed, one module-scoped cloud) at k = 1100 each
entry point runs once in each package (one module-scoped fixture), with
the rules of tests/test_torch_large_k.py:

- ``knn_cloud_grid``: every row exact after the repair in both
  packages; the distances within the grid's difference-form or the
  repair's expanded-form rounding bound of the float64 truth, the kth
  distance likewise; the id sets equal to the JAX package's and to the
  truth wherever the kth and (k+1)th true distances are apart by more
  than those bounds;
- ``fast_curvature(method="implicit")`` (the staged fallback) and
  ``curvature_pipeline``: tests/test_torch_implicit.py's rule on the
  rows whose neighbor id sets agree, and the normals within |dot| >=
  1 - 1e-5 of the JAX package's on those rows;
- ``compat.estimate_curvature(k_fraction=0.55, max_neighbors=1100)``
  (so that k = 1100): within 1e-4 of its largest value on the rows whose
  id sets agree;
- the band select's plain version at k = 1025 against the numpy sort of
  each query slot's window (tests/test_torch_band.py's ``numpy_band``),
  bit for bit.

The JAX side's neighbor lists are its ``curvature_pipeline``'s and its
``exact`` its implicit ``fast_curvature``'s, so that each JAX entry
point compiles once (~15-22 s each at this k).
"""

import numpy as np
import pytest
import torch

from pct_tpu import compat as jcompat
from pct_tpu_torch import compat
from pct_tpu_torch.experimental import build_row_blocks, knn_band_select
from pct_tpu_torch.experimental.band_knn import band_operands, default_band
from pct_tpu_torch.neighbors import cellknn
from pct_tpu_torch.neighbors.grid import build_grid
from pct_tpu_torch.shapes import generate_shape
from tests.test_torch_band import _cloud, numpy_band
from tests.test_torch_implicit import _compare
from tests.test_torch_large_k import N, _normals_agree, _run, _untied

K = 1100
FRACTION = K / N          # estimate_curvature's k = n·k_fraction = 1100


@pytest.fixture(scope="module")
def torus():
    return generate_shape("torus", N, perturbation_strength=1e-3,
                          seed=1)[1]


@pytest.fixture(scope="module")
def run(torus):
    """Both packages' entry points on the torus at k = 1100, and the
    float64 truth."""
    out = _run(torus, K)
    out["jax_est"] = np.asarray(jcompat.estimate_curvature(
        torus, k_fraction=FRACTION, max_neighbors=K))
    out["est"] = compat.estimate_curvature(
        torus, k_fraction=FRACTION, max_neighbors=K, device="cpu")
    return out


def _agree(run):
    """Rows whose neighbor id sets agree between the packages."""
    return (np.sort(run["knn"].indices[:N].numpy(), 1)
            == np.sort(run["jax_ids"], 1)).all(1)


def test_knn_cloud_grid_huge_k_matches_jax(run, torus):
    rt = run["knn"]
    assert rt.indices.shape[1] == K and rt.indices.shape[0] >= N
    assert rt.exact[:N].all() and np.asarray(run["jax_imp"].exact)[:N].all()
    assert rt.valid[:N].all()
    d_t = rt.dists[:N].numpy().astype(np.float64)
    d_true = run["d_true"][:, :K]
    bound, untied = _untied(run, torus, K)
    err = np.abs(d_t ** 2 - d_true ** 2)
    rel = np.abs(d_t - d_true) <= 1e-5 * d_true + 1e-6
    assert (rel | (err <= bound)).all()
    assert (np.diff(d_t, axis=1) >= 0).all()
    assert untied.mean() > 0.75     # 0.791 here: the bound grows with d
    ids_t = np.sort(rt.indices[:N].numpy(), 1)
    assert (ids_t == np.sort(run["jax_ids"], 1)).all(1)[untied].all()
    assert (ids_t == np.sort(run["i_true"][:, :K], 1)).all(1)[untied].all()


def test_fast_curvature_implicit_huge_k_matches_jax(run, torus):
    """The staged route: ``knn_cloud_grid`` + the implicit fit, ``exact``
    all True in both packages, the kth distance the kNN's."""
    rt, rj = run["imp"], run["jax_imp"]
    assert rt.exact[:N].all() and np.asarray(rj.exact)[:N].all()
    np.testing.assert_array_equal(rt.kth_dist[:N].numpy(),
                                  run["knn"].dists[:N, -1].numpy())
    idx_t = run["knn"].indices[:N].numpy()
    _compare("torus", torus, rt, rj, run["jax_ids"], idx_t, "implicit")
    _normals_agree(rt.normals, rj.normals, idx_t, run["jax_ids"])


def test_curvature_pipeline_huge_k_matches_jax(run, torus):
    rt, rj = run["pipe"], run["jax_pipe"]
    idx_t = rt.neighbor_indices[:N].numpy()
    assert idx_t.shape == (N, K)
    np.testing.assert_array_equal(idx_t, run["knn"].indices[:N].numpy())
    _compare("torus", torus, rt, rj, run["jax_ids"], idx_t, "explicit")
    _normals_agree(rt.normals, rj.normals, idx_t, run["jax_ids"])


def test_estimate_curvature_huge_k_matches_jax(run):
    st, sj = run["est"], run["jax_est"]
    assert st.shape == sj.shape == (N,) and (st >= 0).all()
    rows = _agree(run)
    assert rows.mean() >= 0.999
    np.testing.assert_allclose(st[rows], sj[rows], rtol=0,
                               atol=1e-4 * np.abs(sj).max())


@pytest.mark.parametrize("counts", [False, True], ids=["all_slots", "counts"])
def test_band_plain_huge_k_matches_numpy(counts):
    """k = 1025 on tests/test_torch_band.py's jittered torus (2500
    points, blocks of 8 cells, its first 16 blocks): every slot the numpy
    sort of its window; with the cells' counts the padding slots read
    the missing fill instead."""
    gt = build_grid(torch.from_numpy(_cloud("jitter")), 2500,
                    torch.tensor(np.float32(0.2)))
    cells, cap, _, _ = cellknn.probe_grid(gt)
    blocks = build_row_blocks(cells, 8)[:16 * 8]
    band = default_band(8, cap)
    ops, _, cnt, _ = band_operands(gt, cells, blocks, cap, 8, band)
    d, r, _ = knn_band_select(*ops, k=1025, bc=8, cap=cap, band=band,
                              counts=cnt if counts else None)
    want_d, want_r = numpy_band(ops, 1025, 8, cap, band)
    if counts:
        pad = (np.arange(cap) >= cnt.numpy()[..., None]).reshape(-1)
        want_d[pad] = torch.sqrt(torch.tensor(np.float32(3e38))).item()
        want_r[pad] = np.repeat(ops[3][:, 0].numpy(), 8 * cap)[pad, None]
        assert pad.any()
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(r.numpy(), want_r)
    assert (d < 1e18).any()
