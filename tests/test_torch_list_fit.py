"""The list engine's explicit fit (``ops.list_fit``) on the CPU.

``list_fit_plain``, the plain version of ``csrc/list_fit.cu`` (which holds
it bit for bit on the card, tests/test_torch_cuda.py), against the JAX
package's chain (``pct_tpu.fit.frames.tangent_frames`` →
``fit_quadratic`` → ``explicit_curvatures``) and against the port's eager
``neighborhood_curvature``, on real torus and sphere neighbourhoods at
k=20 and k=100 and on rows that take the chain's guarded branches
(collinear lattice rows whose pivots die, a normal of exactly −z, an
isotropic row that falls back to +z, all-zero padding rows). Tolerances:
1e-5·max|x| for K, H, k1, k2, H² (k1 and k2 on the umbilic sphere:
√1e-5·max|x|, see ``_agree``) and 1e-5 for the normals, the port's
existing float32 tolerances against the JAX package
(tests/test_torch_fit.py, tests/test_torch_epilogue.py): every chain
rounds its own sums over the k slots in its own order, and a float32
fit amplifies the ~1e-7 relative differences by the normal equations'
conditioning. Then the wrapper's operand checks, and the list route's
selects: one ``list_fit`` call each on the explicit route, none on the
implicit route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pct_tpu.curvature.explicit as jcurv
import pct_tpu.fit.frames as jframes
import pct_tpu.fit.quadratic as jquad
import pct_tpu_torch.ops.list_fit as ops_list_fit
import pct_tpu_torch.pipeline.fused as fused
from pct_tpu_torch.core import from_numpy
from pct_tpu_torch.neighbors import cellknn
from pct_tpu_torch.neighbors.grid import build_grid, estimate_cell_size
from pct_tpu_torch.ops.list_fit import list_fit, list_fit_plain
from pct_tpu_torch.pipeline.curvature_pipeline import neighborhood_curvature
from pct_tpu_torch.shapes import generate_shape

TOL = 1e-5


def _jax_rows(centered: np.ndarray) -> np.ndarray:
    """The JAX package's list chain on (rows, k, 3) query-centred
    neighbourhoods, in the kernel's (rows, 8) layout."""
    rotated, _, normal = jframes.tangent_frames(jnp.asarray(centered))
    curv = jcurv.explicit_curvatures(jquad.fit_quadratic(rotated))
    return np.concatenate([np.stack([np.asarray(c) for c in curv], 1),
                           np.asarray(normal)], 1)


def _eager_rows(centered: np.ndarray) -> np.ndarray:
    curv, normal, _ = neighborhood_curvature(torch.from_numpy(centered))
    return torch.cat([torch.stack(list(curv), 1), normal], 1).numpy()


def _agree(got: np.ndarray, want: np.ndarray, umbilic: bool = False,
           floor: float = 0.0):
    """Within the tolerances above, each relative to max(max|x|, floor);
    on an ``umbilic`` cloud (the sphere, k1 = k2) k1 and k2 within
    √TOL·max|x|: k1, k2 = H ± √(H² − K), and the square root turns an
    error ε in H² − K ≈ 0 into √ε (the eager chain reads the same 1.6e-4
    and 5.7e-4 from the JAX package there)."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for c in range(5):
        b = want[:, c]
        tol = np.sqrt(TOL) if umbilic and c in (2, 3) else TOL
        np.testing.assert_allclose(got[:, c], b, rtol=0, atol=tol * np.abs(
            b[b == b]).max(initial=floor))
    np.testing.assert_allclose(got[:, 5:], want[:, 5:], rtol=0, atol=TOL)


def _plain(nbrs: np.ndarray, qpts: np.ndarray) -> np.ndarray:
    return list_fit_plain(torch.from_numpy(nbrs),
                          torch.from_numpy(qpts)).numpy()


def _neighbourhoods(shape: str, k: int):
    """(winners (n, k, 3), queries (n, 3)) of every point of a perturbed
    cloud, distance-sorted, by brute force."""
    if shape == "torus":
        pts = generate_shape("torus", 2500, perturbation_strength=1e-3,
                             seed=1)[1]
    else:
        pts = generate_shape("sphere", 2000, perturbation_strength=1e-3,
                             seed=2)[1]
    pts = pts.astype(np.float32)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.ascontiguousarray(pts[idx]), pts


@pytest.mark.parametrize("k", [20, 100])
@pytest.mark.parametrize("shape", ["torus", "sphere"])
def test_list_fit_plain_matches_jax_chain(shape, k):
    nbrs, qpts = _neighbourhoods(shape, k)
    got = _plain(nbrs, qpts)
    assert np.isfinite(got).all()
    _agree(got, _jax_rows(nbrs - qpts[:, None, :]), shape == "sphere")


@pytest.mark.parametrize("k", [20, 100])
@pytest.mark.parametrize("shape", ["torus", "sphere"])
def test_list_fit_plain_matches_eager_chain(shape, k):
    nbrs, qpts = _neighbourhoods(shape, k)
    _agree(_plain(nbrs, qpts), _eager_rows(nbrs - qpts[:, None, :]),
           shape == "sphere")


def _guarded(name: str) -> np.ndarray:
    """One (1, k, 3) query-centred neighbourhood taking a guarded branch."""
    g = np.arange(-2, 3) / 4.0
    x, y = (a.ravel() for a in np.meshgrid(g, g))
    if name == "padding":
        pts = np.zeros((25, 3))
    elif name == "collinear":
        # a lattice line, x = ±0.5 in turn: a² is the constant column, the
        # ridge rounds away on k = 16 and the fit's last pivot dies
        pts = np.zeros((16, 3))
        pts[:, 0] = np.resize([0.5, -0.5], 16)
    elif name == "isotropic":        # ±x, ±y, ±z at 0.5: the +z fallback,
        e = 0.5 * np.eye(3)          # +x first and −x last (no flip)
        pts = np.tile(np.stack([e[0], e[1], e[2], -e[1], -e[2], -e[0]]),
                      (4, 1))
    else:                            # the paraboloid, distance-sorted
        pts = np.stack([x, y, (x * x + y * y) / 2], 1)
        pts = pts[np.argsort(x * x + y * y, kind="stable")]
        if name == "minus_z":        # farthest minus nearest along −z
            pts = pts[::-1]
    return np.ascontiguousarray(pts[None], dtype=np.float32)


@pytest.mark.parametrize("name", ["padding", "collinear", "isotropic",
                                  "plus_z", "minus_z"])
def test_list_fit_plain_guarded_rows(monkeypatch, name):
    """Each row within the tolerances of 1 (its patch's curvature scale:
    the collinear row's K and H are rounding noise of ~1e-17). A normal of
    exactly −z keeps the identity rotation (the reference's quirk), so the
    paraboloid reads K = H = 1 under either normal."""
    pivots, real_solve = [], ops_list_fit._solve

    def solve(G, rhs):
        x, invd = real_solve(G, rhs)
        pivots.extend(float(d[0]) for d in invd)
        return x, invd

    monkeypatch.setattr(ops_list_fit, "_solve", solve)
    centered = _guarded(name)
    got = _plain(centered, np.zeros((1, 3), np.float32))
    assert np.isfinite(got).all()
    assert (0.0 in pivots) == (name == "collinear")
    _agree(got, _jax_rows(centered), floor=1.0)
    _agree(got, _eager_rows(centered), floor=1.0)
    if name in ("padding", "isotropic"):
        np.testing.assert_array_equal(got[0, 5:], [0.0, 0.0, 1.0])
    if name == "padding":
        np.testing.assert_array_equal(got[0, :5], 0.0)
    if name in ("plus_z", "minus_z"):
        sign = 1.0 if name == "plus_z" else -1.0
        np.testing.assert_allclose(got[0, 5:], [0.0, 0.0, sign], rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(got[0, :2], [1.0, 1.0], rtol=1e-5)


def test_list_fit_plain_takes_any_leading_shape():
    nbrs, qpts = _neighbourhoods("torus", 20)
    flat = _plain(nbrs[:240], qpts[:240])
    got = list_fit(torch.from_numpy(nbrs[:240]).reshape(4, 60, 20, 3),
                   torch.from_numpy(qpts[:240]).reshape(4, 60, 3))
    assert got.shape == (4, 60, 8)
    np.testing.assert_array_equal(got.reshape(240, 8).numpy(), flat)


@pytest.mark.parametrize("case", ["dtype", "shape", "query_shape",
                                  "contiguity", "device"])
def test_list_fit_rejects_bad_operands(case):
    nbrs = torch.zeros(6, 20, 3)
    qpts = torch.zeros(6, 3)
    if case == "dtype":
        nbrs = nbrs.double()
    elif case == "shape":
        nbrs = torch.zeros(6, 20, 4)
    elif case == "query_shape":
        qpts = torch.zeros(5, 3)
    elif case == "contiguity":
        nbrs = torch.zeros(6, 3, 20).transpose(1, 2)
    else:
        nbrs, qpts = nbrs.to("meta"), qpts.to("meta")
    with pytest.raises(ValueError):
        list_fit(nbrs, qpts)


@pytest.mark.parametrize("method", ["explicit", "implicit"])
def test_list_route_fits_each_select_once(monkeypatch, method):
    """``fast_curvature(k=20)`` on the list engine calls ``list_fit`` once
    a coords select on the explicit route, ``cellknn.
    list_select_launches`` of them, at select and fit-chunk budgets
    small enough that every bucket takes several selects; the implicit
    route calls it never and runs the eager chain a fit chunk at a time,
    with the outputs of the default budgets."""
    pts = generate_shape("torus", 4000, perturbation_strength=1e-3,
                         seed=1)[1]
    cloud = from_numpy(pts, device="cpu")
    whole = fused.fast_curvature(cloud, 20, method, device="cpu")
    monkeypatch.setattr(cellknn, "_FIT_QUERIES", 256)
    monkeypatch.setattr(cellknn, "_SELECT_CANDIDATES", 1 << 15)
    calls = []

    def counted(nbrs, qpts):
        calls.append(qpts.shape)
        return list_fit(nbrs, qpts)

    monkeypatch.setattr(fused, "list_fit", counted)
    cell = estimate_cell_size(cloud.points, cloud.num_points, 20)
    grid = build_grid(cloud.points, cloud.num_points, cell)
    engine, spec, _, _ = fused.plan_engine(grid, 20)
    assert engine == "list"
    res = fused.fast_curvature(cloud, 20, method, device="cpu")
    want = cellknn.list_select_launches(spec)
    assert want > len(spec)
    assert len(calls) == (want if method == "explicit" else 0)
    for got, ref in ((res.curv.K, whole.curv.K), (res.normals, whole.normals),
                     (res.exact, whole.exact)):
        assert torch.equal(got, ref)
