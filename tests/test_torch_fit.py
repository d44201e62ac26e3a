"""Fit chain (eigh3, tangent frames, quadratic fit, Monge curvatures):
the port against the JAX package (rtol 1e-5, absolute parts scaled by
each quantity's magnitude) and against the float64 reference oracle.

Inputs are real k=20 neighborhoods of a torus (numpy brute-force kNN),
so the normal eigenvalue is well isolated, as on the main path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pct_tpu.curvature.explicit as jcurv
import pct_tpu.fit as jfit
from pct_tpu_torch.curvature.explicit import explicit_curvatures
from pct_tpu_torch.fit import (
    eigh3,
    fit_quadratic,
    smallest_eigvec3,
    tangent_frames,
)
from pct_tpu_torch.shapes import generate_shape
from tests.reference_oracle import reference_explicit_chain

RTOL = 1e-5


@pytest.fixture(scope="module")
def neighborhoods():
    _, pts = generate_shape("torus", 1200, perturbation_strength=0.002,
                            seed=4)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :20].astype(np.int32)
    centered = (pts[idx] - pts[:, None, :]).astype(np.float32)
    return pts, idx, centered


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_eigh3_matches_jax(neighborhoods):
    _, _, centered = neighborhoods
    x = centered - centered.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", x, x).astype(np.float32) / 19.0
    w_j, V_j = jfit.eigh3(jnp.asarray(cov))
    w_t, V_t = eigh3(torch.from_numpy(cov))
    _close(w_t.numpy(), w_j)
    # the isolated (normal) eigenvector agrees up to sign
    dots = np.abs(np.sum(V_t.numpy()[..., 0] * np.asarray(V_j)[..., 0], -1))
    np.testing.assert_allclose(dots, 1.0, atol=RTOL)
    lam_j, v_j = jfit.smallest_eigvec3(jnp.asarray(cov))
    lam_t, v_t = smallest_eigvec3(torch.from_numpy(cov))
    _close(lam_t.numpy(), lam_j)
    _close(v_t.numpy(), v_j)
    # orthonormal eigenbasis reconstructs the matrix
    V, w = V_t.numpy(), w_t.numpy()
    _close(np.einsum("nij,nj,nkj->nik", V, w, V), cov, rtol=1e-4)


@pytest.mark.parametrize("diag", [(1, 1, 1), (0, 0, 0), (1, 2, 3)])
def test_eigh3_degenerate_matches_jax(diag):
    A = np.diag(np.array(diag, np.float32))[None]
    w_j, V_j = jfit.eigh3(jnp.asarray(A))
    w_t, V_t = eigh3(torch.from_numpy(A))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    np.testing.assert_allclose(V_t.numpy(), np.asarray(V_j), atol=1e-6)


def test_frames_fit_curvature_match_jax(neighborhoods):
    _, _, centered = neighborhoods
    rot_j, R_j, n_j = jfit.tangent_frames(jnp.asarray(centered))
    rot_t, R_t, n_t = tangent_frames(torch.from_numpy(centered))
    _close(n_t.numpy(), n_j)
    _close(R_t.numpy(), R_j)
    _close(rot_t.numpy(), rot_j)
    # same rotated input on both sides isolates the fit
    rot = np.array(rot_j)
    c_j = jfit.fit_quadratic(jnp.asarray(rot))
    c_t = fit_quadratic(torch.from_numpy(rot)).numpy()
    for col in range(5):
        _close(c_t[:, col], np.asarray(c_j)[:, col])
    # F is the patch's height offset, ~0 by construction: its scale is
    # the neighborhood's height extent, not its own magnitude
    np.testing.assert_allclose(c_t[:, 5], np.asarray(c_j)[:, 5], rtol=0,
                               atol=RTOL * np.abs(rot[..., 2]).max())
    cv_j = jcurv.explicit_curvatures(c_j)
    cv_t = explicit_curvatures(torch.from_numpy(np.array(c_j)))
    for a, b in zip(cv_t, cv_j):
        _close(a.numpy(), b)


def test_chain_matches_float64_reference(neighborhoods):
    """Same bounds as the JAX package's own oracle test
    (tests/test_pipeline.py::test_explicit_pipeline_matches_reference_chain)."""
    pts, idx, centered = neighborhoods
    rot, _, normal = tangent_frames(torch.from_numpy(centered))
    curv = explicit_curvatures(fit_quadratic(rot))
    K, H = curv.K.numpy(), curv.H.numpy()
    K_ref, H_ref, n_ref = reference_explicit_chain(pts, idx)
    scale = np.abs(K_ref).max()
    assert np.median(np.abs(K - K_ref)) / scale < 1e-4
    assert np.quantile(np.abs(K - K_ref) / scale, 0.99) < 1e-2
    assert np.median(np.abs(H - H_ref)) / np.abs(H_ref).max() < 1e-4
    dots = np.sum(normal.numpy() * n_ref, axis=1)
    assert np.median(np.abs(dots)) > 0.9999
    assert (dots > 0).mean() > 0.99
