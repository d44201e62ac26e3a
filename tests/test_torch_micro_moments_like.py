"""The moments-shaped toy kernel of the port against the JAX script's
kernel, on the CPU.

``pct_tpu_torch.micro.moments_like.moments_like`` (its plain version
here) against the script ``scripts/repro_mosaic_cold.py``'s own
``_kernel`` run through ``pl.pallas_call(..., interpret=True)`` with the
script's block specs (its ``moments_like`` has no interpret flag), at
T=2 and the script's C=266, M=1024, CHUNK=256.

Tolerance: the JAX side's dot may block and contract its 256 products
into FMAs, the port's adds them one by one in k order, and the two sum
the 256 columns in different orders. Each dot is within 256·2⁻²⁴·P of
the exact one on either side (P = Σₖ|x y|, in float64), each sum over n
within 256·2⁻²⁴·Σ|term|, and the four chunk adds within 2⁻²⁴ of their
running total each; the test holds every column to twice the sum of
those bounds, per element.

The script sets JAX_COMPILATION_CACHE_DIR and makes a temporary
directory when it is imported; the test restores the environment and
removes the directory.
"""

import importlib.util
import os
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pct_tpu_torch.micro.moments_like import CHUNK, moments_like

ROOT = pathlib.Path(__file__).resolve().parent.parent
U = 2.0**-24


@pytest.fixture(scope="module")
def script():
    env = dict(os.environ)
    path = sys.path[:]
    spec = importlib.util.spec_from_file_location(
        "repro_mosaic_cold", ROOT / "scripts" / "repro_mosaic_cold.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        made = os.environ.get("JAX_COMPILATION_CACHE_DIR")
        os.environ.clear()
        os.environ.update(env)
        if made and made != env.get("JAX_COMPILATION_CACHE_DIR"):
            shutil.rmtree(made, ignore_errors=True)
    # the script puts its own root first on sys.path; gloo ranks spawned
    # later on this worker inherit sys.path, so it must not outlive the load
    assert sys.path == path
    return mod


@pytest.fixture(scope="module")
def results(script):
    """The operands, the port's output, the JAX kernel's, and per chunk
    the float64 product d and its absolute-value product P = |x| |y|ᵀ."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, script.C, script.CHUNK)).astype(np.float32)
    y = rng.standard_normal((2, script.M, script.CHUNK)).astype(np.float32)
    T = x.shape[0]
    want = np.asarray(pl.pallas_call(
        script._kernel,
        out_shape=jax.ShapeDtypeStruct((T, script.C, 128), jnp.float32),
        grid=(T,),
        in_specs=[pl.BlockSpec((1, script.C, script.CHUNK),
                               lambda t: (t, 0, 0)),
                  pl.BlockSpec((1, script.M, script.CHUNK),
                               lambda t: (t, 0, 0))],
        out_specs=pl.BlockSpec((1, script.C, 128), lambda t: (t, 0, 0)),
        interpret=True)(jnp.asarray(x), jnp.asarray(y)))
    got = moments_like(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    chunks = [(x64 @ yj.transpose(0, 2, 1),
               np.abs(x64) @ np.abs(yj).transpose(0, 2, 1))
              for yj in np.split(y64, y.shape[1] // CHUNK, axis=1)]
    return got, want, chunks


def _bound(chunks):
    """Per element of the (T, C, 128) output: twice the sum of the two
    sides' rounding bounds (module docstring)."""
    g = CHUNK * U
    tol = run = 0.0
    for d, P in chunks:
        e = 2 * g * P
        ad = np.abs(d)
        stat = np.stack([d.sum(-1), d.max(-1), (d * d).sum(-1),
                         ad.max(-1)], -1)
        run = run + np.abs(stat)
        tol = tol + np.stack([e.sum(-1) + 2 * g * ad.sum(-1), e.max(-1),
                              (2 * ad * e + e * e).sum(-1)
                              + 2 * g * (d * d).sum(-1), e.max(-1)], -1)
        tol = tol + 2 * U * run
    return 2 * np.repeat(tol, 32, axis=-1)


def test_moments_like_plain_matches_jax_kernel(results):
    got, want, chunks = results
    assert got.shape == want.shape == (2, 266, 128)
    err = np.abs(got.astype(np.float64) - want)
    tol = _bound(chunks)
    assert (err <= tol).all(), float((err / tol).max())
    # each statistic is the same over its 32 lanes
    for s in range(4):
        blk = got[..., 32 * s:32 * s + 32]
        assert (blk == blk[..., :1]).all()


def test_moments_like_stats_are_sums_over_chunks(results):
    """The "max" columns hold the sum of the chunks' maxima, the others
    the sums over all M rows of y: against float64 numpy."""
    got, _, chunks = results
    want = sum(np.stack([d.sum(-1), d.max(-1), (d * d).sum(-1),
                         np.abs(d).max(-1)], -1) for d, _ in chunks)
    tol = _bound(chunks)[..., ::32]
    assert (np.abs(got[..., ::32] - want) <= tol).all()
    # a maximum summed over 4 chunks exceeds the maximum of one of them
    assert (got[..., 32] > chunks[0][0].max(-1)).mean() > 0.99


def test_moments_like_checks_its_operands():
    x = torch.zeros(1, 4, CHUNK)
    with pytest.raises(ValueError, match="multiple"):
        moments_like(x, torch.zeros(1, 300, CHUNK))
    with pytest.raises(ValueError, match="expected"):
        moments_like(x, torch.zeros(1, 512, 128))
    with pytest.raises(ValueError, match="float32"):
        moments_like(x.double(), torch.zeros(1, 512, CHUNK).double())
    assert moments_like(x, torch.ones(1, 512, CHUNK)).shape == (1, 4, 128)
