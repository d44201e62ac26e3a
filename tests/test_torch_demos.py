"""The port's demos (``pct_tpu_torch.demos``) against the JAX package's,
on the CPU: the same result dicts within float32 tolerance, and the JAX
tests' own sign and residual rules (tests/test_utils_demos.py).

The explicit demo's K and H agree within 2e-7 here, held to 1e-5 of the
largest |value|; the implicit demo's fit of an exact quadric leaves
float32 noise (its K at the first sample agrees within 3.1e-6 here),
held to 1e-5 absolute, and both packages' algebraic residuals stay below
1e-5.
"""

import numpy as np
import pytest

from pct_tpu.demos import explicit_surfaces_demo as jax_explicit
from pct_tpu.demos import implicit_surfaces_demo as jax_implicit
from pct_tpu_torch.demos import explicit_surfaces_demo, implicit_surfaces_demo


@pytest.fixture(scope="module")
def explicit_pair():
    return jax_explicit.run(), explicit_surfaces_demo.run(device="cpu")


@pytest.fixture(scope="module")
def implicit_pair():
    return jax_implicit.run(), implicit_surfaces_demo.run(device="cpu")


def test_explicit_demo_matches_jax(explicit_pair):
    want, got = explicit_pair
    assert list(got) == list(want) == list(explicit_surfaces_demo.SURFACES)
    scale = max(abs(v) for kh in want.values() for v in kh)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_explicit_demo_signs(explicit_pair):
    """tests/test_utils_demos.py::test_explicit_demo_signs on the port."""
    _, res = explicit_pair
    assert res["paraboloid"][0] > 0.5          # K > 0
    assert res["saddle"][0] < -0.5             # K < 0
    assert abs(res["saddle"][1]) < 0.05        # H ≈ 0
    assert abs(res["plane"][0]) < 1e-3
    assert abs(res["monkey_saddle"][0]) < 0.2  # flat at origin


def test_implicit_demo_matches_jax(implicit_pair):
    want, got = implicit_pair
    assert list(got) == list(want) == list(implicit_surfaces_demo
                                           .sample_surfaces())
    for name in want:
        (r_j, K_j), (r_t, K_t) = want[name], got[name]
        assert r_t < 1e-5 and r_j < 1e-5, name
        assert abs(K_t - K_j) <= 1e-5, name


def test_implicit_demo_residuals(implicit_pair):
    """tests/test_utils_demos.py::test_implicit_demo_residuals on the
    port."""
    _, res = implicit_pair
    for name in ("sphere", "cylinder", "plane"):
        assert res[name][0] < 1e-3, name       # exact quadrics fit tightly
    assert np.isclose(res["sphere"][1], 1 / 1.5**2, rtol=0.05)


@pytest.mark.parametrize("demo", ["explicit", "implicit"])
def test_demo_plots_write_the_jax_files(tmp_path, demo):
    """With an output directory both demos write the JAX package's PNG
    names (matplotlib only there)."""
    mods = {"explicit": (jax_explicit, explicit_surfaces_demo),
            "implicit": (jax_implicit, implicit_surfaces_demo)}[demo]
    for side, mod in zip(("jax", "port"), mods):
        kw = {} if side == "jax" else {"device": "cpu"}
        mod.run(str(tmp_path / side), **kw)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 5
