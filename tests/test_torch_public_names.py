"""Every public name of a JAX-package module exists in the port's
counterpart module.

The walk covers each module of ``pct_tpu`` whose file has a counterpart
at the same path under ``pct_tpu_torch`` (sub-package ``__init__``s
included). A module's public names are the functions and classes it
defines and its upper-case constants; a package ``__init__``'s are also
what it re-exports from the package. The names in ``LEFT_OUT`` exist
only for the TPU or for XLA (ROADMAP.md, "Left out of the port").
"""

import importlib
import inspect
import pathlib
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

LEFT_OUT = {
    # the Pallas-or-XLA select choice: the port has one select, the
    # kernel and its plain version
    ("pct_tpu.neighbors.cellknn", "default_select_impl"),
    # the Mosaic select's working-set model, ported under the name of
    # what it decides: cellknn.list_engine_ok
    ("pct_tpu.neighbors.cellknn", "pallas_select_ok"),
    # the un-bucketed cell loop: the port runs it as one bucket of
    # apply_cellwise_bucketed (all_points_spec, fused_curvature with
    # bucket_spec=None)
    ("pct_tpu.neighbors.cellknn", "apply_cellwise"),
    # the per-term rotation that keeps an XLA compile small (and the JAX
    # tests' oracle); the port has the one contraction, rotated_moments
    ("pct_tpu.fit.moments", "rotated_moments_symbolic"),
}


def _module_name(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _counterparts():
    out = []
    for path in sorted((ROOT / "pct_tpu").rglob("*.py")):
        port = ROOT / "pct_tpu_torch" / path.relative_to(ROOT / "pct_tpu")
        if port.exists():
            out.append(_module_name(path))
    return out


MODULES = _counterparts()


def _public(mod):
    package = hasattr(mod, "__path__")
    names = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        if name.isupper():
            names.add(name)
        elif inspect.isclass(obj) or callable(obj):
            home = getattr(obj, "__module__", None) or ""
            if home == mod.__name__ or (
                    package and home.startswith("pct_tpu.")):
                names.add(name)
    return names


def test_the_walk_covers_the_ported_modules():
    assert len(MODULES) >= 45
    for name in ("pct_tpu", "pct_tpu.fit", "pct_tpu.validate",
                 "pct_tpu.validate.harness", "pct_tpu.validate.sweep",
                 "pct_tpu.validate.scans", "pct_tpu.pipeline.mesh_pipeline"):
        assert name in MODULES, name


@pytest.mark.parametrize("module", MODULES)
def test_public_names_exist_in_the_port(module):
    jax_mod = importlib.import_module(module)
    port = importlib.import_module("pct_tpu_torch" + module[len("pct_tpu"):])
    names = _public(jax_mod)
    missing = sorted(n for n in names - set(dir(port))
                     if (module, n) not in LEFT_OUT)
    assert not missing, f"{port.__name__} lacks {missing}"


def test_left_out_names_are_really_left_out():
    for module, name in sorted(LEFT_OUT):
        assert name in _public(importlib.import_module(module))
        port = importlib.import_module(
            "pct_tpu_torch" + module[len("pct_tpu"):])
        assert not hasattr(port, name), (module, name)


def test_c5_names():
    import pct_tpu_torch
    import pct_tpu_torch.fit
    from pct_tpu_torch.core.cloud import PointCloud
    from pct_tpu_torch.fit.quadric import quadric_design

    assert pct_tpu_torch.PointCloud is PointCloud
    assert pct_tpu_torch.fit.quadric_design is quadric_design
