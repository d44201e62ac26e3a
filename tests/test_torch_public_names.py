"""Every public name of a JAX-package module exists in the port's
counterpart module.

The walk covers each module of ``pct_tpu`` whose file has a counterpart
at the same path under ``pct_tpu_torch`` (sub-package ``__init__``s
included). A module's public names are the functions and classes it
defines and its upper-case constants; a package ``__init__``'s are also
what it re-exports from the package. The names in ``LEFT_OUT`` exist
only for the TPU or for XLA (ROADMAP.md, "Left out of the port").

A second walk holds the parameters of every public function and class
that both modules define: each parameter of the JAX package's signature
exists in the port's under its name, and a positional one sits at the
same position among the port's positional parameters (counted without
the parameters ``LEFT_OUT_PARAMS`` lists), unless the port takes it by
keyword only. The port may add keyword parameters of its own
(``device``, ``generator``) after the JAX package's.
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
    # a subcommand of the command line: it runs the JAX package's
    # bench.py; the port's benchmark file (ROADMAP.md, A15) does not
    # exist yet
    ("pct_tpu.cli", "bench"),
}


# Parameters that exist only for the TPU, Mosaic or XLA. A key (None,
# name) leaves the name out of every signature; (function, name) of one.
LEFT_OUT_PARAMS = {
    (None, "tile_cells"): "cells a Pallas grid step takes (the TPU block "
                          "plan); the port launches one warp a query",
    (None, "select_impl"): "the Pallas-or-XLA select choice; the port has "
                           "one select, the kernel and its plain version",
    (None, "scatter_strategy"): "the TPU scatter strategies of "
                                "_move_outputs; the port keeps 'invert'",
    (None, "dest_order"): "the destination order of the TPU scatter "
                          "strategies",
    (None, "interpret"): "Pallas interpret mode; on CPU tensors the port "
                         "runs each kernel's plain version",
    (None, "coarse"): "the coarse bucket layout, left out by decision "
                      "(ROADMAP.md, Documented divergences)",
    (None, "coarse_spec"): "the coarse bucket layout",
    (None, "max_buckets"): "a probe constant of the TPU compile budget "
                           "(the port's _MAX_BUCKETS)",
    (None, "size_unit"): "a probe constant of the TPU compile budget "
                         "(the port's _SIZE_UNIT)",
    (None, "pad_tiles_to"): "rounds a bucket's Pallas tiles to the device "
                            "count; the port has no tiles",
    (None, "demote_pallas"): "the working-set guards' Pallas-to-XLA "
                             "demotion",
    (None, "pack"): "_cand_pack's TPU row-count-bound gathers",
    (None, "_with_cert_parts"): "a private switch of the JAX knn_grid; "
                                "the port returns the parts from its own "
                                "_knn_grid_parts",
    ("knn_select", "block_cells"): "cells a Pallas select block takes",
    ("knn_select", "vmem_limit"): "the Mosaic scoped-VMEM limit",
    ("bucketed_tile_args", "k"): "feeds only the Mosaic working-set "
                                 "guards (_working_set_guards)",
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
                 "pct_tpu.validate.scans", "pct_tpu.pipeline.mesh_pipeline",
                 "pct_tpu.distributed.sharding", "pct_tpu.compat",
                 "pct_tpu.cli", "pct_tpu.viz", "pct_tpu.viz.plots",
                 "pct_tpu.viz.results", "pct_tpu.viz.view",
                 "pct_tpu.demos.explicit_surfaces_demo",
                 "pct_tpu.demos.implicit_surfaces_demo"):
        assert name in MODULES, name


@pytest.mark.parametrize("module", MODULES)
def test_public_names_exist_in_the_port(module):
    jax_mod = importlib.import_module(module)
    port = importlib.import_module("pct_tpu_torch" + module[len("pct_tpu"):])
    names = _public(jax_mod)
    missing = sorted(n for n in names - set(dir(port))
                     if (module, n) not in LEFT_OUT)
    assert not missing, f"{port.__name__} lacks {missing}"


def _cli_subcommands(module):
    """The subcommands a command line's ``main(["--help"])`` lists."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        importlib.import_module(module).main(["--help"])
    text = out.getvalue()
    return text[text.index("{") + 1:text.index("}")].split(",")


def test_cli_subcommands_exist_in_the_port():
    want = [c for c in _cli_subcommands("pct_tpu.cli")
            if ("pct_tpu.cli", c) not in LEFT_OUT]
    assert _cli_subcommands("pct_tpu_torch.cli") == want


def test_left_out_names_are_really_left_out():
    for module, name in sorted(LEFT_OUT):
        if module == "pct_tpu.cli":
            assert name in _cli_subcommands(module)
            assert name not in _cli_subcommands("pct_tpu_torch.cli")
            continue
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


_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _left_out(func, param):
    return (None, param) in LEFT_OUT_PARAMS or (func, param) in \
        LEFT_OUT_PARAMS


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _signature_pairs(module):
    """(name, JAX signature, port signature) of every public function
    and class both modules define, where both have a signature."""
    jax_mod = importlib.import_module(module)
    port = importlib.import_module("pct_tpu_torch" + module[len("pct_tpu"):])
    out = []
    for name in sorted(_public(jax_mod)):
        if name.isupper() or not hasattr(port, name):
            continue
        sj = _signature(getattr(jax_mod, name))
        sp = _signature(getattr(port, name))
        assert (sj is None) == (sp is None), (module, name)
        if sj is not None:
            out.append((name, sj, sp))
    return out


def _param_faults(name, sj, sp):
    jax_params = [p for p in sj.parameters.values()
                  if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
                  and not _left_out(name, p.name)]
    jax_pos = [p.name for p in jax_params if p.kind in _POSITIONAL]
    port_pos = [p.name for p in sp.parameters.values()
                if p.kind in _POSITIONAL]
    faults = []
    for p in jax_params:
        if p.name not in sp.parameters:
            faults.append(f"{name}: no {p.name!r}")
        elif (p.kind in _POSITIONAL
              and sp.parameters[p.name].kind in _POSITIONAL
              and port_pos.index(p.name) != jax_pos.index(p.name)):
            faults.append(f"{name}: {p.name!r} at position "
                          f"{port_pos.index(p.name)}, JAX "
                          f"{jax_pos.index(p.name)}")
    return faults


@pytest.mark.parametrize("module", MODULES)
def test_parameters_exist_in_the_port(module):
    faults = [f for pair in _signature_pairs(module)
              for f in _param_faults(*pair)]
    assert not faults, faults


def test_left_out_params_are_really_left_out():
    """Each entry of ``LEFT_OUT_PARAMS`` is a parameter of some JAX
    function with a counterpart, and no counterpart takes it."""
    used = set()
    for module in MODULES:
        for name, sj, sp in _signature_pairs(module):
            for param in sj.parameters:
                for key in ((None, param), (name, param)):
                    if key in LEFT_OUT_PARAMS:
                        assert param not in sp.parameters, (module, name,
                                                             param)
                        used.add(key)
    assert used == set(LEFT_OUT_PARAMS), set(LEFT_OUT_PARAMS) - used


@pytest.mark.parametrize("call", ["knn_cellwise_bucketed", "knn_cloud_grid",
                                  "curvature_from_moments",
                                  "curvature_from_moments_chunked"])
def test_c6_parameters(call):
    """The three C6 repairs: ``bucket_spec`` by name, ``tile`` at the
    JAX position of ``knn_cloud_grid``, ``rotation`` taken."""
    from pct_tpu_torch.fit import moments
    from pct_tpu_torch.neighbors import cellknn, knn

    fn = {"knn_cellwise_bucketed": cellknn.knn_cellwise_bucketed,
          "knn_cloud_grid": knn.knn_cloud_grid,
          "curvature_from_moments": moments.curvature_from_moments,
          "curvature_from_moments_chunked":
              moments.curvature_from_moments_chunked}[call]
    params = list(inspect.signature(fn).parameters)
    want = {"knn_cellwise_bucketed": ("bucket_spec", 3),
            "knn_cloud_grid": ("tile", 5),
            "curvature_from_moments": ("rotation", 4),
            "curvature_from_moments_chunked": ("rotation", 5)}[call]
    assert params.index(want[0]) == want[1]
