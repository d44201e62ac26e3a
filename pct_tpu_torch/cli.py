"""Command line of the port: the JAX package's subcommands (its
``pct_tpu.cli``) on ``pct_tpu_torch``:

  pct-tpu-torch sweep        analytic-shape validation sweep  (main_shape_validation.py)
  pct-tpu-torch scans        batch-validate real scans        (main_scans.py)
  pct-tpu-torch curvature    one cloud -> curvature-colored PLY
  pct-tpu-torch convert      .asc -> .ply with voxel downsample (convert_asc_to_ply.py)
  pct-tpu-torch downsample   voxel-downsample clouds           (downsample.py)
  pct-tpu-torch strip-normals remove normals from a PLY        (ply_remove_normals.py)
  pct-tpu-torch view-figs    open/export pickled figures       (view_figs.py)
  pct-tpu-torch view-meshes  render meshes                     (view_meshes.py)
  pct-tpu-torch plot-results sweep CSV analysis plots          (plot_shape_validation_results.py)
  pct-tpu-torch reconstruct  mesh a cloud (BPA pipeline)

``curvature``, ``downsample`` and ``reconstruct`` take ``--device``
(default ``cuda``; without a card they raise unless given ``--device
cpu``); ``sweep`` and ``scans`` take it through their own options. The
figure commands need matplotlib. The JAX package's ``bench`` has no
counterpart yet: the port has no benchmark file.

Run as `python -m pct_tpu_torch.cli <cmd> ...`.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_curvature(args):
    import numpy as np

    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.io import load_points, write_ply
    from pct_tpu_torch.pipeline import curvature_pipeline

    pts, _ = load_points(args.input)
    cloud = from_numpy(pts, device=args.device)
    r = curvature_pipeline(cloud, k=args.k, method=args.method,
                           device=cloud.points.device)
    n = int(cloud.num_points)
    K = r.curv.K[:n].cpu().numpy()
    H = r.curv.H[:n].cpu().numpy()
    write_ply(args.output, pts, r.normals[:n].cpu().numpy(),
              vertex_props={"gaussian_curvature": K, "mean_curvature": H})
    print(f"{args.input}: {n} points -> {args.output} "
          f"(K median {np.nanmedian(K):.4g}, H median {np.nanmedian(H):.4g})")


def _cmd_convert(args):
    from pct_tpu_torch.io import convert_asc_to_ply

    n = convert_asc_to_ply(args.input, args.output, args.voxel_size)
    print(f"{args.input} -> {args.output} ({n} points)")


def _cmd_downsample(args):
    from pct_tpu_torch.core import from_numpy
    from pct_tpu_torch.io import load_points, write_ply
    from pct_tpu_torch.mesh.downsample import voxel_downsample

    pts, _ = load_points(args.input)
    cloud = from_numpy(pts, device=args.device)
    out, kept = voxel_downsample(cloud.points, cloud.num_points,
                                 args.voxel_size,
                                 max_per_voxel=args.max_per_voxel,
                                 mode=args.mode)
    kept = int(kept)
    write_ply(args.output, out[:kept].cpu().numpy())
    print(f"{args.input}: {int(cloud.num_points)} -> {kept} points")


def _cmd_strip(args):
    from pct_tpu_torch.io import strip_normals

    strip_normals(args.input, args.output)
    print(f"{args.input} -> {args.output}")


def _cmd_view_figs(args):
    from pct_tpu_torch.viz import view_figs

    paths = view_figs(args.dir, show=not args.export,
                      export_dir=args.export)
    print(f"{len(paths)} figures")


def _cmd_view_meshes(args):
    from pct_tpu_torch.viz import view_meshes

    paths = view_meshes(args.dir, pattern=args.pattern, show=not args.headless)
    print(f"{len(paths)} meshes")


def _cmd_plot_results(args):
    from pct_tpu_torch.viz import (
        load_results,
        plot_curvature_histograms,
        plot_error_scatter,
    )

    rows = load_results(args.csv)
    plot_error_scatter(rows, args.out)
    if args.curvature_dir:
        plot_curvature_histograms(args.curvature_dir, args.out)
    print(f"{len(rows)} rows plotted -> {args.out}")


def _cmd_reconstruct(args):
    from pct_tpu_torch.io import load_points
    from pct_tpu_torch.pipeline.mesh_pipeline import create_mesh_with_curvature

    pts, _ = load_points(args.input)
    m = create_mesh_with_curvature(pts, k_neighbors=args.k,
                                   smooth_iterations=args.smooth,
                                   save_mesh_path=args.output,
                                   device=args.device)
    e = m.energies
    print(f"{args.input}: {len(pts)} points -> {args.output} "
          f"({len(m.faces)} faces, {m.n_holes_filled} holes filled, "
          f"area {e.total_area:.4g}, bending {e.bending:.4g}, "
          f"stretching {e.stretching:.4g})")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # sweep/scans own their full option set — delegate before argparse
    # (argparse.REMAINDER cannot capture option-like tokens reliably)
    if argv and argv[0] == "sweep":
        from pct_tpu_torch.validate import sweep

        return sweep.main(argv[1:])
    if argv and argv[0] == "scans":
        from pct_tpu_torch.validate import scans

        return scans.main(argv[1:])

    p = argparse.ArgumentParser(prog="pct-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("sweep", help="analytic-shape validation sweep")
    sub.add_parser("scans", help="batch-validate real scans")

    def device_option(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "kernels' plain versions)")

    sp = sub.add_parser("curvature")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--k", type=int, default=20)
    sp.add_argument("--method", choices=["explicit", "implicit"],
                    default="explicit")
    device_option(sp)
    sp.set_defaults(fn=_cmd_curvature)

    sp = sub.add_parser("convert")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--voxel-size", type=float, default=None)
    sp.set_defaults(fn=_cmd_convert)

    sp = sub.add_parser("downsample")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--voxel-size", type=float, required=True)
    sp.add_argument("--max-per-voxel", type=int, default=1)
    sp.add_argument("--mode", choices=["first", "centroid"], default="first")
    device_option(sp)
    sp.set_defaults(fn=_cmd_downsample)

    sp = sub.add_parser("strip-normals")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.set_defaults(fn=_cmd_strip)

    sp = sub.add_parser("view-figs")
    sp.add_argument("dir")
    sp.add_argument("--export", default=None)
    sp.set_defaults(fn=_cmd_view_figs)

    sp = sub.add_parser("view-meshes")
    sp.add_argument("dir")
    sp.add_argument("--pattern", default="*.ply")
    sp.add_argument("--headless", action="store_true")
    sp.set_defaults(fn=_cmd_view_meshes)

    sp = sub.add_parser("plot-results")
    sp.add_argument("csv")
    sp.add_argument("--out", default="plots")
    sp.add_argument("--curvature-dir", default=None)
    sp.set_defaults(fn=_cmd_plot_results)

    sp = sub.add_parser("reconstruct", help="mesh a cloud (BPA pipeline) "
                        "-> .ply/.vtk with curvature scalars")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--k", type=int, default=20)
    sp.add_argument("--smooth", type=int, default=10)
    device_option(sp)
    sp.set_defaults(fn=_cmd_reconstruct)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
