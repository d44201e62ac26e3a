"""Figure and mesh viewers.

Parity with ref view_figs.py (unpickle + show every .pickle figure in a
directory) and view_meshes.py (render every mesh in mesh_snaps/).
Interactive display needs a display server; ``show=False`` re-exports
PNGs instead, which is what headless/CI environments get.
"""

from __future__ import annotations

import glob
import os
import pickle


def view_figs(fig_dir: str, show: bool = True, export_dir: str | None = None):
    """Load all pickled figures (ref view_figs.py:8-14)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figs = []
    for path in sorted(glob.glob(os.path.join(fig_dir, "*.pickle"))):
        with open(path, "rb") as f:
            fig = pickle.load(f)
        figs.append((path, fig))
        if export_dir:
            os.makedirs(export_dir, exist_ok=True)
            name = os.path.splitext(os.path.basename(path))[0]
            fig.savefig(os.path.join(export_dir, f"{name}.png"), dpi=120)
    if show and figs:
        plt.show()
    return [p for p, _ in figs]


def view_meshes(mesh_dir: str, pattern: str = "*.ply", show: bool = True):
    """Render meshes (ref view_meshes.py:4-28). Uses pyvista when
    importable; otherwise falls back to a matplotlib trisurf export."""
    paths = sorted(glob.glob(os.path.join(mesh_dir, pattern)))
    try:
        import pyvista as pv  # optional; not in the baked image

        for p in paths:
            mesh = pv.read(p)
            if show:
                mesh.plot()
        return paths
    except ImportError:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from pct_tpu_torch.io.ply import read_ply
        from pct_tpu_torch.io.vtk import read_vtk

        for p in paths:
            if p.lower().endswith(".vtk"):
                pts, faces, _ = read_vtk(p)
            else:
                d = read_ply(p)
                pts, faces = d.points, d.faces
            fig = plt.figure(figsize=(7, 6))
            ax = fig.add_subplot(111, projection="3d")
            if faces is not None and len(faces):
                ax.plot_trisurf(pts[:, 0], pts[:, 1], pts[:, 2],
                                triangles=faces, linewidth=0.1)
            else:
                ax.scatter(*pts[::max(1, len(pts) // 20000)].T, s=1)
            fig.savefig(p + ".png", dpi=120)
            plt.close(fig)
        return paths
