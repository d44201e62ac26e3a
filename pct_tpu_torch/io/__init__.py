"""Point-cloud and mesh file formats: whitespace text, PLY (ASCII and
binary), ASC scans and legacy VTK.

Port of ``pct_tpu.io``: the same numpy readers and writers (the same
arrays write the same bytes), importing neither torch nor JAX.
"""

from pct_tpu_torch.io.txt import read_txt, write_txt  # noqa: F401
from pct_tpu_torch.io.ply import read_ply, write_ply, strip_normals, PlyData  # noqa: F401
from pct_tpu_torch.io.asc import read_asc, voxel_downsample_first, convert_asc_to_ply  # noqa: F401
from pct_tpu_torch.io.vtk import read_vtk, write_vtk  # noqa: F401


def load_points(path: str, **kw):
    """Dispatch on extension; returns (points, normals|None) numpy arrays."""
    low = path.lower()
    if low.endswith(".ply"):
        d = read_ply(path)
        return d.points, d.normals
    if low.endswith(".asc"):
        return read_asc(path), None
    return read_txt(path, **kw)
