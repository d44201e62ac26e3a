"""Mesh operations of the port: normals and their orientation, Taubin
smoothing, energy integrals and vertex curvatures, voxel downsampling
(the device half of ``pct_tpu.mesh``), and the host half: boundary loops
and hole filling (``boundary``), ball pivoting and its radii
(``reconstruct``, first-party C++ built with g++ at first use)."""

from pct_tpu_torch.mesh.energies import (  # noqa: F401
    MeshEnergies,
    mesh_energies,
    mesh_vertex_curvatures,
    triangle_areas,
    vertex_areas,
)
from pct_tpu_torch.mesh.smooth import taubin_smooth, mesh_edges  # noqa: F401
from pct_tpu_torch.mesh.boundary import (  # noqa: F401
    boundary_edges,
    detect_boundary_loops,
    fill_small_holes,
    is_planar,
)
from pct_tpu_torch.mesh.downsample import voxel_downsample  # noqa: F401
from pct_tpu_torch.mesh.normals import (  # noqa: F401
    estimate_and_orient_normals,
    estimate_raw_normals,
    orient_normals,
)
