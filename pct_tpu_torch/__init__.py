"""pct_tpu_torch — PyTorch/CUDA port of pct_tpu for NVIDIA Hopper (H100).

The JAX package ``pct_tpu`` stays the reference; this package mirrors its
sub-package layout (``core``, ``neighbors``, ``ops``, ``fit``,
``curvature``, ``pipeline``, ``mesh``, ``shapes``, ``io``, ``validate``)
so each module's counterpart is easy to find. It imports ``torch``, ``numpy`` and, for
the hole fill's Delaunay triangulation, ``scipy``; nothing of JAX.

Ported so far:

- ``pipeline.fast_curvature(cloud, k, method)``, explicit and implicit.
  The list engine runs the coords select kernel
  (``ops.select.knn_select_coords``, ``csrc/select_coords.cu``); the
  moments engine (explicit, k >= 64, and smaller k where the JAX
  package's engine rule refuses the list engine) runs the moments kernel
  (``ops.moments.knn_moments``, ``csrc/moments.cu``); the implicit
  method falls back to the staged path where the list engine is refused.
- library kNN, ``neighbors.knn_cloud_grid`` (plus ``knn_grid``,
  ``ball_grid``), which runs the rows select kernel
  (``ops.select.knn_select_rows``, ``csrc/select_rows.cu``, which also
  holds the positions kernel of ``ops.select.knn_select``);
- the staged ``pipeline.curvature_pipeline``;
- the device half of the mesh module: ``mesh.estimate_and_orient_normals``
  (raw normals from the moments kernel at k >= 32 or the rows kernel
  below, voters and the hierarchical coarse graph from the rows kernel),
  ``mesh.taubin_smooth``, ``mesh.mesh_energies`` with the vertex
  curvatures, and ``mesh.voxel_downsample``;
- the mesh path, ``pipeline.create_mesh_with_curvature`` (normals → ball
  pivoting → hole filling → Taubin → vertex curvature → energies), with
  its host half: ``mesh.boundary`` (numpy/scipy), ``mesh.reconstruct``
  (the C++ ball pivoting of ``native/bpa.cpp``, built with g++ at first
  use) and the file formats of ``io`` (``load_points``, PLY, VTK, txt,
  ASC);
- the analytic shapes and oracles of ``shapes`` (own numpy copies);
- the validation protocol, ``validate`` (``validate_cloud``,
  ``run_sweep``, ``run_scans``), which drives the paths above.

The kernels are hand-written CUDA C++ for ``sm_90a``, built with nvcc at
first use. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""

import torch

# TF32 keeps ~3 decimal digits: the Hopper twin of the TPU's bf16 matmul
# passes, which cost a 23% median K error at 1M points. Every float32
# matmul and convolution of the port runs in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from pct_tpu_torch.core.cloud import PointCloud  # noqa: E402,F401
