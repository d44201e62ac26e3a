"""Kernels of the port and their build (``csrc/*.cu`` via nvcc)."""

from pct_tpu_torch.ops.select import knn_select  # noqa: F401
