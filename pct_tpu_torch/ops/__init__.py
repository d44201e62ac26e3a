"""Kernels of the port and their build (``csrc/*.cu`` via nvcc)."""
