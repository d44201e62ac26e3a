"""Counterparts of the JAX package's TPU scripts' kernels.

The modules here are not ports of package modules: each holds the kernel
of one TPU stage-timing or A/B script under ``scripts/`` (the JAX
package's ``scripts/micro_moments_split.py``, ``micro_select_mxu.py`` and
``repro_mosaic_cold.py``), with its wrapper and its plain PyTorch
version, and no entry point of the port reaches them. Their own scripts
are ``scripts/torch_micro_moments_split.py``,
``scripts/torch_micro_select_mxu.py`` and
``scripts/torch_repro_cold_build.py``.

- ``moments_split.moments_variant``: the moments kernel with its τ search
  swapped or passes switched off (``csrc/moments_split.cu``);
- ``select_mxu.select_coords_mxu``: the coords select with the winner
  extraction as a one-hot matrix product on the tensor cores
  (``csrc/select_mxu.cu``);
- ``moments_like.moments_like``: a moments-shaped toy kernel, per-chunk
  products and their row statistics (``csrc/moments_like.cu``).
"""

from pct_tpu_torch.micro.moments_like import moments_like  # noqa: F401
from pct_tpu_torch.micro.moments_split import moments_variant  # noqa: F401
from pct_tpu_torch.micro.select_mxu import select_coords_mxu  # noqa: F401
