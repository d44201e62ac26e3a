"""pct_tpu_torch — PyTorch/CUDA port of pct_tpu for NVIDIA Hopper (H100).

The JAX package ``pct_tpu`` stays the reference; this package mirrors its
sub-package layout (``core``, ``neighbors``, ``ops``, ``fit``,
``curvature``, ``pipeline``, ``shapes``) so each module's counterpart is
easy to find. It imports ``torch`` and ``numpy`` only.

Ported so far: the explicit method of
``pct_tpu_torch.pipeline.fused.fast_curvature(cloud, k)`` on both
engines. The list engine (k < 64) runs the select kernel
(``ops.select.knn_select_coords``, ``csrc/select_coords.cu``); the
moments engine (k >= 64, ``fused_curvature(engine="moments")``, and
smaller k where the JAX package's engine rule refuses the list engine)
runs the moments kernel (``ops.moments.knn_moments``,
``csrc/moments.cu``). Both kernels are hand-written CUDA C++ for
``sm_90a``, built with nvcc at first use. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper runs its plain PyTorch version instead.
"""

import torch

# TF32 keeps ~3 decimal digits: the Hopper twin of the TPU's bf16 matmul
# passes, which cost a 23% median K error at 1M points. Every float32
# matmul and convolution of the port runs in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
