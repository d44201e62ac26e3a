"""A moments-shaped toy kernel: per-chunk products and their row stats.

Counterpart of ``moments_like`` in the JAX package's TPU script
``scripts/repro_mosaic_cold.py`` (its kernel ``_kernel``), which times a
kernel's cold first use; here that is nvcc plus the module load
(``scripts/torch_repro_cold_build.py``). For x (T, C, 256) and y (T, M,
256), M a multiple of 256, and each chunk j of 256 rows of y:

    d = x[t] @ y[t, 256 j : 256 j + 256]ᵀ                   (C × 256)
    out[t] += [Σ d, max d, Σ d², max |d|]  (each over the 256 columns,
                                            broadcast over 32 lanes)

from out = 0, chunk by chunk, so the "max" columns hold the sum of the
chunks' maxima. Returns (T, C, 128) float32.

On CUDA tensors ``csrc/moments_like.cu`` runs (an FP32 SIMT product
written by hand, built with nvcc at first use: units of 136 rows × the
128 columns of one residue mod 2 of a chunk, each finishing its part of
the column tree, and the last unit of a (tile, row slab) to arrive
adding the two residues and the chunks); on CPU tensors the plain
PyTorch version below. Both accumulate each dot in k order with every
product and sum rounded on its own (no FMA, no TF32), and both sum the
256 columns by the same halving tree (column i plus column i + h for h =
128, 64, ..., 1), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from pct_tpu_torch.ops import build

CHUNK = 256      # columns of a chunk's product, and the contraction depth
NOUT = 128       # 4 statistics × 32 lanes
MAX_TILES = 65535   # the kernel's grid takes one tile a block row


def _halving_sum(a: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis (a power of two) by the halving tree."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = a[..., :h] + a[..., h:]
    return a[..., 0]


def moments_like_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (T,C,256), (T,M,256) ->
    (T,C,128)."""
    T, C, K = x.shape
    out = x.new_zeros((T, C, NOUT))
    for j in range(y.shape[1] // CHUNK):
        yj = y[:, j * CHUNK:(j + 1) * CHUNK]
        d = x.new_zeros((T, C, CHUNK))
        for kk in range(K):       # each dot in k order, no FMA
            d += x[:, :, kk, None] * yj[:, None, :, kk]
        stats = (_halving_sum(d), d.amax(-1), _halving_sum(d * d),
                 d.abs().amax(-1))
        out = out + torch.cat([s[..., None].expand(T, C, 32) for s in stats],
                              dim=-1)
    return out


def _check(x, y):
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != CHUNK or y.shape[2] != CHUNK:
        raise ValueError(f"x (T,C,{CHUNK}) / y (T,M,{CHUNK}) expected, got "
                         f"{tuple(x.shape)} / {tuple(y.shape)}")
    if y.shape[1] < CHUNK or y.shape[1] % CHUNK:
        raise ValueError(f"M={y.shape[1]} must be a positive multiple of "
                         f"{CHUNK}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("x and y must be float32")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if x.shape[0] > MAX_TILES:
        raise ValueError(f"{x.shape[0]} tiles above {MAX_TILES}")


def _slabs(C: int) -> int:
    """Row slabs a tile of C query rows takes (one arrival ticket each)."""
    fn = build.load("moments_like").pct_moments_like_slabs
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(C)


_tickets: dict = {}


def _ticket(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The kernel's arrival tickets for one stream of one device: zeroed
    once, and every launch leaves them zeroed (the last unit of each
    (tile, row slab) sets its ticket back), so no call pays a fill."""
    key = (dev.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _tickets[key] = buf
    return buf


def moments_like(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(T,C,256), (T,M,256) -> (T,C,128) per-chunk row stats (module
    docstring). CUDA tensors launch the kernel once a call, the
    last-arriving units' finishing pass inside that launch; CPU tensors
    run ``moments_like_plain``."""
    _check(x, y)
    T, C, _ = x.shape
    dev = x.device
    if dev.type == "cpu":
        return moments_like_plain(x, y)
    out = torch.empty((T, C, NOUT), dtype=torch.float32, device=dev)
    if T == 0 or C == 0:
        return out
    # the kernel copies 16-byte pieces; a view may start off that grain
    x, y = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (x, y))
    M = y.shape[1]
    part = torch.empty(T * C * (M // CHUNK) * 2 * 4, dtype=torch.float32,
                       device=dev)
    ticket = _ticket(dev, build.stream(dev), T * _slabs(C))
    build.kernel("moments_like", "pct_moments_like")(x, y, out, part, ticket,
                                                     T, C, M)
    return out
