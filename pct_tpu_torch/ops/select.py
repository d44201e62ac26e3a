"""Fused neighborhood distance + k-nearest selection with winner coords.

Port of ``pct_tpu.ops.pallas_select.knn_select_coords`` (TPU kernel
``_select_coords_kernel``). Per cell row t, every query slot c takes
the exact difference-form squared distance to every candidate slot m —
no |q|²+|p|²−2qp expansion, so no cancellation — skips invalid slots and
itself (``cand == qrow``), and keeps the k nearest in ascending
(d², m) order (first-argmin on ties). It emits the distances and the
winners' coordinates, so no (T,C,k) winner gather follows. Missing
slots carry distance sqrt(3e38) and the coordinates of candidate slot 0;
callers test ``found = dists < 1e18``.

On CUDA tensors the hand-written kernel ``csrc/select_coords.cu`` runs
(built with nvcc at first use); on CPU tensors the plain PyTorch version
below, which does the same IEEE float32 operations in the same order, so
the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pct_tpu_torch.ops import build

MISSING_D2 = 3.0e38
KMAX = 63           # per-thread top-k list length in the kernel
MAX_QUERIES = 1024  # one thread per query slot, one block per cell row
_PLAIN_PAIRS = 1 << 24   # (rows × C × M) elements per plain-version chunk


def _plain_block(qpts, cpts, cand, qrow, valid, k: int):
    """The Pallas kernel's k rounds of min, first-argmin and mask-out
    over one (T,C,M) distance block."""
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    dx = qpts[:, :, None, 0] - cpts[:, None, :, 0]
    dy = qpts[:, :, None, 1] - cpts[:, None, :, 1]
    dz = qpts[:, :, None, 2] - cpts[:, None, :, 2]
    d2 = (dx * dx + dy * dy) + dz * dz                  # (T, C, M)
    ok = (valid[:, None, :] != 0) & (cand[:, None, :] != qrow[:, :, None])
    d2 = torch.where(ok, d2, MISSING_D2)
    iota = torch.arange(M, dtype=torch.int32, device=d2.device)
    dists = d2.new_empty((T, C, k))
    pos = torch.empty((T, C, k), dtype=torch.int64, device=d2.device)
    for j in range(k):
        mn = d2.min(dim=-1, keepdim=True).values
        am = torch.where(d2 == mn, iota, M).min(dim=-1, keepdim=True).values
        dists[..., j] = torch.sqrt(torch.clamp_min(mn[..., 0], 0.0))
        pos[..., j] = am[..., 0]
        d2.scatter_(-1, am.long(), MISSING_D2)
    nbrs = torch.gather(cpts, 1, pos.reshape(T, C * k, 1).expand(-1, -1, 3))
    return dists, nbrs.reshape(T, C, k, 3)


def select_coords_plain(qpts: torch.Tensor, cpts: torch.Tensor,
                        cand: torch.Tensor, qrow: torch.Tensor,
                        valid: torch.Tensor, k: int):
    """Plain PyTorch version of the kernel, in chunks of cell rows that
    bound the (rows, C, M) distance block.

    qpts (T,C,3), cpts (T,M,3) float32; cand (T,M), qrow (T,C), valid
    (T,M) int32. Returns (dists (T,C,k), nbrs (T,C,k,3)).
    """
    T, C, _ = qpts.shape
    if T == 0:
        return qpts.new_empty((0, C, k)), qpts.new_empty((0, C, k, 3))
    step = max(1, _PLAIN_PAIRS // max(C * cpts.shape[1], 1))
    parts = [_plain_block(*(a[s:s + step]
                            for a in (qpts, cpts, cand, qrow, valid)), k)
             for s in range(0, T, step)]
    return (torch.cat([d for d, _ in parts]),
            torch.cat([n for _, n in parts]))


def _check(qpts, cpts, cand, qrow, valid, k):
    if qpts.dim() != 3 or qpts.shape[2] != 3 or cpts.dim() != 3 \
            or cpts.shape[2] != 3 or cpts.shape[0] != qpts.shape[0]:
        raise ValueError(f"qpts (T,C,3) / cpts (T,M,3) expected, got "
                         f"{tuple(qpts.shape)} / {tuple(cpts.shape)}")
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    if M < 1:
        raise ValueError("cpts needs at least one candidate slot")
    for name, a, shape in (("cand", cand, (T, M)), ("qrow", qrow, (T, C)),
                           ("valid", valid, (T, M))):
        if tuple(a.shape) != shape or a.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if qpts.dtype != torch.float32 or cpts.dtype != torch.float32:
        raise ValueError("qpts and cpts must be float32")
    devs = {a.device for a in (qpts, cpts, cand, qrow, valid)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"k={k} outside [1, {KMAX}]")
    if not 1 <= C <= MAX_QUERIES:
        raise ValueError(f"{C} query slots outside [1, {MAX_QUERIES}]")


@functools.cache
def _library():
    lib = build.load("select_coords")
    fn = lib.pct_select_coords
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def knn_select_coords(qpts: torch.Tensor, cpts: torch.Tensor,
                      cand: torch.Tensor, qrow: torch.Tensor,
                      valid: torch.Tensor, k: int):
    """(T,C,3) queries vs (T,M,3) candidates -> (dists (T,C,k) ascending,
    nbrs (T,C,k,3) winner coordinates).

    ``cand`` (T,M) int32 candidate rows, ``qrow`` (T,C) int32 query rows
    (a candidate equal to the query's row is itself and is skipped),
    ``valid`` (T,M) int32 nonzero where the slot is real. CUDA tensors
    launch the kernel (``knn_select_coords.launches`` counts launches);
    CPU tensors run ``select_coords_plain``.
    """
    _check(qpts, cpts, cand, qrow, valid, k)
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    dev = qpts.device
    if dev.type == "cpu":
        return select_coords_plain(qpts, cpts, cand, qrow, valid, k)
    if dev.type != "cuda":
        raise ValueError(f"no select for device {dev}")
    for name, a in (("qpts", qpts), ("cpts", cpts), ("cand", cand),
                    ("qrow", qrow), ("valid", valid)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dists = torch.empty((T, C, k), dtype=torch.float32, device=dev)
    nbrs = torch.empty((T, C, k, 3), dtype=torch.float32, device=dev)
    if T == 0:
        return dists, nbrs
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qpts.data_ptr(), cpts.data_ptr(), cand.data_ptr(),
                 qrow.data_ptr(), valid.data_ptr(), dists.data_ptr(),
                 nbrs.data_ptr(), T, C, M, k, stream)
    if err != 0:
        raise RuntimeError(f"select_coords kernel launch failed: CUDA "
                           f"error {err}")
    knn_select_coords.launches += 1
    return dists, nbrs


knn_select_coords.launches = 0
