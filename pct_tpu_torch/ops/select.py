"""Fused neighborhood distance + k-nearest selection.

Port of the three select kernels of ``pct_tpu.ops.pallas_select``. Per
cell row t, every query slot c takes the exact difference-form squared
distance to every candidate slot m — no |q|²+|p|²−2qp expansion, so no
cancellation — skips invalid slots and itself (``cand == qrow``), and
keeps the k nearest in ascending (d², m) order (first-argmin on ties).
The three wrappers differ only in what they emit beside the distances:

- ``knn_select_coords`` (``_select_coords_kernel``): the winners'
  coordinates ``cpts[pos]``, so no (T,C,k) winner gather follows;
- ``knn_select_rows`` (``_select_rows_kernel``): the winners' ids
  ``cand[pos]``;
- ``knn_select`` (``_select_kernel``): the winners' positions ``pos`` in
  the M axis.

Missing slots carry distance sqrt(3e38) and position 0 (so the
coordinates of candidate slot 0, and the id ``cand[t, 0]``); callers
test ``found = dists < 1e18``. The selects keep at most ``KMAX`` = 1024
neighbors (the Pallas kernels take any k); above it every wrapper
raises ``ValueError``. 1024 is where the kernels' per-warp scratch
stops: 8 KB of sort keys a warp, 64 KB for a block of 8 warps, before
the row is staged. Library kNN, the staged pipeline, the implicit
fallback and ``compat.estimate_curvature`` reach the selects at any k
up to it.

On CUDA tensors the hand-written kernels run (``csrc/select_coords.cu``
and ``csrc/select_rows.cu``, one design in ``csrc/knn_warp.cuh``: one
block per cell row stages the row, one warp per query slot computes d²
once, radix-selects the kth and sorts the winners, and only the
emitted outputs differ; built with nvcc at first use; the warp's
scratch and the block's shared-memory budget are classes chosen by k,
``select_layout`` tells which layout a shape takes); on CPU tensors
the plain PyTorch versions below, which do the same IEEE float32
operations in the same order, so the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pct_tpu_torch.ops import build

MISSING_D2 = 3.0e38
KMAX = 1024         # the winner keys a warp sorts (8 KB of its scratch)
MAX_QUERIES = 4 * KMAX  # query slots of a cell row: the probes cap a
                        # bucket's capacity at max(256, 4k); one block a
                        # row, its warps take the slots in turn
_PLAIN_PAIRS = 1 << 24  # (rows × C × max(M, k)) elements a plain chunk


def _plain_block(qpts, cpts, cand, qrow, valid, k: int):
    """The Pallas kernels' k rounds of min, first-argmin and mask-out
    over one (T,C,M) distance block -> (dists (T,C,k), pos (T,C,k)
    int64)."""
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
    return dists, pos


def _plain(qpts, cpts, cand, qrow, valid, k: int, emit):
    """Plain version of a select, in chunks of cell rows that bound the
    (rows, C, M) distance block; ``emit(pos, cpts, cand)`` turns each
    chunk's winner positions into the wrapper's second output. Rows with
    no valid candidate (empty member-table slots) skip the rounds: every
    slot of theirs is missing, (sqrt(3e38), position 0)."""
    T, C, _ = qpts.shape
    live = valid.any(dim=1).nonzero().flatten()
    dists = torch.sqrt(qpts.new_full((T, C, k), MISSING_D2))
    pos = torch.zeros((T, C, k), dtype=torch.int64, device=qpts.device)
    step = max(1, _PLAIN_PAIRS // max(C * max(cpts.shape[1], k), 1))
    for s in range(0, live.numel(), step):
        rows = live[s:s + step]
        dists[rows], pos[rows] = _plain_block(
            *(a[rows] for a in (qpts, cpts, cand, qrow, valid)), k)
    return dists, emit(pos, cpts, cand)


def _emit_coords(pos, cpts, cand):
    T, C, k = pos.shape
    nbrs = torch.gather(cpts, 1, pos.reshape(T, C * k, 1).expand(-1, -1, 3))
    return nbrs.reshape(T, C, k, 3)


def _emit_rows(pos, cpts, cand):
    T, C, k = pos.shape
    return torch.gather(cand, 1, pos.reshape(T, C * k)).reshape(T, C, k)


def _emit_pos(pos, cpts, cand):
    return pos.to(torch.int32)


def select_coords_plain(qpts: torch.Tensor, cpts: torch.Tensor,
                        cand: torch.Tensor, qrow: torch.Tensor,
                        valid: torch.Tensor, k: int):
    """Plain PyTorch version of ``knn_select_coords``.

    qpts (T,C,3), cpts (T,M,3) float32; cand (T,M), qrow (T,C), valid
    (T,M) int32. Returns (dists (T,C,k), nbrs (T,C,k,3)).
    """
    return _plain(qpts, cpts, cand, qrow, valid, k, _emit_coords)


def select_rows_plain(qpts: torch.Tensor, cpts: torch.Tensor,
                      cand: torch.Tensor, qrow: torch.Tensor,
                      valid: torch.Tensor, k: int):
    """Plain PyTorch version of ``knn_select_rows``: (dists (T,C,k),
    rows (T,C,k) int32 = cand[pos])."""
    return _plain(qpts, cpts, cand, qrow, valid, k, _emit_rows)


def select_pos_plain(qpts: torch.Tensor, cpts: torch.Tensor,
                     cand: torch.Tensor, qrow: torch.Tensor,
                     valid: torch.Tensor, k: int):
    """Plain PyTorch version of ``knn_select``: (dists (T,C,k), pos
    (T,C,k) int32)."""
    return _plain(qpts, cpts, cand, qrow, valid, k, _emit_pos)


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
        raise ValueError(f"k={k} outside [1, {KMAX}]: the select keeps at "
                         f"most {KMAX} neighbors")
    if not 1 <= C <= MAX_QUERIES:
        raise ValueError(f"{C} query slots outside [1, {MAX_QUERIES}]")


@functools.cache
def _kernel(source: str, symbol: str):
    fn = getattr(build.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _select(wrapper, source: str, symbol: str, plain, win_dtype, win_tail,
            qpts, cpts, cand, qrow, valid, k: int):
    """Check the operands, then run ``plain`` on CPU tensors or launch
    ``symbol`` of ``csrc/<source>.cu`` on CUDA tensors, counting the
    launch on ``wrapper.launches`` and on ``wrapper.launches_by_k[k]``."""
    _check(qpts, cpts, cand, qrow, valid, k)
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    dev = qpts.device
    if dev.type == "cpu":
        return plain(qpts, cpts, cand, qrow, valid, k)
    if dev.type != "cuda":
        raise ValueError(f"no select for device {dev}")
    for name, a in (("qpts", qpts), ("cpts", cpts), ("cand", cand),
                    ("qrow", qrow), ("valid", valid)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dists = torch.empty((T, C, k), dtype=torch.float32, device=dev)
    wins = torch.empty((T, C, k) + win_tail, dtype=win_dtype, device=dev)
    if T == 0:
        return dists, wins
    fn = _kernel(source, symbol)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qpts.data_ptr(), cpts.data_ptr(), cand.data_ptr(),
                 qrow.data_ptr(), valid.data_ptr(), dists.data_ptr(),
                 wins.data_ptr(), T, C, M, k, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.launches_by_k[k] = wrapper.launches_by_k.get(k, 0) + 1
    return dists, wins


def knn_select_coords(qpts: torch.Tensor, cpts: torch.Tensor,
                      cand: torch.Tensor, qrow: torch.Tensor,
                      valid: torch.Tensor, k: int):
    """(T,C,3) queries vs (T,M,3) candidates -> (dists (T,C,k) ascending,
    nbrs (T,C,k,3) winner coordinates).

    ``cand`` (T,M) int32 candidate ids, ``qrow`` (T,C) int32 query ids
    (a candidate equal to the query's id is itself and is skipped),
    ``valid`` (T,M) int32 nonzero where the slot is real; 1 <= k <= 1024.
    CUDA tensors launch the kernel (``knn_select_coords.launches`` counts
    launches); CPU tensors run ``select_coords_plain``.
    """
    return _select(knn_select_coords, "select_coords", "pct_select_coords",
                   select_coords_plain, torch.float32, (3,),
                   qpts, cpts, cand, qrow, valid, k)


def knn_select_rows(qpts: torch.Tensor, cpts: torch.Tensor,
                    cand: torch.Tensor, qrow: torch.Tensor,
                    valid: torch.Tensor, k: int):
    """Same selection as ``knn_select_coords`` -> (dists (T,C,k), rows
    (T,C,k) int32 = cand[pos], the winners' ids). CUDA tensors launch
    ``csrc/select_rows.cu:pct_select_rows`` (``knn_select_rows.launches``);
    CPU tensors run ``select_rows_plain``.
    """
    return _select(knn_select_rows, "select_rows", "pct_select_rows",
                   select_rows_plain, torch.int32, (),
                   qpts, cpts, cand, qrow, valid, k)


def knn_select(qpts: torch.Tensor, cpts: torch.Tensor, cand: torch.Tensor,
               qrow: torch.Tensor, valid: torch.Tensor, k: int):
    """Same selection as ``knn_select_coords`` -> (dists (T,C,k), pos
    (T,C,k) int32 winner positions in the M axis). CUDA tensors launch
    ``csrc/select_rows.cu:pct_select_pos`` (``knn_select.launches``); CPU
    tensors run ``select_pos_plain``.
    """
    return _select(knn_select, "select_rows", "pct_select_pos",
                   select_pos_plain, torch.int32, (),
                   qpts, cpts, cand, qrow, valid, k)


def select_layout(C: int, M: int, k: int) -> int:
    """The layout the three select kernels take at C query slots, M
    candidate slots and k winners a query (card only: builds
    ``csrc/select_rows.cu``): the dynamic shared bytes a block, positive
    where the row is staged in shared memory, negative where each pass
    re-reads it from device memory. k <= 128 keeps the 1 KB scratch class
    and its 100 KB budget; larger k takes 2, 4 or 8 KB a warp under the
    card's 227 KB a block."""
    fn = build.load("select_rows").pct_select_layout
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(C, M, k))


for _wrapper in (knn_select_coords, knn_select_rows, knn_select):
    _wrapper.launches = 0
    _wrapper.launches_by_k = {}
del _wrapper
