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
test ``found = dists < 1e18``. The selects take any k and any number
of query slots a cell row, as the Pallas kernels do; library kNN, the
staged pipeline, the implicit fallback, the list engine and
``compat.estimate_curvature`` reach them at any k.

On CUDA tensors the hand-written kernels run (``csrc/select_coords.cu``
and ``csrc/select_rows.cu``, one design in ``csrc/knn_warp.cuh``; built
with nvcc at first use; only the emitted outputs differ). Up to k =
1024 one block per cell row stages the row and one warp per query slot
computes d² once, radix-selects the kth and sorts the winners, the
warp's scratch and the block's shared-memory budget a class chosen by
k. Past 1024 (the block class) a whole block serves one query slot: the
same select block-wide, the winners sorted in shared memory up to
16,384 of them and past that over a device-memory workspace that the
wrapper allocates (``WS_BLOCKS`` blocks' keys). ``select_layout`` tells
which layout a shape takes. On CPU tensors the plain PyTorch versions
below run, which do the same IEEE float32 operations in the same order,
so the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes

import torch

from pct_tpu_torch.ops import build
from pct_tpu_torch.utils import trace

MISSING_D2 = 3.0e38
WARP_KMAX = 1024    # the warp classes' largest k; past it the block class
SORT_KEYS = 16384   # winners the block class sorts in shared memory
WS_BLOCKS = 264     # blocks of a launch whose winners exceed SORT_KEYS,
                    # each sorting in its own workspace slice
_PLAIN_PAIRS = 1 << 24  # (rows × C × max(M, k)) elements a plain chunk


def _plain_block(qpts, cpts, cand, qrow, valid, k: int):
    """The Pallas kernels' k rounds of min, first-argmin and mask-out
    over one (T,C,M) distance block -> (dists (T,C,k), pos (T,C,k)
    int64).

    The rounds emit the usable slots in ascending (d², m) order, then,
    once every slot reads 3e38 (the taken ones too), (3e38, position 0)
    in every round left. That order comes here from one top-k of the
    int64 keys (d² bits << 32 | m), since non-negative float32 values
    order as their bits: a winner at or above 3e38 reads (3e38, 0), and
    the outputs are the rounds' bit for bit at any k."""
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    dx = qpts[:, :, None, 0] - cpts[:, None, :, 0]
    dy = qpts[:, :, None, 1] - cpts[:, None, :, 1]
    dz = qpts[:, :, None, 2] - cpts[:, None, :, 2]
    d2 = (dx * dx + dy * dy) + dz * dz                  # (T, C, M)
    ok = (valid[:, None, :] != 0) & (cand[:, None, :] != qrow[:, :, None])
    d2 = torch.where(ok, d2, MISSING_D2)
    iota = torch.arange(M, dtype=torch.int64, device=d2.device)
    keys = (d2.view(torch.int32).to(torch.int64) << 32) | iota
    del d2, dx, dy, dz
    kk = min(k, M)
    top = torch.topk(keys, kk, dim=-1, largest=False, sorted=True).values
    del keys
    won = (top >> 32).to(torch.int32).view(torch.float32)
    hit = won < MISSING_D2
    d2k = won.new_full((T, C, k), MISSING_D2)
    d2k[..., :kk] = torch.where(hit, won, MISSING_D2)
    pos = torch.zeros((T, C, k), dtype=torch.int64, device=won.device)
    pos[..., :kk] = torch.where(hit, top & 0xFFFFFFFF, 0)
    return torch.sqrt(torch.clamp_min(d2k, 0.0)), pos


def _plain(qpts, cpts, cand, qrow, valid, k: int, emit):
    """Plain version of a select, in chunks of cell rows that bound the
    (rows, C, M) distance block; ``emit(pos, cpts, cand)`` turns each
    chunk's winner positions into the wrapper's second output. Rows with
    no valid candidate (empty member-table slots) skip the select: every
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
    if k < 1:
        raise ValueError(f"k={k} must be positive")
    if C < 1:
        raise ValueError("qpts needs at least one query slot")


def _workspace(T: int, C: int, M: int, k: int, dev):
    """The block class's device-memory sort workspace, where a query's
    min(k, M) winners exceed SORT_KEYS: one slice of min(k, M) int64 keys
    for each of min(T·C, WS_BLOCKS) blocks; else None."""
    kk = min(k, M)
    if k <= WARP_KMAX or kk <= SORT_KEYS:
        return None
    return torch.empty(min(T * C, WS_BLOCKS) * kk, dtype=torch.int64,
                       device=dev)


def _select(source: str, symbol: str, plain, win_dtype, win_tail,
            qpts, cpts, cand, qrow, valid, k: int):
    """Check the operands, then run ``plain`` on CPU tensors or launch
    ``symbol`` of ``csrc/<source>.cu``, counting the launch also as
    ``launches.<symbol>.k<k>``."""
    _check(qpts, cpts, cand, qrow, valid, k)
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    dev = qpts.device
    if dev.type == "cpu":
        return plain(qpts, cpts, cand, qrow, valid, k)
    dists = torch.empty((T, C, k), dtype=torch.float32, device=dev)
    wins = torch.empty((T, C, k) + win_tail, dtype=win_dtype, device=dev)
    if T > 0:
        build.kernel(source, symbol)(qpts, cpts, cand, qrow, valid, dists,
                                     wins, _workspace(T, C, M, k, dev),
                                     T, C, M, k)
        trace.count(f"launches.{symbol}.k{k}", 1)
    return dists, wins


def knn_select_coords(qpts: torch.Tensor, cpts: torch.Tensor,
                      cand: torch.Tensor, qrow: torch.Tensor,
                      valid: torch.Tensor, k: int):
    """(T,C,3) queries vs (T,M,3) candidates -> (dists (T,C,k) ascending,
    nbrs (T,C,k,3) winner coordinates).

    ``cand`` (T,M) int32 candidate ids, ``qrow`` (T,C) int32 query ids
    (a candidate equal to the query's id is itself and is skipped),
    ``valid`` (T,M) int32 nonzero where the slot is real; any k >= 1.
    CUDA tensors launch ``csrc/select_coords.cu:pct_select_coords``; CPU
    tensors run ``select_coords_plain``.
    """
    return _select("select_coords", "pct_select_coords",
                   select_coords_plain, torch.float32, (3,),
                   qpts, cpts, cand, qrow, valid, k)


def knn_select_rows(qpts: torch.Tensor, cpts: torch.Tensor,
                    cand: torch.Tensor, qrow: torch.Tensor,
                    valid: torch.Tensor, k: int):
    """Same selection as ``knn_select_coords`` -> (dists (T,C,k), rows
    (T,C,k) int32 = cand[pos], the winners' ids). CUDA tensors launch
    ``csrc/select_rows.cu:pct_select_rows``; CPU tensors run
    ``select_rows_plain``.
    """
    return _select("select_rows", "pct_select_rows",
                   select_rows_plain, torch.int32, (),
                   qpts, cpts, cand, qrow, valid, k)


def knn_select(qpts: torch.Tensor, cpts: torch.Tensor, cand: torch.Tensor,
               qrow: torch.Tensor, valid: torch.Tensor, k: int):
    """Same selection as ``knn_select_coords`` -> (dists (T,C,k), pos
    (T,C,k) int32 winner positions in the M axis). CUDA tensors launch
    ``csrc/select_rows.cu:pct_select_pos``; CPU tensors run
    ``select_pos_plain``.
    """
    return _select("select_rows", "pct_select_pos",
                   select_pos_plain, torch.int32, (),
                   qpts, cpts, cand, qrow, valid, k)


def select_layout(C: int, M: int, k: int) -> int:
    """The layout the three select kernels take at C query slots, M
    candidate slots and k winners a query (card only: builds
    ``csrc/select_rows.cu``): the dynamic shared bytes a block, positive
    where the row is staged in shared memory, negative where each pass
    re-reads it from device memory. k <= 128 keeps the 1 KB scratch class
    and its 100 KB budget; k up to 1024 takes 2, 4 or 8 KB a warp under
    the card's 227 KB a block; past 1024 the block class stages one
    query's d² bits beside its sort keys (min(k, M), or a 16,384-key tile
    of the device-memory sort) under the same 227 KB."""
    fn = build.load("select_rows").pct_select_layout
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(C, M, k))
