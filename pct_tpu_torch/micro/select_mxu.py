"""The coords select with the winner extraction as a matrix product.

Counterpart of ``select_coords_mxu`` in the JAX package's TPU script
``scripts/micro_select_mxu.py`` (its kernel ``_mxu_kernel``), which A/Bs
the production coords select (``ops.select.knn_select_coords``) against
a variant that extracts each round's winner on the matrix units. Per
cell row t and query slot c, over the M candidate slots (slots with
valid ≤ 0 and the query itself, ``cand == qrow``, read d² = 3e38):

- d² in the difference form ((dx·dx + dy·dy) + dz·dz), d = q − p;
- k rounds of: the minimum, the FIRST slot that holds it, that slot set
  to 3e38; dists = sqrt(max(min, 0));
- the winner's (x, y, z, float(cand)) as its one-hot row times the
  (M, 4) matrix [x, y, z, float(cand)]: nbrs (T,C,k,3) and rows =
  int(float(cand)) (T,C,k) int32, so ids above 2²⁴ round as float32 does.

Once the usable slots are used up every d² reads 3e38 and the first
slot holding it is 0: a missing slot carries dists sqrt(3e38) and slot
0's coordinates and id. Distances are for d² below 3e38.

Operands follow ``knn_select_coords``: qpts (T,C,3), cpts (T,M,3)
float32; cand, qrow, valid int32. ``block_cells`` cell rows go to one
thread block (one grid step of the TPU kernel); T must be a multiple of
it (``ValueError``: the JAX grid of T // block_cells steps would leave
the last T % block_cells rows unwritten).

On CUDA tensors ``csrc/select_mxu.cu`` runs: the warp select of
``knn_warp.cuh``, then, per cell row, the one-hot product of all its
queries' rounds on the bf16 tensor cores (``mma.sync`` m16n8k16), each
float32 of [x, y, z, float(cand)] cut into three bf16 pieces that the
product returns exactly and that rebuild it bit for bit (values below
2⁻¹⁰³ scaled by 2⁶⁴ first, with a flag column, so no piece is a bf16
subnormal); on CPU tensors the plain PyTorch version below, which
gathers the winners (the product's value: a −0.0 coordinate reads +0.0,
as the product's sum from +0 does). The two agree bit for bit.
"""

from __future__ import annotations

import torch

from pct_tpu_torch.ops import build
from pct_tpu_torch.ops.select import _check, _plain

SCRIPT_SHAPE = (8192, 128, 504, 20)   # the JAX script's (T, C, M, k) on a TPU


def make_inputs(T: int, C: int, M: int, seed: int = 0, device="cpu"):
    """The JAX script's operands (its ``make_inputs``, the same numpy
    draws): each tile's candidates scattered 0.05 around its own queries,
    ids below 2²⁰, no self hits (qrow = −1), 95% of the slots valid; cpts
    as (T, M, 3)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    qp = rng.standard_normal((T, C, 3), np.float32)
    cp = qp[:, rng.integers(0, C, size=M), :] + 0.05 * rng.standard_normal(
        (T, M, 3), np.float32)
    cand = rng.integers(0, 1 << 20, size=(T, M), dtype=np.int32)
    qrow = np.full((T, C), -1, np.int32)
    valid = (rng.random((T, M)) < 0.95).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (qp, cp.astype(np.float32), cand, qrow, valid)]


def _emit_mxu(pos, cpts, cand):
    """The winners' coordinates (+0.0: the product's sum starts from +0)
    and their ids through float32."""
    T, C, k = pos.shape
    flat = pos.reshape(T, C * k)
    nbrs = torch.gather(cpts, 1, flat[..., None].expand(-1, -1, 3))
    rows = torch.gather(cand.to(torch.float32), 1, flat).to(torch.int32)
    return nbrs.reshape(T, C, k, 3) + 0.0, rows.reshape(T, C, k)


def select_coords_mxu_plain(qpts: torch.Tensor, cpts: torch.Tensor,
                            cand: torch.Tensor, qrow: torch.Tensor,
                            valid: torch.Tensor, k: int):
    """Plain PyTorch version of the kernel -> (dists (T,C,k), nbrs
    (T,C,k,3), rows (T,C,k) int32): the production select's rounds
    (``ops.select``) on the script's usable slots (valid > 0)."""
    dists, (nbrs, rows) = _plain(qpts, cpts, cand, qrow,
                                 (valid > 0).to(torch.int32), k, _emit_mxu)
    return dists, nbrs, rows


def select_coords_mxu(qpts: torch.Tensor, cpts: torch.Tensor,
                      cand: torch.Tensor, qrow: torch.Tensor,
                      valid: torch.Tensor, k: int, block_cells: int = 8):
    """(T,C,3) queries vs (T,M,3) candidates -> (dists (T,C,k), nbrs
    (T,C,k,3), rows (T,C,k) int32) as the module docstring says;
    1 ≤ k ≤ 128. CUDA tensors launch the kernel once a call, the
    selection and the per-row product both inside it; CPU tensors run
    ``select_coords_mxu_plain``."""
    _check(qpts, cpts, cand, qrow, valid, k)
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    if block_cells < 1 or T % block_cells:
        raise ValueError(f"T={T} is not a multiple of block_cells="
                         f"{block_cells}: the TPU grid of T // block_cells "
                         f"steps leaves the last rows unwritten")
    dev = qpts.device
    if dev.type == "cpu":
        return select_coords_mxu_plain(qpts, cpts, cand, qrow, valid, k)
    dists = torch.empty((T, C, k), dtype=torch.float32, device=dev)
    nbrs = torch.empty((T, C, k, 3), dtype=torch.float32, device=dev)
    rows = torch.empty((T, C, k), dtype=torch.int32, device=dev)
    if T > 0:
        build.kernel("select_mxu", "pct_select_coords_mxu")(
            qpts, cpts, cand, qrow, valid, dists, nbrs, rows, T, C, M, k,
            block_cells)
    return dists, nbrs, rows
