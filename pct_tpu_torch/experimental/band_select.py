"""Band k-nearest selection: the kernel of the gather-free band kNN.

Port of ``pct_tpu.experimental.pallas_band.knn_band_select`` (TPU kernel
``_band_kernel``). A row block b holds ``bc`` occupied cells of one grid
(y,z) row (``band_knn.build_row_blocks``), so the 27-cell windows of its
cells collapse into 9 CONTIGUOUS sorted-row bands: band j starts at row
``bs[b, j]`` and is ``band`` rows long. Query slot s of the block belongs
to cell c = s // cap, slot s % cap; its row is ``qrow = qrow_base[b, c]
+ slot``. Per query slot, over the concatenated (9·band) positions:

- position p of band j is a candidate iff ``rs_rel[b,c,j] <= p <
  rs_rel[b,c,j] + run_len[b,c,j]`` and its row ``bs[b,j] + p`` is not
  ``qrow`` (the query itself);
- d² = ((dx·dx + dy·dy) + dz·dz), d = q − p (difference form);
- the k smallest d² win in ascending (d², j·band + p) order, the lowest
  concatenated position first among equal d² (the Pallas kernel's k
  rounds of min, first-argmin and mask-out);
- each winner emits dist = sqrt(max(d², 0)) and its row ``bs[b, j] +
  p``. A missing slot (fewer than k candidates) reads (sqrt(3e38), row
  ``bs[b, 0]``): once every position reads 3e38, first-argmin returns
  position 0. Callers test ``found = dists < 1e18``;
- ``cover`` is the query's coverage radius inside its cell's 3³ window,
  min(min(min(qx−lox, hix−qx), min(qy−loy, hiy−qy)), min(qz−loz,
  hiz−qz)).

Plane rows past the end of the planes read 0. With ``counts=None``
every query slot is computed, padding slots included, as the Pallas
kernel computes them. With ``counts`` (NB, bc) int32, the points of
each cell (0 for a padding cell), a slot whose ``s % cap >=
counts[b, c]`` is a padding slot: it is not computed and reads the
missing-slot fill in all k places, distance sqrt(3e38) and row ``bs[b,
0]``, with its ``cover`` computed as above. ``knn_cellwise_band``
passes its cells' counts and drops exactly those slots, so its results
are the same in both modes.

On CUDA tensors the hand-written kernel ``csrc/band_select.cu`` runs
(built with nvcc at first use; ``launches.pct_band_select`` counts its
launches) over a fixed-size tile of the block's run hulls: up to k =
1024 one warp per computed query slot on ``csrc/knn_warp.cuh``, its
scratch the class of k that ``ops.select``'s kernels use; past 1024 the
block class, a whole block on one query slot. On CPU tensors the plain
PyTorch version ``band_select_plain`` runs. Both do the same IEEE
float32 operations in the same order and agree bit for bit on the card.
Any k and any bc·cap run, as in the JAX package.

Documented divergence from the JAX package: the ``counts`` mode, which
the JAX kernel does not have. ``MAX_BAND`` = 1024 is the JAX package's
DMA window, kept so both packages accept and refuse the same ``band``.
"""

from __future__ import annotations

import torch

from pct_tpu_torch.ops import build
from pct_tpu_torch.ops.select import MISSING_D2, _emit_rows, _plain

MAX_BAND = 1024          # longest band (the JAX package's DMA window)
NINE = 9
_PLAIN_PAIRS = 1 << 24   # (query slots × 9·band) elements per plain chunk


def band_cover(qpts: torch.Tensor, lo_edge: torch.Tensor,
               hi_edge: torch.Tensor, cap: int) -> torch.Tensor:
    """(NB·bc·cap,) coverage radius of each query slot in its cell's
    window, in the Pallas kernel's order of minima."""
    nb, bc, _ = lo_edge.shape
    q = qpts.reshape(nb, bc, cap, 3)
    lo = lo_edge[:, :, None, :]
    hi = hi_edge[:, :, None, :]
    dx = torch.minimum(q[..., 0] - lo[..., 0], hi[..., 0] - q[..., 0])
    dy = torch.minimum(q[..., 1] - lo[..., 1], hi[..., 1] - q[..., 1])
    dz = torch.minimum(q[..., 2] - lo[..., 2], hi[..., 2] - q[..., 2])
    return torch.minimum(torch.minimum(dx, dy), dz).reshape(-1)


def band_select_plain(px, py, pz, bs, rs_rel, run_len, qpts, qrow_base,
                      lo_edge, hi_edge, k: int, bc: int, cap: int,
                      band: int, counts=None):
    """Plain PyTorch version of ``knn_band_select``.

    Each (block, cell) pair is one row of the select's plain version
    (``ops.select._plain``): its ``cap`` query slots against the block's
    9·band positions, valid where they lie in the cell's runs, with the
    global rows ``bs[b, j] + p`` as candidate ids (self-exclusion and the
    emitted rows). Blocks go in chunks that bound the distance matrix.
    With ``counts``, the padding slots then get the missing-slot fill.
    """
    nb = bs.shape[0]
    q = bc * cap
    m = NINE * band
    npad = px.shape[0]
    dev = px.device
    pos = torch.arange(band, dtype=torch.int32, device=dev)
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    dists = torch.empty((nb * q, k), dtype=torch.float32, device=dev)
    rows = torch.empty((nb * q, k), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_PAIRS // (q * m))
    for s in range(0, nb, step):
        blk = slice(s, min(s + step, nb))
        t = blk.stop - blk.start
        g = bs[blk][:, :, None] + pos                        # (t, 9, band)
        inside = (g >= 0) & (g < npad)
        gi = torch.clamp(g, 0, npad - 1).long()
        cpts = torch.stack([torch.where(inside, a[gi], 0.0)
                            for a in (px, py, pz)], dim=-1).reshape(t, m, 3)
        lo = rs_rel[blk][..., None]                          # (t, bc, 9, 1)
        valid = (pos >= lo) & (pos < lo + run_len[blk][..., None])
        qrow = qrow_base[blk][:, :, None] + slot             # (t, bc, cap)
        d, r = _plain(qpts[blk].reshape(t * bc, cap, 3),
                      cpts[:, None].expand(t, bc, m, 3).reshape(t * bc, m, 3),
                      g.reshape(t, 1, m).expand(t, bc, m).reshape(t * bc, m),
                      qrow.reshape(t * bc, cap),
                      valid.reshape(t * bc, m).to(torch.int32), k, _emit_rows)
        dists[blk.start * q:blk.stop * q] = d.reshape(-1, k)
        rows[blk.start * q:blk.stop * q] = r.reshape(-1, k)
    if counts is not None:
        pad = (slot >= counts[..., None]).reshape(-1)           # (S,)
        dists[pad] = torch.sqrt(dists.new_tensor(MISSING_D2))
        rows[pad] = bs[:, :1].expand(nb, q).reshape(-1)[pad, None]
    return dists, rows, band_cover(qpts, lo_edge, hi_edge, cap)


def _check(px, py, pz, bs, rs_rel, run_len, qpts, qrow_base, lo_edge,
           hi_edge, k, bc, cap, band, counts):
    if k < 1:
        raise ValueError(f"k={k} must be positive")
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"band {band} outside [1, {MAX_BAND}]")
    if bc < 1 or cap < 1:
        raise ValueError(f"bc*cap = {bc}*{cap} query slots a block: bc and "
                         "cap must be positive")
    nb = bs.shape[0]
    q = bc * cap
    shapes = (("px", px, (px.shape[0],), torch.float32),
              ("py", py, (px.shape[0],), torch.float32),
              ("pz", pz, (px.shape[0],), torch.float32),
              ("bs", bs, (nb, NINE), torch.int32),
              ("rs_rel", rs_rel, (nb, bc, NINE), torch.int32),
              ("run_len", run_len, (nb, bc, NINE), torch.int32),
              ("qpts", qpts, (nb, q, 3), torch.float32),
              ("qrow_base", qrow_base, (nb, bc), torch.int32),
              ("lo_edge", lo_edge, (nb, bc, 3), torch.float32),
              ("hi_edge", hi_edge, (nb, bc, 3), torch.float32))
    if counts is not None:
        shapes += (("counts", counts, (nb, bc), torch.int32),)
    for name, a, shape, dtype in shapes:
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if px.dim() != 1 or px.shape[0] < 1:
        raise ValueError("the coordinate planes need at least one row")
    devs = {a.device for _, a, _, _ in shapes}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def knn_band_select(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
                    bs: torch.Tensor, rs_rel: torch.Tensor,
                    run_len: torch.Tensor, qpts: torch.Tensor,
                    qrow_base: torch.Tensor, lo_edge: torch.Tensor,
                    hi_edge: torch.Tensor, k: int, bc: int, cap: int,
                    band: int, counts: torch.Tensor | None = None):
    """Band selection for NB row blocks -> (dists (S,k) float32
    ascending, rows (S,k) int32 global sorted rows, cover (S,) float32),
    S = NB·bc·cap.

    px/py/pz (Npad,) float32 coordinate planes; bs (NB,9) int32 band
    starts; rs_rel/run_len (NB,bc,9) int32 run windows relative to the
    band start; qpts (NB,bc·cap,3) float32 query coordinates; qrow_base
    (NB,bc) int32 row of each cell's first query; lo_edge/hi_edge
    (NB,bc,3) float32 window edges (±1e30 at grid boundaries); counts
    (NB,bc) int32 points a cell, or None (every slot computed; see the
    module docstring). Any k >= 1 and bc·cap; band <= 1024.
    CUDA tensors launch ``csrc/band_select.cu``; CPU tensors run
    ``band_select_plain``.
    """
    ops = (px, py, pz, bs, rs_rel, run_len, qpts, qrow_base, lo_edge,
           hi_edge)
    _check(*ops, k, bc, cap, band, counts)
    dev = px.device
    if dev.type == "cpu":
        return band_select_plain(*ops, k, bc, cap, band, counts)
    nb = bs.shape[0]
    s = nb * bc * cap
    dists = torch.empty((s, k), dtype=torch.float32, device=dev)
    rows = torch.empty((s, k), dtype=torch.int32, device=dev)
    cover = torch.empty((s,), dtype=torch.float32, device=dev)
    if nb > 0:
        build.kernel("band_select", "pct_band_select")(
            *ops, counts, dists, rows, cover, nb, px.shape[0], k, bc, cap,
            band)
    return dists, rows, cover
