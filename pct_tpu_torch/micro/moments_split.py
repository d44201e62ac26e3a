"""The moments kernel with its stages swapped or switched off.

Counterpart of ``moments_variant`` in the JAX package's TPU script
``scripts/micro_moments_split.py`` (its kernel ``_kernel``, a copy of
``_moment_kernel`` whose static ``mode`` picks the τ search and drops
passes). Operands and the (T, C, 48) output are ``ops.moments.knn_moments``'
(layout in ``ops/moments.py``). Per query slot, on the int32 bits of the
masked d² (3e38 on unusable slots): hi0 = max(largest usable bits, 0),
lo0 = min(smallest bits − 1, hi0), then

- ``full``: bisection while hi − lo > 1, mid = lo + (hi − lo) // 2, hi :=
  mid where count(≤ mid) ≥ k, else lo := mid; τ = hi: the smallest bits
  with count ≥ k, or hi0 when fewer than k slots are usable;
- ``fixed26``: the same bisection for exactly 26 rounds;
- ``quad`` / ``quad_fixed`` / ``oct_fixed``: rounds of q = max((hi −
  lo) // arity, 1) and probes min(lo + i·q, hi), 4-ary while hi − lo > 1
  / 4-ary for 14 rounds / 8-ary for 10 rounds;
- ``interp4``: 4 false-position probes from (lo0, 0) and (hi0,
  count(hi0)), then the bisection;
- ``no_bisect``: τ = hi0;
- ``no_moments``: the full search, columns 0–34 and 39–44 zero;
- ``no_am``: the full search, columns 39–44 zero;
- ``d2_only``: τ = hi0, column 0 = count(≤ hi0), every other column 0.

The fixed-round modes return hi after their last round even where it has
not converged: that is the mode's result. After τ, count_lt / count_le
are counted at it and the rest is ``knn_moments``' code (its plain
version's ``plain_stats``, the kernel's ``finish_query``). A found row
whose τ no slot holds has a kth offset of 0.

``tb`` is the number of cell rows a thread block takes (the TPU batches
``tb`` rows a grid step); it changes no output bit. The script's
``chunk`` (tiles of its VMEM scratch) has no counterpart.

On CUDA tensors ``csrc/moments_split.cu`` runs (built with nvcc at first
use); on CPU tensors the plain PyTorch version below. They round every
operation the same way and count every probe to the same integer, so
columns 35–47 agree bit for bit; the kernel adds the 35 sums in another
order (lanes' chains, then recursive halving), so they agree within
count_le²·2⁻²⁴ (``ops.moments.stats_agreement``). ``variant_info`` says
which of the kernel's paths a shape takes (bits in registers for M ≤ 320,
else in shared memory or recomputed) and how many of its blocks an SM
holds.
"""

from __future__ import annotations

import ctypes

import torch

from pct_tpu_torch.ops import build
from pct_tpu_torch.ops.moments import (
    MISSING_D2,
    NOUT,
    _check,
    plain_d2,
    plain_rows,
    plain_stats,
)

# the JAX script's three k=100 buckets of the 1M torus, (T, C, M)
SCRIPT_K = 100
SCRIPT_BUCKETS = ((11776, 56, 168), (7680, 72, 216), (4096, 120, 312))
MODES = ("full", "fixed26", "quad", "quad_fixed", "oct_fixed", "interp4",
         "no_bisect", "no_moments", "no_am", "d2_only")
# int32 bits of the unusable-slot d²
SENT_BITS = int(torch.tensor(MISSING_D2).view(torch.int32))


def make_args(t: int, c: int, m: int, seed: int = 0, device="cpu"):
    """The JAX script's operands (its ``make_args``, the same numpy draws):
    normal queries and candidates, ids drawn from [0, t·c) against query
    ids 0..t·c − 1 (some self hits), 97% of the slots valid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(t, c, 3)).astype(np.float32),
              rng.normal(size=(t, m, 3)).astype(np.float32),
              rng.integers(0, t * c, size=(t, m)).astype(np.int32),
              np.arange(t * c, dtype=np.int32).reshape(t, c),
              (rng.random((t, m)) < 0.97).astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays]


def _count_le(bits, t):
    return (bits <= t[..., None]).sum(-1, dtype=torch.int32)


def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _bisect(bits, lo, hi, k, rounds=None):
    """Bisection rounds, ``rounds`` of them or while any hi − lo > 1."""
    r = 0
    while (r < rounds) if rounds is not None else bool((hi - lo > 1).any()):
        mid = lo + _floordiv(hi - lo, 2)
        ge = _count_le(bits, mid) >= k
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
        r += 1
    return lo, hi


def _nary(bits, lo, hi, k, arity, rounds=None):
    """A-ary rounds: the arity − 1 probes of a round in one count."""
    r = 0
    while (r < rounds) if rounds is not None else bool((hi - lo > 1).any()):
        q = torch.clamp_min(_floordiv(hi - lo, arity), 1)
        new_lo, new_hi = lo, hi
        for i in range(1, arity):
            m = torch.minimum(lo + i * q, hi)
            ge = _count_le(bits, m) >= k
            new_hi = torch.where(ge, torch.minimum(new_hi, m), new_hi)
            new_lo = torch.where(ge, new_lo, torch.maximum(new_lo, m))
        lo, hi = new_lo, new_hi
        r += 1
    return lo, hi


def _interp4(bits, lo, hi, k):
    """4 false-position probes, each operation rounded on its own."""
    f32 = torch.float32
    cl = torch.zeros_like(lo)
    ch = _count_le(bits, hi)
    for _ in range(4):
        tlo = torch.clamp_min(lo, 0).view(f32)
        thi = hi.view(f32)
        denom = torch.clamp_min((ch - cl).to(f32), 1.0)
        tg = tlo + (thi - tlo) * ((k - cl).to(f32) / denom)
        gb = torch.minimum(torch.maximum(tg.view(torch.int32), lo + 1),
                           torch.maximum(hi - 1, lo + 1))
        cg = _count_le(bits, gb)
        ge = cg >= k
        lo, hi = torch.where(ge, lo, gb), torch.where(ge, gb, hi)
        cl, ch = torch.where(ge, cl, cg), torch.where(ge, cg, ch)
    return _bisect(bits, lo, hi, k)


def search_tau(bits: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """τ's int32 bits (T, C) under ``mode`` from the masked d² bits
    (T, C, M), the JAX script's integer sequence step for step (its
    batch-wide ``while`` over this batch; a converged row is a fixpoint)."""
    mn = bits.min(-1).values
    mx = torch.where(bits == SENT_BITS, -1, bits).max(-1).values
    hi0 = torch.clamp_min(mx, 0)
    lo0 = torch.minimum(mn - 1, hi0)
    if mode in ("no_bisect", "d2_only"):
        return hi0
    if mode == "fixed26":
        return _bisect(bits, lo0, hi0, k, rounds=26)[1]
    if mode == "quad":
        return _nary(bits, lo0, hi0, k, 4)[1]
    if mode == "quad_fixed":
        return _nary(bits, lo0, hi0, k, 4, rounds=14)[1]
    if mode == "oct_fixed":
        return _nary(bits, lo0, hi0, k, 8, rounds=10)[1]
    if mode == "interp4":
        return _interp4(bits, lo0, hi0, k)[1]
    return _bisect(bits, lo0, hi0, k)[1]     # full, no_moments, no_am


def _plain_block(qpts, cpts, cand, qrow, valid, k: int, mode: str):
    r, d2, _ = plain_d2(qpts, cpts, cand, qrow, valid)
    bits = d2.view(torch.int32)
    tau_bits = search_tau(bits, k, mode)
    if mode == "d2_only":
        out = d2.new_zeros(d2.shape[:2] + (NOUT,))
        out[..., 0] = _count_le(bits, tau_bits).to(torch.float32)
        return out
    return plain_stats(r, d2, tau_bits.view(torch.float32), k,
                       am=mode != "no_am", moments=mode != "no_moments")


def moments_variant_plain(qpts: torch.Tensor, cpts: torch.Tensor,
                          cand: torch.Tensor, qrow: torch.Tensor,
                          valid: torch.Tensor, k: int,
                          mode: str = "full") -> torch.Tensor:
    """Plain PyTorch version of the variant kernel, in chunks of cell
    rows (``knn_moments``' operands; returns (T, C, 48) float32)."""
    return plain_rows(lambda *a: _plain_block(*a, k, mode), qpts, cpts, cand,
                      qrow, valid)


def variant_info(C: int, M: int, mode: str = "full") -> dict:
    """The kernel a (C, M) shape runs under ``mode`` on the current card,
    without launching: ``path`` (6, 8 or 10: that many bits a lane in
    registers; 0: bits in shared memory; -1: d² recomputed from device
    memory), ``blocks_per_sm`` (the CUDA occupancy calculator's), ``warps``
    a block and ``smem`` (dynamic shared bytes a block)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not one of {MODES}")
    fn = build.load("moments_split").pct_moments_variant_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    err = fn(C, M, MODES.index(mode), info)
    if err != 0:
        raise RuntimeError(f"moments variant occupancy query failed: CUDA "
                           f"error {err}")
    return dict(path=info[0], blocks_per_sm=info[1], warps=info[2],
                smem=info[3])


def moments_variant(qpts: torch.Tensor, cpts: torch.Tensor,
                    cand: torch.Tensor, qrow: torch.Tensor,
                    valid: torch.Tensor, k: int, tb: int = 1,
                    mode: str = "full") -> torch.Tensor:
    """``knn_moments``' stats with the stages of ``mode`` (module
    docstring), ``tb`` cell rows a thread block. CUDA tensors launch
    ``csrc/moments_split.cu:pct_moments_variant``; CPU tensors run
    ``moments_variant_plain``."""
    _check(qpts, cpts, cand, qrow, valid, k)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not one of {MODES}")
    if tb < 1:
        raise ValueError(f"tb={tb} must be positive")
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    dev = qpts.device
    if dev.type == "cpu":
        return moments_variant_plain(qpts, cpts, cand, qrow, valid, k, mode)
    out = torch.empty((T, C, NOUT), dtype=torch.float32, device=dev)
    if T > 0:
        build.kernel("moments_split", "pct_moments_variant")(
            qpts, cpts, cand, qrow, valid, out, T, C, M, k, tb,
            MODES.index(mode))
    return out
