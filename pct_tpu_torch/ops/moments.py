"""Large-k neighborhoods as MOMENT sums: exact kth distance, tie
weights and 35 weighted monomial sums per query.

Port of ``pct_tpu.ops.pallas_moments.knn_moments`` (TPU kernel
``_moment_kernel``). Per cell row t and query slot c, over the M
candidate slots (invalid slots and the query itself, ``cand == qrow``,
are skipped):

1. d² in the exact difference form ((dx·dx + dy·dy) + dz·dz), d = q − p;
2. τ, the kth smallest valid d² when at least k valid candidates exist,
   else the largest valid d², else 0 (the kernel finds it by a radix
   select on the uint32 bits of d²: non-negative float32 compares are
   monotone on their bits);
3. count_lt = #(d² < τ), count_le = #(d² ≤ τ), found = count_le ≥ k,
   and the first slots whose d² equals the minimum and τ;
4. weights w = 1 below τ, w_tie = clip((k − count_lt)/count_eq, 0, 1)
   at τ, 0 above;
5. r̂ = clip((p − q)·(1/σ), −2, 2) with σ = √τ, and the 35 sums
   Σ w·x̂ᵃŷᵇẑᶜ over a+b+c ≤ 4 in ``fit.layout.MOMENT_EXPS`` order. Each
   monomial is built by the product chain (a,b,c) = (a−1,b,c)·x̂ when
   a > 0, else (a,b−1,c)·ŷ when b > 0, else (a,b,c−1)·ẑ.

Output (T, C, 48) float32, the JAX package's layout:
  [0:35] moments, [35] τ, [36] count_lt, [37] count_le, [38] σ,
  [39:42] nearest offset p₁ − q, [42:45] kth offset p_k − q (0 unless
  found), [45] found, [46:48] 0.

On CUDA tensors the hand-written kernel ``csrc/moments.cu`` runs (built
with nvcc at first use); on CPU tensors the plain PyTorch version below.
Both round every operation the same way, so columns 35–47 agree bit for
bit on the card and every monomial is the same float; only the order of
the 35 sums differs (in the kernel each of a warp's 32 lanes adds its
own members, then the lanes' partial sums are added in a butterfly),
which keeps each moment column within count_le² · 2⁻²⁴ of the other
(|monomial| ≤ 1 for every member).
"""

from __future__ import annotations

import torch

from pct_tpu_torch.fit.layout import MOMENT_EXPS
from pct_tpu_torch.ops import build, select

NOUT = 48
MISSING_D2 = 3.0e38       # d² of a skipped slot
MAX_QUERIES = 512         # query slots of a cell row (one block a row, its
                          # warps take the slots in turn)
# (rows × C × M) elements per plain-version chunk: cache-sized on the
# CPU (2.7× faster than 2^23 there), large on the card, where each chunk
# costs ~130 kernel launches
_PLAIN_PAIRS = {"cpu": 1 << 20, "cuda": 1 << 23}


def _chain():
    """(index, parent index, axis) of each monomial after (0,0,0)."""
    idx = {e: i for i, e in enumerate(MOMENT_EXPS)}
    out = []
    for i, (a, b, c) in enumerate(MOMENT_EXPS[1:], start=1):
        if a > 0:
            out.append((i, idx[(a - 1, b, c)], 0))
        elif b > 0:
            out.append((i, idx[(a, b - 1, c)], 1))
        else:
            out.append((i, idx[(a, b, c - 1)], 2))
    return tuple(out)


_CHAIN = _chain()


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def plain_d2(qpts, cpts, cand, qrow, valid):
    """The offsets r = p − q (three (T,C,M) tensors), the masked d²
    (T,C,M: the difference form, MISSING_D2 on unusable slots) and the
    usable mask."""
    r = [cpts[:, None, :, a] - qpts[:, :, None, a] for a in range(3)]
    d = [-x for x in r]                  # q − p, exactly (negation)
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]            # (T, C, M)
    ok = (valid[:, None, :] > 0) & (cand[:, None, :] != qrow[:, :, None])
    return r, torch.where(ok, d2, MISSING_D2), ok


def plain_stats(r, d2, tau, k: int, am: bool = True,
                moments: bool = True) -> torch.Tensor:
    """Everything after τ (T,C) float32: the counts at τ, the first slots
    of the minimum and of τ, the tie weight and the 35 monomial sums ->
    (T,C,48). Without ``am`` the nearest and kth offsets are 0; without
    ``moments`` so are the sums. A found row whose τ no slot holds has a
    kth offset of 0."""
    tb = tau[..., None]
    lt, le = d2 < tb, d2 <= tb
    count_lt = lt.sum(-1)
    count_le = le.sum(-1)
    found = count_le >= k
    eq = le & ~lt
    zero = torch.zeros_like(tau)
    if am and moments:
        am_n = _first(d2 == d2.min(-1, keepdim=True).values)[..., None]
        am_k = _first(eq)[..., None]
        has_k = found & eq.any(-1)
        near = [torch.gather(x, -1, am_n)[..., 0] for x in r]
        kth_off = [torch.where(has_k, torch.gather(x, -1, am_k)[..., 0], 0.0)
                   for x in r]
    else:
        near = kth_off = [zero] * 3

    sigma = torch.sqrt(torch.clamp_min(tau, 0.0))
    if moments:
        inv = torch.div(torch.ones_like(sigma), torch.clamp_min(sigma, 1e-30))
        count_eq = torch.clamp_min(count_le - count_lt, 1)
        w_tie = torch.clamp((k - count_lt).to(torch.float32)
                            / count_eq.to(torch.float32), 0.0, 1.0)
        w = torch.where(lt, 1.0, torch.where(eq, w_tie[..., None], 0.0))
        hat = [torch.clamp(x * inv[..., None], -2.0, 2.0) for x in r]
        monos = [w] + [None] * (len(MOMENT_EXPS) - 1)
        for i, parent, axis in _CHAIN:
            monos[i] = monos[parent] * hat[axis]
        cols = [m.sum(-1) for m in monos]
    else:
        cols = [zero] * len(MOMENT_EXPS)
    f32 = torch.float32
    cols += [tau, count_lt.to(f32), count_le.to(f32), sigma, *near,
             *kth_off, found.to(f32), zero, zero]
    return torch.stack(cols, dim=-1)


def _plain_block(qpts, cpts, cand, qrow, valid, k: int) -> torch.Tensor:
    M = cpts.shape[1]
    r, d2, ok = plain_d2(qpts, cpts, cand, qrow, valid)
    n_valid = ok.sum(-1)
    top = torch.where(ok, d2, -torch.inf).max(-1).values
    kth = torch.kthvalue(d2, k, dim=-1).values if M >= k else top
    tau = torch.where(n_valid >= k, kth,
                      torch.where(n_valid > 0, top, torch.zeros_like(top)))
    return plain_stats(r, d2, tau, k)


def plain_rows(block, qpts, *ops) -> torch.Tensor:
    """``block(qpts[s:e], *(a[s:e] for a in ops))`` over chunks of cell
    rows that bound the (rows, C, M) block, concatenated."""
    T, C, _ = qpts.shape
    if T == 0:
        return qpts.new_empty((0, C, NOUT))
    pairs = _PLAIN_PAIRS.get(qpts.device.type, 1 << 20)
    step = max(1, pairs // max(C * ops[0].shape[1], 1))
    return torch.cat([block(*(a[s:s + step] for a in (qpts, *ops)))
                      for s in range(0, T, step)])


def moments_plain(qpts: torch.Tensor, cpts: torch.Tensor, cand: torch.Tensor,
                  qrow: torch.Tensor, valid: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in chunks of cell rows that
    bound the (rows, C, M) block. τ is taken with ``torch.kthvalue``,
    independently of the kernel's bisection.

    qpts (T,C,3), cpts (T,M,3) float32; cand (T,M), qrow (T,C), valid
    (T,M) int32. Returns (T, C, 48) float32.
    """
    return plain_rows(lambda *a: _plain_block(*a, k), qpts, cpts, cand, qrow,
                      valid)


def stats_agreement(got: torch.Tensor, want: torch.Tensor):
    """How far two (..., 48) stats of the same inputs are apart, in the
    kernel's contract: (rows whose columns 35–47 differ in any bit, the
    largest ratio of a moment column's |got − want| to count_le²·2⁻²⁴,
    the largest abs difference over all columns). A ratio above 1, or
    any differing row, breaks the contract."""
    sel = (got[..., 35:].view(torch.int32)
           != want[..., 35:].view(torch.int32)).any(-1)
    le = want[..., 37:38]
    err = (got[..., :35] - want[..., :35]).abs()
    ratio = torch.where(err == 0, 0.0, err / (le * le * 2.0**-24))
    return (int(sel.sum()), float(ratio.max()),
            float((got - want).abs().max()))


def _check(qpts, cpts, cand, qrow, valid, k):
    """``ops.select``'s operand contract, and the kernel's two bounds:
    M < 2^31 candidate slots and at most ``MAX_QUERIES`` query slots."""
    select._check(qpts, cpts, cand, qrow, valid, k)
    M, C = cpts.shape[1], qpts.shape[1]
    if M >= 2**31:
        raise ValueError(f"{M} candidate slots outside [1, 2^31)")
    if C > MAX_QUERIES:
        raise ValueError(f"{C} query slots outside [1, {MAX_QUERIES}]")


def knn_moments(qpts: torch.Tensor, cpts: torch.Tensor, cand: torch.Tensor,
                qrow: torch.Tensor, valid: torch.Tensor,
                k: int) -> torch.Tensor:
    """(T,C,3) queries vs (T,M,3) candidates -> (T,C,48) moment stats
    (layout in the module docstring).

    ``cand`` (T,M) int32 candidate rows, ``qrow`` (T,C) int32 query rows
    (a candidate equal to the query's row is itself and is skipped),
    ``valid`` (T,M) int32, > 0 where the slot is real. CUDA tensors
    launch ``csrc/moments.cu:pct_knn_moments``; CPU tensors run
    ``moments_plain``.
    """
    _check(qpts, cpts, cand, qrow, valid, k)
    T, C, _ = qpts.shape
    M = cpts.shape[1]
    dev = qpts.device
    if dev.type == "cpu":
        return moments_plain(qpts, cpts, cand, qrow, valid, k)
    out = torch.empty((T, C, NOUT), dtype=torch.float32, device=dev)
    if T > 0:
        build.kernel("moments", "pct_knn_moments")(
            qpts, cpts, cand, qrow, valid, out, T, C, M, k)
    return out
