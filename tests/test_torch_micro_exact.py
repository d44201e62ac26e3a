"""The arithmetic of the two script kernels' card designs, on the CPU.

Neither CUDA kernel runs here, so this file keeps a plain-PyTorch twin of
each kernel's arithmetic, and its tests hold the twins to the modules'
plain versions bit for bit (no tolerance: both kernels promise their
plain versions' bits).

- ``select_mxu``: the cut of each float32 of [x, y, z, float(cand)] into
  three bf16 pieces (values below 2⁻¹⁰³ scaled by 2⁶⁴ and flagged), their
  rebuild, and the dense one-hot product over them (``extract_twin``),
  over numpy draws of float32 bit patterns: normals across the exponent
  range, ±0, subnormals, values near 2⁻¹¹⁰, float(cand) for ids up to
  2³¹ (2²⁴ + 1 among them) and the script's ``make_inputs``. Every piece
  must be a bf16 value that is 0 or at least 2⁻¹²⁶ (no bf16 subnormal
  for the tensor cores to flush).
- ``moments_like``: the column tree split by residue (each residue's own
  tree, then the last s levels in order, ``_residue_sum``) and the whole
  statistic with it (``moments_like_split``), on random and on
  cancelling data.
- ``moments_split``: the τ search with the bracket packed
  (``PackedCounter``, ``packed_search``: cnt(lo) carried, the bracket's
  ≤ 32 slots one to a lane) makes the same probes, counts and τ as
  ``search_tau`` in every mode; the members' sums in the kernel's order
  (member i on lane i mod 32, then recursive halving across the lanes,
  ``halving_moments``) stay within count_le²·2⁻²⁴ of the plain version
  (that one promises the sums to that tolerance, not to the bit).
"""

import numpy as np
import pytest
import torch

from pct_tpu_torch.micro.moments_like import (
    CHUNK,
    NOUT,
    _halving_sum,
    moments_like_plain,
)
from pct_tpu_torch.micro import moments_split
from pct_tpu_torch.micro.moments_split import (
    MODES,
    SENT_BITS,
    moments_variant_plain,
    search_tau,
)
from pct_tpu_torch.micro.select_mxu import _emit_mxu, make_inputs
from pct_tpu_torch.ops.moments import _CHAIN, plain_d2, stats_agreement
from pct_tpu_torch.ops.select import _plain
from tests.test_torch_cuda import _variant_tile

TINY = 2.0**-126
TINY_EXP = 24        # biased float32 exponent of 2⁻¹⁰³ (csrc/select_mxu.cu)
SCALE = 2.0**64


# --- the twins of the kernels' arithmetic ---

def bf16_pieces(v: torch.Tensor):
    """``csrc/select_mxu.cu``'s cut of float32 ``v`` -> (hi, mid, lo,
    flag) float32, each a bf16 value: values below 2⁻¹⁰³ (zeros and
    subnormals too) are scaled by 2⁶⁴ (exact) and flagged 1.0; hi keeps
    the top 8 significant bits by truncation, mid the top 8 of the exact
    remainder, lo the rest."""
    bits = v.contiguous().view(torch.int32)
    tiny = ((bits >> 23) & 0xFF) < TINY_EXP
    s = torch.where(tiny, v * SCALE, v)
    mask = torch.tensor(-65536, dtype=torch.int32)   # 0xffff0000
    hi = (s.view(torch.int32) & mask).view(torch.float32)
    r = s - hi
    mid = (r.view(torch.int32) & mask).view(torch.float32)
    return hi, mid, r - mid, tiny.to(torch.float32)


def rebuild(hi, mid, lo, flag):
    """The kernel's rebuild of one extracted value: (hi + mid) + lo,
    scaled back by 2⁻⁶⁴ where flagged."""
    v = (hi + mid) + lo
    return torch.where(flag != 0, v * (1.0 / SCALE), v)


def extract_twin(pos: torch.Tensor, cpts: torch.Tensor, cand: torch.Tensor):
    """The kernel's extraction: the dense float32 product of one-hot rows
    (T, C k, M) with B (T, M, 16), B's columns the bf16 pieces of x, y,
    z, float(cand) (checked bf16-representable), then each value rebuilt.
    pos (T,C,k) int64 -> (nbrs (T,C,k,3), rows (T,C,k))."""
    T, C, k = pos.shape
    vals = torch.cat([cpts, cand.to(torch.float32)[..., None]], -1)
    pieces = bf16_pieces(vals)
    B = torch.cat(pieces, -1)                        # (T, M, 16)
    assert torch.equal(B.to(torch.bfloat16).to(torch.float32), B), \
        "a piece is not a bf16 value"
    onehot = torch.nn.functional.one_hot(
        pos.reshape(T, C * k), cpts.shape[1]).to(torch.float32)
    D = (onehot @ B).reshape(T, C, k, 4, 4)          # pieces × values
    out = rebuild(*D.unbind(-2))
    return out[..., :3], out[..., 3].to(torch.int32)


def _residue_sum(a: torch.Tensor, s: int) -> torch.Tensor:
    """``_halving_sum`` split as ``csrc/moments_like.cu`` splits it:
    residue r's columns (i ≡ r mod 2ˢ) summed by their own halving tree,
    levels h = n/2 .. 2ˢ of the whole tree, then the last s levels over
    the 2ˢ partials."""
    parts = torch.stack([_halving_sum(a[..., r::1 << s])
                         for r in range(1 << s)], dim=-1)
    return _halving_sum(parts)


def moments_like_split(x: torch.Tensor, y: torch.Tensor,
                       s: int = 1) -> torch.Tensor:
    """``moments_like_plain`` with each column sum taken as the kernel
    takes it (``_residue_sum``, the kernel's s = 1) and each maximum over
    the residues' maxima; the chunks added into the output in order from
    +0."""
    T, C, K = x.shape
    out = x.new_zeros((T, C, NOUT))
    for j in range(y.shape[1] // CHUNK):
        yj = y[:, j * CHUNK:(j + 1) * CHUNK]
        d = x.new_zeros((T, C, CHUNK))
        for kk in range(K):
            d += x[:, :, kk, None] * yj[:, None, :, kk]
        res = [d[..., r::1 << s] for r in range(1 << s)]
        stats = (_residue_sum(d, s),
                 torch.stack([p.amax(-1) for p in res], -1).amax(-1),
                 _residue_sum(d * d, s),
                 torch.stack([p.abs().amax(-1) for p in res], -1).amax(-1))
        out = out + torch.cat([v[..., None].expand(T, C, 32) for v in stats],
                              dim=-1)
    return out


INT_MAX = 2**31 - 1


class PackedCounter:
    """``csrc/moments_split.cu``'s count of #(bits ≤ t) for rows of bits
    (R, M) int32: over every slot until ``pack`` finds (lo, hi] holding
    at most 32 slots, then cnt(lo) at that moment plus #(packed slots ≤
    t), the packed slots taken in slot order, padded with INT_MAX."""

    def __init__(self, bits: torch.Tensor):
        self.bits = bits
        R = bits.shape[0]
        self.packed = torch.zeros(R, dtype=torch.bool)
        self.base = torch.zeros(R, dtype=torch.int32)
        self.lo_pack = torch.zeros(R, dtype=torch.int32)
        self.mine = torch.full((R, 32), INT_MAX, dtype=torch.int32)

    def count(self, t):
        full = (self.bits <= t[:, None]).sum(-1, dtype=torch.int32)
        pk = self.base + (self.mine <= t[:, None]).sum(-1, dtype=torch.int32)
        return torch.where(self.packed, pk, full)

    def pack(self, lo, hi, cl, ch):
        go = ~self.packed & (lo <= hi) & (ch - cl <= 32)
        inside = (self.bits > lo[:, None]) & (self.bits <= hi[:, None])
        assert torch.equal(inside.sum(-1, dtype=torch.int32)[go], (ch - cl)[go])
        order = torch.argsort((~inside).to(torch.uint8), dim=-1, stable=True)
        vals = torch.gather(torch.where(inside, self.bits, INT_MAX), -1, order)
        vals = torch.nn.functional.pad(vals, (0, 32), value=INT_MAX)[:, :32]
        self.mine = torch.where(go[:, None], vals, self.mine)
        self.base = torch.where(go, cl, self.base)
        self.lo_pack = torch.where(go, lo, self.lo_pack)
        self.packed = self.packed | go


def packed_search(bits: torch.Tensor, k: int, mode: str):
    """τ under ``mode`` as the kernel finds it for rows of bits (R, M):
    cnt(lo) and cnt(hi) carried each round, the bracket packed once it
    holds ≤ 32 slots, rounds batch-wide as ``search_tau`` runs them.
    Returns (τ, the mode's probes [(t, count)] in order, the counter)."""
    mn = bits.min(-1).values
    mx = torch.where(bits == SENT_BITS, -1, bits).max(-1).values
    hi = torch.clamp_min(mx, 0)
    lo = torch.minimum(mn - 1, hi)
    cnt = PackedCounter(bits)
    probes = []
    if mode in ("no_bisect", "d2_only"):
        return hi, probes, cnt
    cl, ch = cnt.count(lo), cnt.count(hi)

    def probe(t):
        c = cnt.count(t)
        probes.append((t, c))
        return c

    def bisect(lo, hi, cl, ch, rounds=None):
        r = 0
        while (r < rounds) if rounds is not None else bool(
                (hi - lo > 1).any()):
            cnt.pack(lo, hi, cl, ch)
            mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
            c = probe(mid)
            ge = c >= k
            hi, ch = torch.where(ge, mid, hi), torch.where(ge, c, ch)
            lo, cl = torch.where(ge, lo, mid), torch.where(ge, cl, c)
            r += 1
        return hi

    def nary(lo, hi, cl, ch, arity, rounds=None):
        r = 0
        while (r < rounds) if rounds is not None else bool(
                (hi - lo > 1).any()):
            cnt.pack(lo, hi, cl, ch)
            q = torch.clamp_min(torch.div(hi - lo, arity,
                                          rounding_mode="floor"), 1)
            nlo, nhi, ncl, nch = lo, hi, cl, ch
            for i in range(1, arity):
                m = torch.minimum(lo + i * q, hi)
                c = probe(m)
                up = (c >= k) & (m < nhi)
                down = (c < k) & (m > nlo)
                nhi, nch = torch.where(up, m, nhi), torch.where(up, c, nch)
                nlo, ncl = torch.where(down, m, nlo), torch.where(down, c, ncl)
            lo, hi, cl, ch = nlo, nhi, ncl, nch
            r += 1
        return hi

    if mode == "fixed26":
        return bisect(lo, hi, cl, ch, 26), probes, cnt
    if mode in ("quad", "quad_fixed", "oct_fixed"):
        arity = 8 if mode == "oct_fixed" else 4
        rounds = {"quad": None, "quad_fixed": 14, "oct_fixed": 10}[mode]
        return nary(lo, hi, cl, ch, arity, rounds), probes, cnt
    if mode == "interp4":
        f32 = torch.float32
        gl, gh = torch.zeros_like(lo), probe(hi)   # the guess's counts
        for _ in range(4):
            tlo = torch.clamp_min(lo, 0).view(f32)
            thi = hi.view(f32)
            denom = torch.clamp_min((gh - gl).to(f32), 1.0)
            tg = tlo + (thi - tlo) * ((k - gl).to(f32) / denom)
            gb = torch.minimum(torch.maximum(tg.view(torch.int32), lo + 1),
                               torch.maximum(hi - 1, lo + 1))
            c = probe(gb)
            ge = c >= k
            hi = torch.where(ge, gb, hi)
            ch, gh = torch.where(ge, c, ch), torch.where(ge, c, gh)
            lo = torch.where(ge, lo, gb)
            cl, gl = torch.where(ge, cl, c), torch.where(ge, gl, c)
        return bisect(lo, hi, cl, ch), probes, cnt
    return bisect(lo, hi, cl, ch), probes, cnt     # full, no_moments, no_am


def _halve(a: torch.Tensor, h: int) -> torch.Tensor:
    """One halving step over lanes (dim 1 of a (R, 32, n) tensor): lane l
    keeps a[l, j + h·up] + a[l ^ h, j + h·up] for j < h, up = l & h."""
    lane = torch.arange(32)
    up = ((lane & h) != 0).long()[None, :, None]
    j = torch.arange(h)[None, None, :] + h * up              # (1, 32, h)
    j = j.expand(a.shape[0], 32, h)
    mine = torch.gather(a, 2, j)
    theirs = torch.gather(a[:, lane ^ h], 2, j)
    return mine + theirs


def halving_moments(qpts, cpts, cand, qrow, valid, k: int, mode: str):
    """The 35 sums as the kernel adds them, (T, C, 35): the members
    (below τ, or at τ with a positive tie weight) in slot order, member i
    chained on lane i % 32 in round i // 32 (each monomial the plain
    version's float), then the lanes' partial sums by recursive halving:
    columns 0–31 over lane bits 16, 8, 4, 2, 1 (lane l ends with column
    l), columns 32–34 (and a zero) over bits 2, 1, then a butterfly over
    4, 8, 16."""
    T, C, _ = qpts.shape
    r, d2, _ = plain_d2(qpts, cpts, cand, qrow, valid)
    bits = d2.view(torch.int32)
    tau = search_tau(bits, k, mode)
    tb = tau[..., None]
    lt, le = bits < tb, bits <= tb
    count_lt, count_le = lt.sum(-1), le.sum(-1)
    count_eq = torch.clamp_min(count_le - count_lt, 1)
    w_tie = torch.clamp((k - count_lt).to(torch.float32)
                        / count_eq.to(torch.float32), 0.0, 1.0)
    eq = le & ~lt
    member = lt | (eq & (w_tie[..., None] > 0))
    sigma = torch.sqrt(torch.clamp_min(tau.view(torch.float32), 0.0))
    inv = torch.div(torch.ones_like(sigma), torch.clamp_min(sigma, 1e-30))
    hat = [torch.clamp(x * inv[..., None], -2.0, 2.0) for x in r]
    monos = [torch.where(lt, 1.0, w_tie[..., None].expand_as(d2))]
    monos += [None] * len(_CHAIN)
    for i, parent, axis in _CHAIN:
        monos[i] = monos[parent] * hat[axis]
    mono = torch.stack(monos, -1).reshape(T * C, -1, 35)
    member = member.reshape(T * C, -1)
    pos = torch.cumsum(member.to(torch.int64), -1) - 1
    lane_of, round_of = pos % 32, pos // 32
    acc = torch.zeros(T * C, 32, 35)
    for rnd in range(int(round_of[member].max()) + 1 if member.any() else 0):
        sel = member & (round_of == rnd)
        add = torch.where(sel[..., None], mono, 0.0)
        idx = torch.where(sel, lane_of, 0)[..., None].expand_as(add)
        # one member a lane a round: each lane's add is acc + its monomial
        part = torch.zeros_like(acc).scatter_add_(1, idx, add)
        acc = acc + part
    a = acc[..., :32]
    for h in (16, 8, 4, 2, 1):
        a = _halve(a, h)
    t = torch.cat([acc[..., 32:], torch.zeros(T * C, 32, 1)], -1)
    for h in (2, 1):
        t = _halve(t, h)
    x = t[..., 0]
    for off in (4, 8, 16):
        x = x + x[:, torch.arange(32) ^ off]
    out = torch.cat([a[..., 0], x[:, :3]], -1)
    return out.reshape(T, C, 35)


# --- the tests ---


def _values(kind, n=200_000, seed=0):
    """float32 draws of one kind, as a numpy array."""
    rng = np.random.default_rng(seed)
    if kind == "normal":        # every finite exponent, random mantissas
        exp = rng.integers(1, 255, n, dtype=np.uint32)
        bits = (rng.integers(0, 2, n, dtype=np.uint32) << 31) | (exp << 23) \
            | rng.integers(0, 1 << 23, n, dtype=np.uint32)
        return bits.view(np.float32)
    if kind == "subnormal":
        bits = (rng.integers(0, 2, n, dtype=np.uint32) << 31) \
            | rng.integers(1, 1 << 23, n, dtype=np.uint32)
        return bits.view(np.float32)
    if kind == "near_2^-110":   # both sides of the 2^-103 cut, full mantissas
        e = rng.uniform(-118, -96, n)
        return (np.sign(rng.standard_normal(n)) * 2.0**e).astype(np.float32)
    if kind == "zeros":
        return np.array([0.0, -0.0] * 8, np.float32)
    if kind == "ids":           # float(cand) for int32 ids, 2^24 + 1 among them
        ids = np.concatenate([rng.integers(0, 2**31, n),
                              [0, 1, 2**24 - 1, 2**24, 2**24 + 1, 2**24 + 3,
                               2**31 - 1, -1, -(2**31)]]).astype(np.int64)
        return torch.from_numpy(ids.astype(np.int32)).to(
            torch.float32).numpy()
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["normal", "subnormal", "near_2^-110",
                                  "zeros", "ids"])
def test_bf16_pieces_rebuild_every_bit(kind):
    v = torch.from_numpy(_values(kind))
    pieces = bf16_pieces(v)
    for p in pieces:   # bf16 values, none a bf16 subnormal
        assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)
        assert ((p == 0) | (p.abs() >= TINY)).all()
    back = rebuild(*pieces)
    want = v + 0.0      # the product's sum from +0: -0.0 reads +0.0
    assert torch.equal(back.view(torch.int32), want.view(torch.int32))
    if kind == "zeros":
        assert (v.view(torch.int32) < 0).any()      # a -0.0 was there
        assert (back.view(torch.int32) == 0).all()
    if kind == "near_2^-110":
        flag = pieces[3] != 0
        assert flag.any() and (~flag).any()
    if kind == "ids":
        ints = back.to(torch.int64)
        assert (ints == 2**24).any() and not (ints == 2**24 + 1).any()


def test_bf16_pieces_on_the_script_inputs():
    qp, cp, cand, _, _ = make_inputs(16, 32, 96, seed=3)
    for v in (qp, cp, cand.to(torch.float32)):
        back = rebuild(*bf16_pieces(v))
        assert torch.equal(back.view(torch.int32), (v + 0.0).view(torch.int32))


def _edge_tile(T=4, C=8, M=40, seed=5):
    """Script-recipe operands whose candidates hold the cut's edges: -0.0,
    values near 2⁻¹¹⁰, subnormals, and ids past 2²⁴."""
    qp, cp, cand, qrow, valid = make_inputs(T, C, M, seed=seed)
    rng = np.random.default_rng(seed)
    cp = cp.clone()
    n = cp[:, 0::5].shape[1]
    cp[:, 0::5, 0] = -0.0
    cp[:, 0::5, 1] = torch.from_numpy(
        _values("near_2^-110", T * n, seed).reshape(T, n))
    cp[:, 0::5, 2] = torch.from_numpy(
        _values("subnormal", T * n, seed).reshape(T, n))
    cand = cand + torch.from_numpy(
        rng.integers(0, 2, cand.shape).astype(np.int32)) * (1 << 24)
    return qp, cp, cand, qrow, valid


def test_extract_twin_on_every_slot():
    """Every candidate slot of the edge tile extracted once: the dense
    one-hot product over the bf16 pieces returns the gather's bits (+0.0
    for -0.0, ids through float32)."""
    ops = _edge_tile()
    T, M = ops[1].shape[:2]
    pos = torch.arange(M).expand(T, 2, M)          # (T, 2 queries, k = M)
    nbrs, rows = extract_twin(pos, ops[1], ops[2])
    want_n, want_r = _emit_mxu(pos, ops[1], ops[2])
    assert torch.equal(nbrs.view(torch.int32), want_n.view(torch.int32))
    assert torch.equal(rows, want_r)
    sub = (want_n != 0) & (want_n.abs() < TINY)
    assert sub.any() and (ops[1].view(torch.int32) < 0).any()
    assert (want_r != ops[2][:, None, :]).any()    # odd ids past 2^24


@pytest.mark.parametrize("tile", ["script", "edges"])
def test_extract_twin_on_the_winners(tile):
    """The rounds' winners extracted by the twin are the plain version's,
    bit for bit."""
    ops = make_inputs(8, 16, 64, seed=1) if tile == "script" \
        else _edge_tile()
    k = 6
    _, pos = _plain(*ops, k, lambda pos, cpts, cand: pos)
    nbrs, rows = extract_twin(pos, ops[1], ops[2])
    want_n, want_r = _emit_mxu(pos, ops[1], ops[2])
    assert torch.equal(nbrs.view(torch.int32), want_n.view(torch.int32))
    assert torch.equal(rows, want_r)


@pytest.mark.parametrize("width,s", [(256, 1), (256, 2), (256, 3),
                                     (64, 1), (64, 3), (8, 2), (8, 3),
                                     (2, 1)])
def test_residue_sum_is_the_halving_tree(width, s):
    rng = np.random.default_rng(width + s)
    a = torch.from_numpy((rng.standard_normal((64, width)) * 10.0 ** rng.
                          integers(-3, 4, (64, width))).astype(np.float32))
    assert torch.equal(_residue_sum(a, s).view(torch.int32),
                       _halving_sum(a).view(torch.int32))


def _cancelling(T, C, M, seed):
    """x and y whose chunk products sum close to 0: each chunk's second
    half of rows is minus its first plus a little noise."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, C, CHUNK)) * 100).astype(np.float32)
    y = rng.standard_normal((T, M, CHUNK)).astype(np.float32)
    for j in range(0, M, CHUNK):
        h = CHUNK // 2
        y[:, j + h:j + CHUNK] = -y[:, j:j + h] + 1e-4 * rng.standard_normal(
            (T, h, CHUNK)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("data", ["random", "cancelling"])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_moments_like_split_is_the_plain_version(data, s):
    """The kernel's split of each column tree and chunk order (s = 1 on the
    card) gives ``moments_like_plain``'s bits."""
    T, C, M = 2, 7, 512
    if data == "random":
        rng = np.random.default_rng(s)
        x, y = (torch.from_numpy(rng.standard_normal((T, n, CHUNK)).astype(
            np.float32)) for n in (C, M))
    else:
        x, y = _cancelling(T, C, M, s)
    want = moments_like_plain(x, y)
    got = moments_like_split(x, y, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if data == "cancelling":
        # chunk 0's sums are a few millionths of their terms' magnitudes,
        # and there the column order moves bits: a left-to-right sum of
        # the same products differs from the tree
        d = (x.double() @ y[:, :CHUNK].double().transpose(1, 2))
        assert (d.sum(-1).abs() < 1e-4 * d.abs().sum(-1)).all()
        d = x @ y[:, :CHUNK].transpose(1, 2)
        seq = d.new_zeros(d.shape[:-1])
        for n in range(CHUNK):
            seq = seq + d[..., n]
        assert not torch.equal(seq, _halving_sum(d))


VARIANT_TILES = ("random", "lattice", "sparse", "empty", "ties")


def _tile_ops(case, M=300, T=3, C=40):
    return [torch.from_numpy(a)
            for a in _variant_tile(len(case) + M, T=T, C=C, M=M, case=case)]


@pytest.mark.parametrize("case", VARIANT_TILES)
def test_packed_search_is_search_tau(case, monkeypatch):
    """In every mode the packed counts are the full counts: the same
    probes, the same counts in the same order and the same τ as
    ``search_tau``; on the random tile nearly every row packs, on the
    tied one (> 64 slots at the kth d²) none does."""
    k = 64
    _, d2, _ = plain_d2(*_tile_ops(case))
    bits = d2.view(torch.int32).reshape(-1, d2.shape[-1])
    for mode in MODES:
        seen = []
        count_le = moments_split._count_le

        def recorded(b, t):
            c = count_le(b, t)
            seen.append((t, c))
            return c

        monkeypatch.setattr(moments_split, "_count_le", recorded)
        want = search_tau(bits, k, mode)
        monkeypatch.setattr(moments_split, "_count_le", count_le)
        got, probes, cnt = packed_search(bits, k, mode)
        assert torch.equal(got, want), mode
        assert len(probes) == len(seen), mode
        for (t, c), (t0, c0) in zip(probes, seen):
            assert torch.equal(t, t0) and torch.equal(c, c0), mode
        # the kernel takes count_le / count_lt at τ from the packed
        # bracket where τ − 1 is at or above its lo
        at = cnt.packed & (got - 1 >= cnt.lo_pack)
        for t in (got, got - 1):
            full = (bits <= t[:, None]).sum(-1, dtype=torch.int32)
            assert torch.equal(cnt.count(t)[at], full[at]), mode
        if mode == "full" and case == "random":
            assert float(cnt.packed.float().mean()) > 0.9
            assert float(at.float().mean()) > 0.9
        if mode == "full" and case == "ties":
            assert not bool(cnt.packed.any())


@pytest.mark.parametrize("case", VARIANT_TILES)
@pytest.mark.parametrize("M", [40, 300])
def test_halving_moments_within_tolerance(case, M):
    """The kernel's order of the 35 sums stays within count_le²·2⁻²⁴ of
    the plain version's in every mode that sums, and a row without a
    weighted member (column 0, the weights' sum, is 0) has 35 zero sums
    in both. (A sum that cancels to 0 in the plain version's order need
    not in another: on the lattice some do not.)"""
    k = 16 if M == 40 else 64
    ops = _tile_ops(case, M=M, C=min(40, M - 8))
    for mode in ("full", "fixed26", "quad_fixed", "oct_fixed", "interp4",
                 "no_bisect", "no_am"):
        want = moments_variant_plain(*ops, k, mode=mode)
        sums = halving_moments(*ops, k, mode)
        got = torch.cat([sums, want[..., 35:]], -1)
        differing, ratio, _ = stats_agreement(got, want)
        assert differing == 0 and ratio <= 1.0, (mode, ratio)
        nobody = want[..., 0] == 0
        assert bool((sums[nobody] == 0).all()), mode
        assert bool((want[..., :35][nobody] == 0).all()), mode
        if case == "empty":
            assert bool(nobody.any())
