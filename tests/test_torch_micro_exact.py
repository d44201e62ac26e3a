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
from pct_tpu_torch.micro.select_mxu import _emit_mxu, make_inputs
from pct_tpu_torch.ops.select import _plain

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
