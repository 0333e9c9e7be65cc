"""Why the flash-attention kernels split every product in three.

The float32 flash kernels (K3 forward, K4 dK/dV and K5 dQ, all in
``csrc/flash_attention_sm90_tf32.cu``) run their products on the tensor
cores in TF32 (``wgmma .tf32``), which keeps 10 bits of mantissa. Each
float32 operand x is split as x = big + small, and a product is big*big +
big*small + small*big (3xTF32; small*small is dropped). The tensor core
reads a float32 as TF32 by ignoring its low 13 bits, so big is the raw
float32 as TMA lands it (or as it sits in a register) and small = x -
trunc(x), itself read truncated. The rounded split of ``cvt.rna`` (to
nearest, ties away from zero: add 0x1000 to the float's bits and clear the
low 13), which earlier ``mma.sync`` kernels used, is emulated beside it as
the general case of the argument.

This test emulates that arithmetic on the CPU. It runs the plain
version's formulas with each product formed that way:

* the forward's two products, S = (scale Q) K^T (q scaled in float32
  before the split, as the kernel and the JAX kernel scale it) and
  O = P V, held as out and lse against the float32 plain forward;
* the backward's five (S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
  dQ = dS K), held as dq, dk and dv against the float32 plain backward.

For each:

* the three-product split lands within FLASH_REL / 10 of the plain
  version (terms summed exactly in float64);
* so do the wgmma kernels' own forms, with truncation for big and small,
  each 8-deep slice's three products (big small, small big, big big)
  added in that order to a float32 accumulator that runs over the whole
  depth, as ``wgmma`` accumulates: K4's dK and dV over every q row; K5's
  dQ over every key; K3's forward a 64-key tile at a time, with the
  online softmax between tiles and O rescaled by alpha and then carried
  on the same accumulator (the kernel adds each tile's P V to alpha O on
  the tensor cores, not in a separate sum). The kernels permute the keys
  (K3, K5) or q rows (K4) within each 8 of a transposed tile so that an
  accumulator is the next product's A operand; a slice keeps its 8, so
  the slices here are the same;
* one TF32 product does not land within FLASH_REL (for the forward, on
  ``out``), which is why the kernels pay for three.

FLASH_REL = 1e-4 is the port's float32 tolerance for the flash kernels
against their plain versions (``chip_smoke.py``,
``tests/test_torch_kernels.py``). Inputs are seeded numpy arrays.
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module(
    "distributed_pytorch_training_tpu_torch.ops.flash_attention")

FLASH_REL = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32 rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(passes: int):
    """An einsum of two float32 operands as the tensor cores form it: one
    TF32 product, or three (3xTF32). Terms summed exactly in float64."""

    def mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a_big, b_big = tf32(a), tf32(b)
        terms = [(a_big, b_big)]
        if passes == 3:
            a_small, b_small = tf32(a - a_big), tf32(b - b_big)
            terms += [(a_big, b_small), (a_small, b_big)]
        return sum(torch.einsum(eq, x.double(), y.double())
                   for x, y in terms).float()

    return mm


def trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 as the tensor core reads it in TF32: low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def wgmma_tf32(eq: str, a: torch.Tensor, b: torch.Tensor,
               acc: torch.Tensor = None) -> torch.Tensor:
    """An einsum of two float32 operands as the ``wgmma .tf32`` kernels form
    it: the contracted axis in slices of 8, each slice's big*small,
    small*big and big*big (big = trunc(x), small = trunc(x - big)) summed
    exactly and each added to a float32 accumulator (``acc``, or none) in
    that order."""
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    (axis,) = set(sa) & set(sb) - set(out)
    ia, ib = sa.index(axis), sb.index(axis)
    for s0 in range(0, a.shape[ia], 8):
        x = a.narrow(ia, s0, min(8, a.shape[ia] - s0))
        y = b.narrow(ib, s0, min(8, b.shape[ib] - s0))
        xb, yb = trunc(x), trunc(y)
        xs, ys = trunc(x - xb), trunc(y - yb)
        for u, w in ((xb, ys), (xs, yb), (xb, yb)):
            term = torch.einsum(eq, u.double(), w.double())
            acc = term.float() if acc is None else \
                (acc.double() + term).float()
    return acc


def backward_with(mm, q, k, v, g, lse, delta, causal, kv_valid):
    """(dq, dk, dv) of the plain version's formulas with products ``mm``."""
    b, sq, h, d = q.shape
    scale = 1.0 / np.sqrt(d)
    s = scale * mm("bshd,bthd->bhst", q, k)
    s = fa._masked_scores(s, causal, kv_valid)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = mm("bshd,bthd->bhst", g, v)
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    return (mm("bhst,bthd->bshd", ds, k), mm("bhst,bshd->bthd", ds, q),
            mm("bhst,bshd->bthd", p, g))


def forward_with(mm, q, k, v, causal, kv_valid):
    """(out, lse) of the plain forward's formulas with products ``mm``."""
    b, sq, h, d = q.shape
    s = mm("bshd,bthd->bhst", q * np.float32(1.0 / np.sqrt(d)), k)
    s = fa._masked_scores(s, causal, kv_valid)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = mm("bhst,bthd->bshd", p, v) / l.permute(0, 2, 1, 3)
    return out, (m + torch.log(l)).reshape(b * h, 1, sq)


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


# (B, S, H, D, causal, masked): the main path's head width, causal alone
# and with key padding, and key padding alone
CASES = [(2, 128, 2, 64, True, False), (2, 128, 2, 64, True, True),
         (2, 96, 2, 64, False, True)]


# the forward also at the training path's length
FWD_CASES = CASES + [(1, 1024, 2, 64, True, False)]


def inputs(case):
    """q, k, v, dO and kv_valid of a case from seeded numpy arrays, and the
    (B, S) rows that have a live key."""
    b, s, h, d, causal, masked = case
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                  for _ in range(4))
    kv = None
    if masked:
        kv = torch.from_numpy((rng.rand(b, s) > 0.3).astype(np.float32))
    keep = torch.ones((s, s), dtype=torch.bool)
    if causal:
        keep = keep.tril()
    live = keep.any(-1).expand(b, s) if kv is None else \
        (keep[None] & (kv[:, None, :] > 0)).any(-1)
    return q, k, v, g, kv, live


def fwd_errors(case, passes: int):
    """[out, lse] max|emulated - plain| / max|plain| over the live rows."""
    b, s, h, _, causal, _ = case
    q, k, v, _, kv, live = inputs(case)
    want = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None, kv)
    got = forward_with(product(passes), q, k, v, causal, kv)
    rows = [got[0][live], want[0][live]]
    for lse in (got[1], want[1]):
        rows.append(lse.reshape(b, h, s).transpose(1, 2)[live])
    return [rel_err(rows[0], rows[1]), rel_err(rows[2], rows[3])]


def errors(case, passes: int):
    """max over dq, dk, dv of max|emulated - plain| / max|plain|."""
    _, _, _, _, causal, _ = case
    q, k, v, g, kv, live = inputs(case)
    g = g * live[:, :, None, None]             # dead rows: zero weight
    out, lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None, kv)
    delta = fa._delta(out, g)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, g, causal, None, kv)
    got = backward_with(product(passes), q, k, v, g, lse, delta, causal, kv)
    return [rel_err(x, y) for x, y in zip(got, want)]


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10),
            1.0, 3.0]
    assert tf32(x).tolist() == want
    assert (tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_three_tf32_products_match_float32(case):
    assert max(errors(case, passes=3)) <= FLASH_REL / 10


def dkv_wgmma_errors(case):
    """[dk, dv] of K4's wgmma split against the plain backward."""
    _, _, _, _, causal, _ = case
    q, k, v, g, kv, live = inputs(case)
    g = g * live[:, :, None, None]             # dead rows: zero weight
    out, lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None, kv)
    delta = fa._delta(out, g)
    want = fa.flash_attention_bwd_dkv_ref(q, k, v, g, lse, delta, causal,
                                          None, kv)
    got = backward_with(wgmma_tf32, q, k, v, g, lse, delta, causal, kv)[1:]
    return [rel_err(x, y) for x, y in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dkv_wgmma_truncated_split_matches_float32(case):
    assert max(dkv_wgmma_errors(case)) <= FLASH_REL / 10


def test_truncation_drops_the_low_13_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -10, 3.0],
                     dtype=torch.float32)
    want = [1.0, 1.0 + 2.0 ** -10, -1.0, 1.0 + 2.0 ** -10, 3.0]
    assert trunc(x).tolist() == want
    small = x - trunc(x)
    assert torch.equal(trunc(x) + small, x)    # the split is exact


@pytest.mark.parametrize("case", CASES, ids=str)
def test_one_tf32_product_misses_float32_tolerance(case):
    assert max(errors(case, passes=1)) > FLASH_REL


@pytest.mark.parametrize("case", FWD_CASES, ids=str)
def test_forward_three_tf32_products_match_float32(case):
    assert max(fwd_errors(case, passes=3)) <= FLASH_REL / 10


@pytest.mark.parametrize("case", FWD_CASES, ids=str)
def test_forward_one_tf32_product_misses_float32_tolerance(case):
    assert fwd_errors(case, passes=1)[0] > FLASH_REL


def tile_scores(s, k0: int, causal: bool, kv_valid):
    """(B, H, Sq, n) logits of the keys k0.. with the plain version's masks
    (NEG_INF where causal, top-left, or kv_valid masks the key)."""
    sq, n = s.shape[-2:]
    rows = torch.arange(sq)[:, None]
    cols = k0 + torch.arange(n)[None, :]
    if causal:
        s = torch.where(cols <= rows, s, fa.NEG_INF)
    if kv_valid is not None:
        live = kv_valid[:, k0:k0 + n] > 0
        s = torch.where(live[:, None, None, :], s, fa.NEG_INF)
    return s


def forward_wgmma(q, k, v, causal, kv_valid, tile: int = 64):
    """(out, lse) as K3's wgmma kernel forms them at D 64: scale Q in
    float32, then a k tile of ``tile`` keys at a time S = (scale Q) K^T
    over D, the online softmax in float32 (m from NEG_INF, alpha, p, l),
    O = alpha O and O += P V on that same float32 accumulator over the
    tile's keys; out = O / l, l floored at 1e-30, lse = m + log l."""
    b, sq, h, d = q.shape
    qs = q * np.float32(1.0 / np.sqrt(d))
    m = torch.full((b, h, sq, 1), fa.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, k.shape[1], tile):
        s = wgmma_tf32("bshd,bthd->bhst", qs, k[:, k0:k0 + tile])
        s = tile_scores(s, k0, causal, kv_valid)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        o = wgmma_tf32("bhst,bthd->bhsd", p, v[:, k0:k0 + tile], o * alpha)
    l = l.clamp(min=1e-30)
    return (o / l).permute(0, 2, 1, 3), (m + torch.log(l)).reshape(
        b * h, 1, sq)


def fwd_wgmma_errors(case):
    """[out, lse] of K3's wgmma form against the plain forward, over the
    live rows."""
    b, s, h, _, causal, _ = case
    q, k, v, _, kv, live = inputs(case)
    want = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None, kv)
    got = forward_wgmma(q, k, v, causal, kv)
    rows = [got[0][live], want[0][live]]
    for lse in (got[1], want[1]):
        rows.append(lse.reshape(b, h, s).transpose(1, 2)[live])
    return [rel_err(rows[0], rows[1]), rel_err(rows[2], rows[3])]


@pytest.mark.parametrize("case", FWD_CASES, ids=str)
def test_fwd_wgmma_truncated_split_matches_float32(case):
    assert max(fwd_wgmma_errors(case)) <= FLASH_REL / 10


def dq_wgmma_errors(case):
    """dq of K5's wgmma form (S and dP over D, dQ over every key in one
    accumulator) against the plain backward."""
    _, _, _, _, causal, _ = case
    q, k, v, g, kv, live = inputs(case)
    g = g * live[:, :, None, None]             # dead rows: zero weight
    out, lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None, kv)
    delta = fa._delta(out, g)
    want = fa.flash_attention_bwd_dq_ref(q, k, v, g, lse, delta, causal,
                                         None, kv)
    got = backward_with(wgmma_tf32, q, k, v, g, lse, delta, causal, kv)[0]
    return rel_err(got, want)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dq_wgmma_truncated_split_matches_float32(case):
    assert dq_wgmma_errors(case) <= FLASH_REL / 10
