"""Why the bf16 flash kernels may round P and dS to bfloat16.

For bfloat16 inputs the forward (K3), the dK/dV backward (K4) and the dQ
backward (K5) of ``csrc/flash_attention_sm90.cu`` run their products on the
tensor cores as ``wgmma`` bf16 x bf16 with float32 accumulation, all with
the same arithmetic:

* S = Q K^T (K4: S^T = K Q^T and dP^T = V dO^T; K5: S and dP = dO V^T)
  multiplies the bf16 inputs as they are; a product of two bf16 values is
  exact in float32 and the sum is float32. ``scale`` multiplies the
  float32 sum afterwards (the JAX kernel scales q before the dot; the two
  differ by float32 rounding only, and not at all at D 64, where the scale
  is 1/8);
* P (K4: P^T and dS^T; K5: dS) is formed in float32, rounded once to bf16
  (round to nearest even) and fed to the next product, O += P V (K4: dV +=
  P^T dO, dK += dS^T Q; K5: dQ += dS K); the softmax row sum l is taken
  over the float32 P.

This test emulates that arithmetic on the CPU: inputs are seeded numpy
arrays rounded to bf16, products of bf16 values are summed exactly in
float64 and rounded to float32, and the forward walks k tiles with the
kernel's online softmax (running max m, alpha = exp(m_old - m_new), P =
exp(s - m) rounded to bf16 per tile): 64 keys, the tile of the mma.sync
forward that came before, and 128, the wgmma forward's (WGMMA_TILE). Outputs are rounded to bf16 as
the kernels write them, and held against the plain versions on the same
bf16 inputs within FLASH_REL_BF16 = 1e-2 (out, dq, dk, dv; the port's bf16
tolerance for the flash kernels, ``chip_smoke.py`` and
``tests/test_torch_kernels.py``) and FLASH_REL_F32 = 1e-4 (lse, float32
on both sides), as max|diff| / max|plain| over the rows with a live key.

Measured (max|emulated - plain| / max|plain|; first in float32, before
the outputs are rounded to bf16, then as written in bf16; the forward at
k tiles of 64 keys, and at 128, where it differs):

  case (B, S, H, D, causal, kv_valid)   out               lse      dq                dk                dv
  (2, 128, 2, 64, causal)               6.7e-4 / 2.3e-3   8.5e-8   1.8e-3 / 6.7e-3   2.1e-3 / 3.4e-3   1.8e-3 / 4.0e-3
  (2, 128, 2, 64, causal + kv_valid)    7.6e-4 / 2.3e-3   9.0e-8   1.6e-3 / 6.7e-3   1.9e-3 / 6.9e-3   1.9e-3 / 3.3e-3
  (2, 96, 2, 64, kv_valid)              1.4e-3 / 4.4e-3   8.9e-8   2.4e-3 / 6.5e-3   2.0e-3 / 6.1e-3   1.5e-3 / 6.3e-3
  (1, 1024, 2, 64, causal)              7.8e-4 / 3.2e-3   1.2e-7   2.1e-3 / 6.8e-3   2.3e-3 / 2.9e-3   1.4e-3 / 4.7e-3
  forward at k tiles of 128 keys        the same to two digits in every case (the S 96 and 128 cases are one tile)

(At 12 heads, (1, 1024) and (1, 1000) causal and (2, 512) with kv_valid,
the float32 values stay at or under 2.2e-3.) Every float32 value is under
5e-3, so no operand needs a second (lo) bf16 term: dS enters dQ += dS K
as one bf16 term, as it enters dK += dS^T Q. Under one bf16 step of
the largest output (2**-8 to 2**-7 of it), the written values differ from
the plain ones by at most that one step, which stays inside 1e-2. The
float32 values are above the float32 tolerance of 1e-4, so these kernels
serve bf16 inputs only: float32 keeps its 3xTF32 kernels
(``tests/test_torch_tf32_split.py``).
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module(
    "distributed_pytorch_training_tpu_torch.ops.flash_attention")

FLASH_REL_BF16 = 1e-2
FLASH_REL_F32 = 1e-4
# the design's bar: an operand whose rounding puts an output above this in
# float32 would be split in two bf16 terms (hi + lo)
SPLIT_BAR = 5e-3
TILE = 64                      # keys a k tile of the mma.sync forward
WGMMA_TILE = 128               # and of the wgmma forward
DQ_TILE = 64                   # keys a k tile of the wgmma dQ


def bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16, to nearest even, as
    ``__float22bfloat162_rn`` rounds it; returned as float32."""
    return x.to(torch.bfloat16).float()


def mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of two bf16-valued operands on the tensor cores: exact
    products, a float32 sum (emulated as an exact float64 sum rounded
    once)."""
    return torch.einsum(eq, a.double(), b.double()).float()


def forward_bf16(q, k, v, causal, kv_valid, tile=TILE):
    """(out in float32, lse) of the K3 bf16 kernel's arithmetic: per k tile
    of ``tile`` keys S = fp32(Q K^T) * scale, masked, online softmax in
    float32, P rounded to bf16 into O = alpha O + P V."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = np.float32(1.0 / np.sqrt(d))
    m = torch.full((b, h, sq, 1), fa.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = mm("bshd,bthd->bhst", q, kt) * scale
        if causal:
            rows = torch.arange(sq)[:, None]
            cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = torch.where(rows >= cols, s, fa.NEG_INF)
        if kv_valid is not None:
            s = torch.where(kv_valid[:, None, None, k0:k0 + tile] > 0, s,
                            fa.NEG_INF)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm("bhst,bthd->bhsd", bf16(p), vt)
        m = mx
    l = l.clamp(min=1e-30)
    out = (o / l).permute(0, 2, 1, 3)
    return out, (m + torch.log(l)).reshape(b * h, 1, sq)


def backward_bf16(q, k, v, g, lse, delta, causal, kv_valid):
    """(dq, dk, dv) in float32 of the K4 and K5 bf16 kernels' arithmetic: S
    and dP (K4: S^T and dP^T) from exact products, P and dS in float32,
    each rounded to bf16 into dQ += dS K (K5), dV += P^T dO and dK += dS^T
    Q (K4)."""
    b, sq, h, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    s = scale * mm("bshd,bthd->bhst", q, k)
    s = fa._masked_scores(s, causal, kv_valid)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = mm("bshd,bthd->bhst", g, v)
    ds = bf16(p * (dp - delta.reshape(b, h, sq, 1)) * scale)
    return (mm("bhst,bthd->bshd", ds, k), mm("bhst,bshd->bthd", ds, q),
            mm("bhst,bshd->bthd", bf16(p), g))


def dq_bf16_tiled(q, k, v, g, lse, delta, causal, kv_valid, tile=DQ_TILE):
    """dQ in float32 of the K5 wgmma kernel's arithmetic, k tile by k
    tile of ``tile`` keys: S and dP of the tile from exact products, dS in
    float32 rounded once to bf16, the tile's dS K summed exactly and added
    to the float32 dQ accumulator."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = np.float32(1.0 / np.sqrt(d))
    dq = torch.zeros((b, sq, h, d))
    for k0 in range(0, sk, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = scale * mm("bshd,bthd->bhst", q, kt)
        rows = torch.arange(sq)[:, None]
        cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
        if causal:
            s = torch.where(rows >= cols, s, fa.NEG_INF)
        if kv_valid is not None:
            s = torch.where(kv_valid[:, None, None, k0:k0 + tile] > 0, s,
                            fa.NEG_INF)
        p = torch.exp(s - lse.reshape(b, h, sq, 1))
        dp = mm("bshd,bthd->bhst", g, vt)
        ds = bf16(p * (dp - delta.reshape(b, h, sq, 1)) * scale)
        dq = (dq.double() + torch.einsum("bhst,bthd->bshd", ds.double(),
                                         kt.double())).float()
    return dq


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


# (B, S, H, D, causal, masked): tests/test_torch_tf32_split.py's cases (the
# main path's head width, causal alone and with key padding, key padding
# alone), then the training path's length
CASES = [(2, 128, 2, 64, True, False), (2, 128, 2, 64, True, True),
         (2, 96, 2, 64, False, True), (1, 1024, 2, 64, True, False)]


def inputs(case):
    """q, k, v, dO (bf16-valued float32) and kv_valid of a case from seeded
    numpy arrays, and the (B, S) rows that have a live key."""
    b, s, h, d, causal, masked = case
    rng = np.random.RandomState(0)
    q, k, v, g = (bf16(torch.from_numpy(rng.randn(b, s, h, d)
                                        .astype(np.float32)))
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


def lse_rows(lse, b, h, s, live):
    return lse.reshape(b, h, s).transpose(1, 2)[live]


def fwd_errors(case, tile=TILE):
    """{out_f32, out, lse}: the emulated forward at k tiles of ``tile`` keys
    against the plain one, out in float32 (before rounding) and in bf16 (as
    written)."""
    b, s, h, _, causal, _ = case
    q, k, v, _, kv, live = inputs(case)
    want32, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None,
                                                      kv)
    want16, _ = fa.flash_attention_fwd_lse_ref(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), causal, None, kv)
    out, lse = forward_bf16(q, k, v, causal, kv, tile)
    return {"out_f32": rel_err(out[live], want32[live]),
            "out": rel_err(out.bfloat16()[live], want16[live]),
            "lse": rel_err(lse_rows(lse, b, h, s, live),
                           lse_rows(want_lse, b, h, s, live))}


def bwd_errors(case):
    """{dq_f32, dk_f32, dv_f32, dq, dk, dv}: the emulated dQ, dK and dV
    against the plain ones on the same lse and delta, in float32 and as
    written in bf16."""
    _, _, _, _, causal, _ = case
    q, k, v, g, kv, live = inputs(case)
    g = bf16(g * live[:, :, None, None])       # dead rows: zero weight
    out, lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None, kv)
    delta = fa._delta(bf16(out), g)

    def plain(*qkvg):
        return (fa.flash_attention_bwd_dq_ref(*qkvg, lse, delta, causal,
                                              None, kv),
                *fa.flash_attention_bwd_dkv_ref(*qkvg, lse, delta, causal,
                                                None, kv))

    want = plain(q, k, v, g)
    want16 = plain(*(t.bfloat16() for t in (q, k, v, g)))
    got = backward_bf16(q, k, v, g, lse, delta, causal, kv)
    errs = {}
    for name, x, w32, w16 in zip(("dq", "dk", "dv"), got, want, want16):
        errs[f"{name}_f32"] = rel_err(x, w32)
        errs[name] = rel_err(x.bfloat16(), w16)
    return errs


def test_bf16_rounding_is_round_to_nearest_even():
    step = 2.0 ** -7                            # one bf16 step at 1.0
    x = torch.tensor([1.0 + step / 2, 1.0 + 3 * step / 2,
                      -(1.0 + step / 2), 1.0 + step / 4, 3.0])
    assert bf16(x).tolist() == [1.0, 1.0 + 2 * step, -1.0, 1.0, 3.0]
    assert (bf16(x).view(torch.int32) & 0xFFFF).eq(0).all()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_bf16_mma_within_bf16_tolerance(case):
    errs = fwd_errors(case)
    assert errs["out_f32"] <= SPLIT_BAR, errs
    assert errs["out"] <= FLASH_REL_BF16, errs
    assert errs["lse"] <= FLASH_REL_F32, errs


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_bf16_wgmma_tile_within_bf16_tolerance(case):
    """The forward's arithmetic at the wgmma kernel's k tile of 128 keys,
    against the same tolerances."""
    errs = fwd_errors(case, WGMMA_TILE)
    assert errs["out_f32"] <= SPLIT_BAR, errs
    assert errs["out"] <= FLASH_REL_BF16, errs
    assert errs["lse"] <= FLASH_REL_F32, errs


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dkv_bf16_mma_within_bf16_tolerance(case):
    errs = bwd_errors(case)
    assert max(errs["dk_f32"], errs["dv_f32"]) <= SPLIT_BAR, errs
    assert max(errs["dk"], errs["dv"]) <= FLASH_REL_BF16, errs


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dq_bf16_mma_within_bf16_tolerance(case):
    errs = bwd_errors(case)
    assert errs["dq_f32"] <= SPLIT_BAR, errs
    assert errs["dq"] <= FLASH_REL_BF16, errs


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dq_bf16_wgmma_tile_within_bf16_tolerance(case):
    """K5's arithmetic at the wgmma kernel's k tile of 64 keys (dS rounded
    per tile, dQ summed in float32 across tiles), against the same
    tolerances as the untiled dQ."""
    _, _, _, _, causal, _ = case
    q, k, v, g, kv, live = inputs(case)
    g = bf16(g * live[:, :, None, None])       # dead rows: zero weight
    out, lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None, kv)
    delta = fa._delta(bf16(out), g)
    want = fa.flash_attention_bwd_dq_ref(q, k, v, g, lse, delta, causal,
                                         None, kv)
    want16 = fa.flash_attention_bwd_dq_ref(
        *(t.bfloat16() for t in (q, k, v, g)), lse, delta, causal, None, kv)
    got = dq_bf16_tiled(q, k, v, g, lse, delta, causal, kv)
    assert rel_err(got, want) <= SPLIT_BAR
    assert rel_err(got.bfloat16(), want16) <= FLASH_REL_BF16


@pytest.mark.parametrize("which", ["forward", "dkv", "dq"])
def test_bf16_rounding_misses_float32_tolerance(which):
    """The rounding of P and dS is real: in float32 the bf16 arithmetic
    lands outside the float32 tolerance, so float32 inputs keep their
    3xTF32 kernels."""
    case = CASES[-1]
    if which == "forward":
        err = fwd_errors(case)["out_f32"]
    elif which == "dkv":
        errs = bwd_errors(case)
        err = max(errs["dk_f32"], errs["dv_f32"])
    else:
        err = bwd_errors(case)["dq_f32"]
    assert err > FLASH_REL_F32
