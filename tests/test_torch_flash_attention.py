"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions (full-matrix
float32); the JAX side runs ``_flash_fwd_lse``, ``_flash_bwd`` and
``jax.grad(flash_attention)`` in Pallas interpret mode, as
tests/test_attention.py runs them, with blocks small enough that the online
softmax walks several tiles. The same numpy-seeded inputs go to both.

Tolerances:
* ATOL = RTOL = 2e-5 for out, lse and the gradients at these sizes: both
  sides compute in float32 and differ only by the order of the sums (the
  online softmax rescales per tile, the plain version sums once); measured
  differences are below 2e-6.
* Rows whose keys are ALL masked are compared only where the result does
  not depend on the tile layout: without ``causal`` they emit mean(V) on
  both sides; under ``causal`` the kernels' result depends on which tiles
  are live, so those rows are checked finite and left out.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_training_tpu.ops.flash_attention import (
    _flash_bwd,
    _flash_fwd_lse,
    flash_attention as jax_flash_attention,
)

# the module (ops/__init__ re-exports its function of the same name)
fa = importlib.import_module(
    "distributed_pytorch_training_tpu_torch.ops.flash_attention")

ATOL = RTOL = 2e-5


def qkv(b=2, sq=32, sk=32, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32) * 0.5
    k = rng.randn(b, sk, h, d).astype(np.float32) * 0.5
    v = rng.randn(b, sk, h, d).astype(np.float32) * 0.5
    return q, k, v


def kv_valid_of(b, sk, seed=0):
    """Random key padding; batch row 0 has every key masked."""
    m = (np.random.RandomState(seed + 7).rand(b, sk) > 0.3)
    m = m.astype(np.float32)
    m[0] = 0.0
    return m


def torch_of(*xs):
    return [None if x is None else torch.from_numpy(np.array(x))
            for x in xs]


def live_rows(sq, sk, causal, kv):
    """(B, Sq) True where the query row attends at least one key."""
    keep = np.ones((sq, sk), bool)
    if causal:
        keep = np.tril(keep)
    if kv is None:
        return np.broadcast_to(keep.any(-1), (2, sq))
    return (keep[None] & (kv[:, None, :] > 0)).any(-1)


def close(got, want, rows=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if rows is not None:
        assert np.isfinite(got).all()
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


CASES = [
    # (sq, sk, causal, masked, block) -- block: the JAX kernels' tile
    pytest.param(32, 32, False, False, 8, id="full"),
    pytest.param(32, 32, True, False, 8, id="causal"),
    pytest.param(40, 40, True, False, 8, id="causal-40"),
    pytest.param(16, 48, True, False, 16, id="causal-sq16-sk48"),
    pytest.param(48, 16, True, False, 16, id="causal-sq48-sk16"),
    pytest.param(24, 40, False, True, 8, id="kv_valid-sq24-sk40"),
    pytest.param(32, 32, True, True, 8, id="causal-kv_valid"),
]


@pytest.mark.parametrize("sq,sk,causal,masked,block", CASES)
def test_forward_matches_jax_kernel(sq, sk, causal, masked, block):
    q, k, v = qkv(sq=sq, sk=sk)
    kv = kv_valid_of(2, sk) if masked else None
    scale = 0.3
    out_j, lse_j = _flash_fwd_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        block, block, None if kv is None else jnp.asarray(kv))
    tq, tk, tv, tkv = torch_of(q, k, v, kv)
    out, lse = fa.flash_attention_fwd_lse(tq, tk, tv, causal, scale, tkv)
    assert out.shape == (2, sq, 2, 16) and lse.shape == (4, 1, sq)
    live = live_rows(sq, sk, causal, kv)                  # (B, Sq)
    if causal:
        close(out.numpy(), out_j, live)
        close(lse.numpy().reshape(2, 2, sq).transpose(0, 2, 1),
              np.asarray(lse_j).reshape(2, 2, sq).transpose(0, 2, 1), live)
    else:
        close(out.numpy(), out_j)
        close(lse.numpy(), lse_j)


def test_all_masked_row_is_mean_of_v_not_nan():
    """NEG_INF masking: a row with every key masked emits mean(V) (the
    JAX docstring's contract); -inf masking would give NaN."""
    q, k, v = qkv(sq=8, sk=24)
    kv = np.zeros((2, 24), np.float32)
    kv[1, 3:] = 1.0
    tq, tk, tv, tkv = torch_of(q, k, v, kv)
    out, lse = fa.flash_attention_fwd_lse(tq, tk, tv, False, None, tkv)
    np.testing.assert_allclose(out[0].numpy(),
                               np.broadcast_to(v[0].mean(0), (8, 2, 16)),
                               atol=1e-6)
    assert np.all(lse[:2].numpy() == fa.NEG_INF)
    assert torch.isfinite(out).all()


def test_scale_default_and_placement():
    """sm_scale=None is 1/sqrt(D); the forward scales q before the dot."""
    q, k, v = qkv(sq=16, sk=16)
    tq, tk, tv = torch_of(q, k, v)
    a, _ = fa.flash_attention_fwd_lse(tq, tk, tv, True, None)
    b, _ = fa.flash_attention_fwd_lse(tq, tk, tv, True, 0.25)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("sq,sk,causal,masked,block", CASES)
def test_backward_matches_jax_kernels(sq, sk, causal, masked, block):
    q, k, v = qkv(sq=sq, sk=sk, seed=1)
    g = np.random.RandomState(5).randn(2, sq, 2, 16).astype(np.float32)
    kv = kv_valid_of(2, sk, seed=1) if masked else None
    live = live_rows(sq, sk, causal, kv)
    # the loss zero-weights rows with no live key (the JAX contract)
    g = g * live[:, :, None, None]
    scale = 0.25
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jkv = None if kv is None else jnp.asarray(kv)
    out_j, lse_j = _flash_fwd_lse(jq, jk, jv, causal, scale, block, block,
                                  jkv)
    dq_j, dk_j, dv_j = _flash_bwd(jq, jk, jv, out_j, lse_j, jg, causal,
                                  scale, block, block, jkv)
    tq, tk, tv, tg, tkv = torch_of(q, k, v, g, kv)
    out, lse = fa.flash_attention_fwd_lse(tq, tk, tv, causal, scale, tkv)
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, out, lse, tg, causal,
                                        scale, tkv)
    close(dq.numpy(), dq_j)
    close(dk.numpy(), dk_j)
    close(dv.numpy(), dv_j)


def test_backward_remasks_padded_keys():
    """With kv_valid, no gradient reaches a padded key from a live row."""
    q, k, v = qkv(sq=16, sk=16, seed=2)
    kv = np.ones((2, 16), np.float32)
    kv[:, 10:] = 0.0
    tq, tk, tv, tkv = torch_of(q, k, v, kv)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    fa.flash_attention(tq, tk, tv, True, None, tkv).square().sum().backward()
    assert tk.grad[:, 10:].abs().max() == 0
    assert tv.grad[:, 10:].abs().max() == 0


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_autograd_function_matches_jax_grad(causal, masked):
    """flash_attention's gradients against jax.grad of the JAX custom_vjp
    (its Pallas backward), on a loss that weights every row."""
    q, k, v = qkv(sq=24, sk=24, seed=3)
    kv = kv_valid_of(2, 24, seed=3) if masked else None
    w = np.random.RandomState(9).randn(2, 24, 2, 16).astype(np.float32)
    if masked:
        w[0] = 0.0   # batch row 0 is all masked: zero-weighted

    def jloss(q, k, v):
        o = jax_flash_attention(q, k, v, causal, None, 8, 8,
                                None if kv is None else jnp.asarray(kv))
        return jnp.sum(o * w)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                             for x in (q, k, v)))
    tq, tk, tv, tkv = torch_of(q, k, v, kv)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    (fa.flash_attention(tq, tk, tv, causal, None, tkv)
     * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), gj):
        close(got.numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_autograd_of_plain_forward(causal):
    q, k, v = qkv(sq=20, sk=20, seed=4)
    w = torch.from_numpy(
        np.random.RandomState(3).randn(2, 20, 2, 16).astype(np.float32))
    grads = []
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c, causal),
               lambda a, b, c: fa.flash_attention_fwd_lse_ref(
                   a, b, c, causal)[0]):
        ts = [t.requires_grad_(True) for t in torch_of(q, k, v)]
        (fn(*ts) * w).sum().backward()
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors K4 and K5's wrappers return the plain version's
    parts, and no wrapper counts a launch."""
    q, k, v = qkv(sq=16, sk=16, seed=6)
    g = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    tq, tk, tv, tg = torch_of(q, k, v, g)
    before = (fa.flash_attention_fwd_lse.launches,
              fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    out, lse = fa.flash_attention_fwd_lse(tq, tk, tv, True)
    delta = fa._delta(out, tg)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tg, lse, delta, True)
    dq = fa.flash_attention_bwd_dq(tq, tk, tv, tg, lse, delta, True)
    ref = fa.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, True)
    for got, want in zip((dq, dk, dv), ref):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert before == (fa.flash_attention_fwd_lse.launches,
                      fa.flash_attention_bwd_dkv.launches,
                      fa.flash_attention_bwd_dq.launches)


def test_wrapper_checks_shapes_and_dtypes():
    tq, tk, tv = torch_of(*qkv(sq=8, sk=8))
    with pytest.raises(TypeError):
        fa.flash_attention_fwd_lse(tq.double(), tk.double(), tv.double(),
                                   True)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd_lse(tq[0], tk[0], tv[0], True)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd_lse(tq, tk[:, :, :1], tv, True)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd_lse(tq, tk, tv, True,
                                   kv_valid=torch.ones(2, 9))


def test_adapter_routes_masks():
    """Padding masks ride the kernel; a mask with (Sq, Sk) structure goes
    to dot_product_attention combined with the causal mask."""
    from distributed_pytorch_training_tpu_torch.models.layers import (
        dot_product_attention,
    )

    q, k, v = torch_of(*qkv(sq=12, sk=12, seed=8))
    fn = fa.make_flash_attention_fn(causal=True)
    pad = torch.ones(2, 12, dtype=torch.bool)
    pad[1, 9:] = False
    got = fn(q, k, v, mask=pad[:, None, None, :])
    want, _ = fa.flash_attention_fwd_lse(q, k, v, True, None, pad)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    general = torch.rand(2, 1, 12, 12, generator=torch.Generator()
                         .manual_seed(0)) > 0.2
    general[..., 0] = True
    got = fn(q, k, v, mask=general)
    cm = torch.ones(12, 12, dtype=torch.bool).tril()[None, None]
    want = dot_product_attention(q, k, v, mask=general & cm)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert fa.flash_supports_length(1000) and fa.flash_supports_length(1)
    assert fa.flash_backend_supported("cuda")
    assert not fa.flash_backend_supported("cpu")
