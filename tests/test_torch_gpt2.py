"""The PyTorch port's GPT-2 against the JAX package's, on converted weights.

The flax init's parameters go through ``convert.py`` into the port, the
same seeded token ids go through both models, and the port must agree:
eval logits, prefill logits and the filled KV cache, and three greedy
decode steps on each side's own cache (both fed the JAX model's tokens).

Tolerance: ATOL = RTOL = 1e-5. The two sides differ only by float32
reassociation in the matrix products and by LayerNorm's variance (flax
takes E[x^2] - E[x]^2, PyTorch two passes); measured differences at this
size are about 2e-7 in the logits and 2e-6 in the cache.

bf16 compute (``dtype=bfloat16``): the eval logits and the prefill's
filled cache BITWISE flax's run op by op (``jax.disable_jit``), which
rounds every op to bf16 as flax's ``dtype`` says; the JAX package's own
bf16-vs-float32 gap is asserted beside them. (A jitted program keeps
float32 through some fused bf16 chains on the CPU and moves the logits by
as much as that gap, so it is not the reference here.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_training_tpu.models.gpt2 import (
    GPT2LMHead as JaxGPT2,
)
from distributed_pytorch_training_tpu_torch.convert import (
    flax_path_to_name,
    iter_flax_leaves,
    load_flax_params,
)
from distributed_pytorch_training_tpu_torch.models import GPT2LMHead, get_model
from distributed_pytorch_training_tpu_torch.parallel.collectives import (
    TpAxis,
)
from distributed_pytorch_training_tpu_torch.ops.flash_attention import (
    make_flash_attention_fn,
)

ATOL = RTOL = 1e-5
TINY = dict(vocab_size=97, hidden_dim=32, depth=2, num_heads=2,
            max_position=64)


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT2(**TINY)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
                     train=False)["params"]
    tm = GPT2LMHead(**TINY)
    load_flax_params(tm, jax.device_get(params))
    return jm, params, tm


def ids_of(shape, seed=0):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], shape).astype(np.int32)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), b, atol=ATOL, rtol=RTOL)


def test_converted_names_cover_the_model(pair):
    _, params, tm = pair
    paths = [p for p, _ in iter_flax_leaves(jax.device_get(params))]
    names = {flax_path_to_name(p) for p in paths}
    assert names == {n for n, _ in tm.named_parameters()}
    assert flax_path_to_name(("block1", "attn", "qkv", "kernel")) \
        == "blocks.1.attn.qkv.kernel"
    # the flax layout is kept: qkv rows are head_dim wide
    assert tuple(tm.blocks[0].attn.qkv.kernel.shape) == (32, 3, 2, 16)


def test_eval_logits(pair):
    jm, params, tm = pair
    ids = ids_of((3, 10))
    ref = jm.apply({"params": params}, ids, train=False)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32
    close(ref, out.numpy())


def test_eval_logits_with_padding_mask(pair):
    jm, params, tm = pair
    ids = ids_of((2, 9), seed=1)
    am = np.ones((2, 9), np.int32)
    am[1, 5:] = 0
    ref = jm.apply({"params": params}, ids, attention_mask=am, train=False)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(am))
    close(ref, out.numpy())


def test_prefill_logits_and_filled_cache(pair):
    jm, params, tm = pair
    ids = ids_of((3, 10), seed=2)
    ref, ref_cache = jm.apply({"params": params}, ids, train=False,
                              cache=jm.init_cache(3, 16))
    with torch.no_grad():
        out, cache = tm(torch.from_numpy(ids).long(),
                        cache=tm.init_cache(3, 16))
    close(ref, out.numpy())
    assert len(cache) == TINY["depth"]
    for (rk, rv), (k, v) in zip(ref_cache, cache):
        assert tuple(k.shape) == (3, 16, 2, 16)
        close(rk, k.numpy())
        close(rv, v.numpy())


def test_three_decode_steps(pair):
    """Rows at different lengths decode together: each writes at its own
    position and attends slots <= that position."""
    jm, params, tm = pair
    ids = ids_of((3, 10), seed=3)
    lengths = np.array([10, 7, 4], np.int32)
    ref, ref_cache = jm.apply({"params": params}, ids, train=False,
                              cache=jm.init_cache(3, 16))
    with torch.no_grad():
        _, cache = tm(torch.from_numpy(ids).long(),
                      cache=tm.init_cache(3, 16))
    tok = np.asarray(ref)[np.arange(3), lengths - 1].argmax(-1)
    pos = lengths
    for _ in range(3):
        ref, ref_cache = jm.apply(
            {"params": params}, tok[:, None].astype(np.int32), train=False,
            cache=ref_cache, cache_positions=jnp.asarray(pos))
        with torch.no_grad():
            out, cache = tm(torch.from_numpy(tok[:, None]).long(),
                            cache=cache,
                            cache_positions=torch.from_numpy(pos).long())
        close(ref, out.numpy())
        for (rk, rv), (k, v) in zip(ref_cache, cache):
            close(rk, k.numpy())
            close(rv, v.numpy())
        tok = np.asarray(ref)[:, 0].argmax(-1)
        pos = pos + 1


def test_verify_window_decode(pair):
    """A decode window of S > 1 tokens per row (the speculative verify
    shape) matches the JAX model too."""
    jm, params, tm = pair
    ids = ids_of((2, 6), seed=4)
    win = ids_of((2, 3), seed=5)
    pos = np.array([6, 4], np.int32)
    _, ref_cache = jm.apply({"params": params}, ids, train=False,
                            cache=jm.init_cache(2, 12))
    ref, _ = jm.apply({"params": params}, win, train=False,
                      cache=ref_cache, cache_positions=jnp.asarray(pos))
    with torch.no_grad():
        _, cache = tm(torch.from_numpy(ids).long(),
                      cache=tm.init_cache(2, 12))
        out, _ = tm(torch.from_numpy(win).long(), cache=cache,
                    cache_positions=torch.from_numpy(pos).long())
    close(ref, out.numpy())


def test_registry_builds_published_widths():
    m = get_model("gpt2_124m", depth=1, vocab_size=50257, device="meta")
    assert (m.hidden_dim, m.num_heads) == (768, 12)
    assert tuple(m.wte.embedding.shape) == (50257, 768)
    assert tuple(m.blocks[0].mlp.fc1.kernel.shape) == (768, 3072)


@pytest.mark.parametrize("kw", [dict(tp=TpAxis(2)), dict(remat=True),
                                dict(dropout_rate=0.1),
                                dict(attention_fn=make_flash_attention_fn(
                                    causal=True))],
                         ids=["tp", "remat", "dropout", "kernel-attention"])
def test_unported_features_refuse(kw):
    if "remat" in kw:
        # remat is ported (models/layers.py::remat_call): the model builds
        # and its forward is the plain model's, bitwise
        plain, rematted = GPT2LMHead(**TINY), GPT2LMHead(**TINY, **kw)
        plain.reset_parameters(torch.Generator().manual_seed(0))
        rematted.load_state_dict(plain.state_dict())
        ids = torch.from_numpy(ids_of((2, 8))).long()
        assert rematted.remat and torch.equal(rematted(ids), plain(ids))
        return
    if "tp" in kw:
        # tensor parallelism is ported (tests/test_torch_tp.py): a TP-local
        # model holds its slices (half the heads; a vocab of 97 does not
        # split, so the embedding stays whole, as in the JAX module) and
        # refuses an init of its own, and the KV-cache paths, as the JAX
        # module does
        m = GPT2LMHead(**TINY, **kw)
        full = GPT2LMHead(**TINY)
        assert not m.tp_vocab
        assert m.wte.embedding.shape == full.wte.embedding.shape
        assert m.blocks[0].attn.qkv.kernel.shape[2] * 2 == \
            full.blocks[0].attn.qkv.kernel.shape[2]
        with pytest.raises(ValueError, match="slices of the global"):
            m.reset_parameters(torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="no KV-cache path"):
            m(torch.zeros((1, 4), dtype=torch.long), cache=m.init_cache(1, 8))
        return
    if "attention_fn" in kw:
        # kernel attention serves the no-cache forward; the KV-cache paths
        # refuse it, as the JAX module does
        m = GPT2LMHead(**TINY, **kw)
        with pytest.raises(ValueError, match="KV-cache decoding"):
            m(torch.zeros((1, 4), dtype=torch.long), cache=m.init_cache(1, 8))
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        GPT2LMHead(**TINY, **kw)


@pytest.mark.parametrize("mode", ["eval", "prefill"])
def test_bf16_logits_bitwise_flax(pair, mode):
    _, params, _ = pair
    jm = JaxGPT2(**TINY, dtype=jnp.bfloat16)
    tm = GPT2LMHead(**TINY, dtype=torch.bfloat16)
    load_flax_params(tm, jax.device_get(params))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    ids = ids_of((3, 10), seed=2)
    with jax.disable_jit():
        if mode == "eval":
            ref = jm.apply({"params": params}, ids, train=False)
        else:
            ref, ref_cache = jm.apply(
                {"params": params}, ids, train=False,
                cache=jm.init_cache(3, 16))
    fp32 = np.asarray(JaxGPT2(**TINY).apply({"params": params}, ids,
                                            train=False))
    with torch.no_grad():
        if mode == "eval":
            out = tm(torch.from_numpy(ids).long())
        else:
            out, cache = tm(torch.from_numpy(ids).long(),
                            cache=tm.init_cache(3, 16))
            for (k, v), (rk, rv) in zip(cache, ref_cache):
                assert k.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    k.float().numpy(), np.asarray(rk.astype(jnp.float32)))
                np.testing.assert_array_equal(
                    v.float().numpy(), np.asarray(rv.astype(jnp.float32)))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # bf16 is really on: flax's own bf16 logits are off its float32 ones
    assert np.abs(np.asarray(ref) - fp32).max() > 1e-3 * np.abs(fp32).max()
