"""The PyTorch port's serving path against the JAX package's, on the CPU.

* int8 ``quantize_params`` codes and scales are BITWISE the JAX engine's,
  leaf by leaf (``quantize_min_elements=64`` so that the tiny model's
  kernels and embeddings all quantize);
* ``serve_tokens`` gives close ``last_logits`` and equal greedy tokens in
  fp32 and in int8, the JAX engine running on the 8-device CPU mesh;
* ``pack``/``bucket`` are the JAX package's, element for element;
* the ``smoke`` CLI runs end to end on ``--device cpu`` and refuses what is
  not ported.

Tolerance: ATOL = RTOL = 1e-5 on logits (float32 reassociation and
LayerNorm's variance form, as in test_torch_gpt2.py). int8 weights
dequantize bitwise alike on both sides, so int8 logits share it. Greedy
tokens must be equal outright; they are for these seeded prompts (a
step whose top-2 gap fell within the tolerance would need the JAX
tokens teacher-forced instead).

bf16 serving (the model at ``dtype=bfloat16``, float32 weights): the
prefill logits within BF16_ATOL = 1e-6 of flax's bf16 forward run op by
op over the same packed batch (measured: all bitwise but one element in
873, one bf16 step of a logit near 1e-6 apart, 3.7e-9), the JAX engine's
bf16-vs-float32 gap (measured 1.3e-3) asserted above it, and the greedy
tokens equal to the JAX engine's. (The JAX engine's
compiled prefill keeps float32 through some fused bf16 chains on the CPU
and its logits move from flax's op-by-op ones by as much as that gap.)
"""

import jax
import numpy as np
import pytest

from distributed_pytorch_training_tpu.data import pack as jax_pack
from distributed_pytorch_training_tpu.models.gpt2 import (
    GPT2LMHead as JaxGPT2,
)
from distributed_pytorch_training_tpu.serving import (
    InferenceEngine as JaxEngine,
    QuantizedLeaf as JaxQuantizedLeaf,
    ServeConfig as JaxServeConfig,
)
from distributed_pytorch_training_tpu_torch.convert import (
    flax_path_to_name,
    load_flax_params,
)
from distributed_pytorch_training_tpu_torch.data import pack
from distributed_pytorch_training_tpu_torch.models import GPT2LMHead
from distributed_pytorch_training_tpu_torch.serving import (
    InferenceEngine,
    QuantizedLeaf,
    RequestQueue,
    ServeConfig,
    dequantize_params,
    int8_weight_bytes,
    quantize_params,
)
from distributed_pytorch_training_tpu_torch.serving.__main__ import main

ATOL = RTOL = 1e-5
BF16_ATOL = 1e-6
VOCAB = 97
TINY = dict(vocab_size=VOCAB, hidden_dim=32, depth=2, num_heads=2,
            max_position=64)
TINY_OVERRIDES = "vocab_size=97,hidden_dim=32,depth=2,num_heads=2"


@pytest.fixture(scope="module")
def weights(mesh8):
    jm = JaxGPT2(**TINY)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
                     train=False)["params"]
    tm = GPT2LMHead(**TINY)
    load_flax_params(tm, jax.device_get(params))
    return jm, params, tm


def engines(mesh8, weights, serve_dtype, min_elements=4096):
    jm, params, tm = weights
    kw = dict(buckets=(8, 16), rows=8, max_new_tokens=4,
              serve_dtype=serve_dtype, quantize_min_elements=min_elements)
    jax_engine = JaxEngine(jm, mesh8, JaxServeConfig(**kw), params)
    port = InferenceEngine(tm, ServeConfig(**kw),
                           dict(tm.named_parameters()), device="cpu")
    return jax_engine, port


def prompts(ns, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype(np.int32) for n in ns]


def flax_leaves(tree, prefix=()):
    """(path, leaf) over a served JAX tree, QuantizedLeaf kept whole."""
    if isinstance(tree, JaxQuantizedLeaf) or not hasattr(tree, "items"):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from flax_leaves(v, prefix + (k,))


def test_quantize_params_bitwise_equals_jax_engine(mesh8, weights):
    jax_engine, port = engines(mesh8, weights, "int8", min_elements=64)
    ref = dict(flax_leaves(jax.device_get(jax_engine._served)))
    assert set(map(flax_path_to_name, ref)) == set(port._served)
    n_quantized = 0
    for path, leaf in ref.items():
        mine = port._served[flax_path_to_name(path)]
        if isinstance(leaf, JaxQuantizedLeaf):
            assert isinstance(mine, QuantizedLeaf)
            np.testing.assert_array_equal(mine.q.numpy(), np.asarray(leaf.q))
            np.testing.assert_array_equal(
                mine.scale.numpy().view(np.uint32),
                np.asarray(leaf.scale).view(np.uint32))
            n_quantized += 1
        else:
            assert not isinstance(mine, QuantizedLeaf)
            np.testing.assert_array_equal(mine.detach().numpy(),
                                          np.asarray(leaf))
    # wte, wpe, and per block the qkv/out/fc1/fc2 kernels plus the 3-D
    # (3, heads, head_dim) qkv bias, which reaches 64 elements here
    assert n_quantized == 2 + 5 * TINY["depth"]


def test_int8_bytes_and_dequantize(weights):
    _, _, tm = weights
    params = {n: p.detach() for n, p in tm.named_parameters()}
    served = quantize_params(params, min_elements=64)
    sizes = int8_weight_bytes(served)
    n_exact = sum(p.numel() for n, p in params.items()
                  if not isinstance(served[n], QuantizedLeaf))
    assert sizes["exact_bytes"] == 4 * n_exact
    deq = dequantize_params(served)
    for name, leaf in served.items():
        if isinstance(leaf, QuantizedLeaf):
            # per-row error is at most half a step of that row's scale
            err = (deq[name] - params[name]).abs()
            assert (err <= leaf.scale[..., None] * 0.5 + 1e-12).all()


@pytest.mark.parametrize("serve_dtype", ["fp32", "int8"])
def test_serve_tokens_matches_jax_engine(mesh8, weights, serve_dtype):
    jax_engine, port = engines(mesh8, weights, serve_dtype)
    for group in (prompts((5, 8, 3)), prompts((12, 9), seed=1)):
        ref = jax_engine.serve_tokens(group, return_prompt_logits=True)
        out = port.serve_tokens(group, return_prompt_logits=True)
        for r, o, p in zip(ref, out, group):
            assert o.bucket == r.bucket
            np.testing.assert_allclose(o.last_logits, r.last_logits,
                                       atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(o.prompt_logits, r.prompt_logits,
                                       atol=ATOL, rtol=RTOL)
            assert o.prompt_logits.shape == (len(p), VOCAB)
            assert o.tokens.dtype == np.int32
            np.testing.assert_array_equal(o.tokens, r.tokens)


def test_serve_tokens_fewer_new_tokens(weights):
    _, _, tm = weights
    port = InferenceEngine(tm, ServeConfig(buckets=(8,), rows=4,
                                           max_new_tokens=4),
                           dict(tm.named_parameters()), device="cpu")
    res = port.serve_tokens(prompts((3,)), max_new_tokens=2)
    assert res[0].tokens.shape == (2,)


@pytest.mark.parametrize("lengths,buckets", [
    ((1, 8), (8, 16)), ((9,), (8, 16)), ((16, 3, 7), (4, 16)),
])
def test_pack_and_bucket_identical(lengths, buckets):
    seqs = prompts(lengths, seed=2)
    for n in lengths:
        assert pack.bucket_for(n, buckets) == jax_pack.bucket_for(n, buckets)
    bucket = max(pack.bucket_for(n, buckets) for n in lengths)
    mine = pack.pack_token_rows(seqs, bucket, 4, pad_id=3)
    ref = jax_pack.pack_token_rows(seqs, bucket, 4, pad_id=3)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    outs = np.arange(4 * bucket * 2).reshape(4, bucket, 2)
    for a, b in zip(pack.unpack_token_rows(outs, mine[1], len(seqs)),
                    jax_pack.unpack_token_rows(outs, ref[1], len(seqs))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pack.bucket_for(max(buckets) + 1, buckets)


def test_queue_groups_by_bucket():
    q = RequestQueue((8, 16))
    a, b, c = (q.submit(p) for p in prompts((3, 12, 5)))
    assert [r.id for r in q.next_batch(8)] == [a.id, c.id]
    assert [r.id for r in q.next_batch(8)] == [b.id]
    q.close()
    with pytest.raises(RuntimeError):
        q.submit(prompts((2,))[0])


@pytest.mark.parametrize("serve_dtype", ["fp32", "int8", "bf16"])
def test_smoke_cli_on_cpu(serve_dtype, capsys, tmp_path):
    assert main(["smoke", "--device", "cpu", "--serve-dtype", serve_dtype,
                 "--model-overrides", TINY_OVERRIDES, "--output-dir",
                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("serving smoke: prompt[") == 3
    assert "serving smoke: ok (3 requests)" in out
    # the JAX serving CLI's stream: each request's queue_wait, each
    # batch's prefill and decode, the shutdown drain
    from distributed_pytorch_training_tpu_torch.telemetry.__main__ import (
        read_stream, summarize,
    )

    events, bad = read_stream(str(tmp_path / "telemetry_rank0.jsonl"))
    spans = summarize(events)["spans"]
    assert bad == 0 and events[0]["entry"] == "serving"
    assert spans["queue_wait"]["count"] == 3 and spans["drain"]["count"] == 1
    assert spans["prefill"]["count"] == spans["decode"]["count"] >= 1


def test_smoke_cli_failure_leaves_a_flight(tmp_path):
    """An abnormal serving exit (a prompt past the model's vocab) leaves a
    flight_*.json naming the failure, as the JAX serving CLI does."""
    with pytest.raises(Exception):
        main(["smoke", "--device", "cpu", "--model-overrides",
              TINY_OVERRIDES, "--prompt", "5,100000", "--output-dir",
              str(tmp_path)])
    flight, = tmp_path.glob("flight_*.json")
    assert "serving abnormal exit" in flight.read_text()


# bench and serve are ported (tests/test_torch_continuous.py); what they
# still refuse is a mesh, and fleet is refused whole
@pytest.mark.parametrize("argv", [
    ["bench", "--mesh", "data=2"], ["serve", "--mesh", "data=2"],
    ["fleet"], ["bench", "--ckpt-dir", "x", "--mesh", "data=2"],
    ["smoke", "--mesh", "data=2"],
], ids=["bench", "serve", "fleet", "bench-ckpt-dir", "mesh"])
def test_smoke_cli_refuses_unported(argv):
    with pytest.raises(SystemExit, match="not ported to PyTorch yet"):
        main(argv + ["--device", "cpu"])


def test_bf16_serving_matches_flax_and_the_jax_engine(mesh8, weights):
    import jax.numpy as jnp
    import torch

    _, params, _ = weights
    kw = dict(buckets=(8, 16), rows=8, max_new_tokens=4, serve_dtype="bf16")
    jm = JaxGPT2(**TINY, dtype=jnp.bfloat16)
    jax_engine = JaxEngine(jm, mesh8, JaxServeConfig(**kw), params)
    jax_fp32 = JaxEngine(JaxGPT2(**TINY), mesh8, JaxServeConfig(
        **dict(kw, serve_dtype="fp32")), params)
    tm = GPT2LMHead(**TINY, dtype=torch.bfloat16)
    load_flax_params(tm, jax.device_get(params))
    port = InferenceEngine(tm, ServeConfig(**kw),
                           dict(tm.named_parameters()), device="cpu")
    assert all(p.dtype == torch.float32 for p in port._served.values())
    for group in (prompts((5, 8, 3)), prompts((12, 9), seed=1)):
        out = port.serve_tokens(group, return_prompt_logits=True)
        ref = jax_engine.serve_tokens(group)
        ref32 = jax_fp32.serve_tokens(group)
        bucket = out[0].bucket
        ids, lengths, _ = pack.pack_token_rows(group, bucket, 8)
        with jax.disable_jit():
            flax_logits = np.asarray(jm.apply({"params": params}, ids,
                                              train=False))
        gap = 0.0
        for i, (o, r, r32, p) in enumerate(zip(out, ref, ref32, group)):
            np.testing.assert_allclose(o.prompt_logits,
                                       flax_logits[i, :len(p)], rtol=0,
                                       atol=BF16_ATOL)
            np.testing.assert_allclose(o.last_logits,
                                       flax_logits[i, len(p) - 1], rtol=0,
                                       atol=BF16_ATOL)
            np.testing.assert_array_equal(o.tokens, r.tokens)
            gap = max(gap, float(np.abs(r.last_logits
                                        - r32.last_logits).max()))
        assert gap > 100 * BF16_ATOL    # bf16 is really on, in JAX too
