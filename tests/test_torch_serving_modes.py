"""The port's engine in the JAX engine's other two serve modes, on the CPU:
a token batch (BERT: one bucketed forward, no tokens) and an image batch
(ResNet, ViT: ``serve_images``), against the JAX package's
``InferenceEngine`` from the same weights (``convert.py``; a ResNet's
``batch_stats`` too, random so that the eval forward reads them), drawn
by the port's init.

* ``serve_images``: ResNet-18 at full width (32x32 images are cheap) and a
  tiny ViT, fp32 and int8, against JAX's ``serve_images``; bf16 against
  flax's bf16 forward run op by op.
* ``serve_tokens`` of a tiny BERT, one ragged group in one bucket:
  ``last_logits`` and ``prompt_logits`` against JAX's engine (fp32, int8)
  and flax op by op (bf16); no tokens.
* int8 ``quantize_params`` codes and scales bitwise JAX's for all three.
* The cross-mode calls, the slot engine and ``measure_serving`` on an
  image model raise JAX's messages; the BERT row has no token rate.
* The ``serving smoke`` CLI on ``--device cpu`` for ``resnet18`` and
  ``bert_base``; a ResNet checkpoint is served with its BatchNorm
  statistics.

Tolerances: fp32 and int8 logits within ATOL = RTOL = 1e-5 (the GPT-2
serving test's: float32 reassociation; int8 weights dequantize bitwise
alike on both sides) except ResNet-18's, within LOGIT_ATOL = 1e-4 (the
ResNet test's: 17 convolutions of up to 4608 products); bf16 logits
within BF16_ATOL = 1e-6 of flax's op-by-op bf16 forward (the GPT-2 serving
test's), with flax's own bf16-vs-float32 gap asserted above 100x it;
full-width ResNet-18's within one bf16 step of its largest logit (2**-7
at logits of 1 to 2): its bf16 convolutions of up to 4608 products,
summed in another order by the CPU's oneDNN than by XLA, may round an
intermediate to the neighbouring bf16 value (measured on flax's own
init: 5 logits of 50 one step of 2**-8 apart; on the port's draw used
here: bitwise; bf16 against float32 moves them 0.013), where the narrow
ResNet of ``test_torch_resnet.py`` is bitwise.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_training_tpu.experiments import (
    harness as jax_harness,
)
from distributed_pytorch_training_tpu.models import (
    get_model as jax_get_model,
)
from distributed_pytorch_training_tpu.parallel import (
    MeshSpec as JaxMeshSpec, build_mesh as jax_build_mesh,
)
from distributed_pytorch_training_tpu.serving import (
    InferenceEngine as JaxEngine,
    PagedServeConfig as JaxPagedServeConfig,
    QuantizedLeaf as JaxQuantizedLeaf,
    ServeConfig as JaxServeConfig,
    SlotEngine as JaxSlotEngine,
)
from distributed_pytorch_training_tpu_torch.convert import (
    batch_stats_to_flax, flax_path_to_name, iter_flax_leaves,
    load_flax_params, torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.data import pack
from distributed_pytorch_training_tpu_torch.experiments.harness import (
    build_serving_engine, measure_serving,
)
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.serving import (
    InferenceEngine, PagedServeConfig, QuantizedLeaf, RequestQueue,
    ServeConfig, SlotEngine, serve_forever,
)
from distributed_pytorch_training_tpu_torch.serving.__main__ import (
    SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD, main, run,
)

from _torch_rig import port_process_state  # noqa: F401 (autouse)

ATOL = RTOL = 1e-5
LOGIT_ATOL = 1e-4
BF16_ATOL = 1e-6
BERT_VOCAB = 97
TINY_BERT = dict(vocab_size=BERT_VOCAB, hidden_dim=32, depth=2,
                 num_heads=2, mlp_dim=64, max_position=64)
TINY_VIT = dict(hidden_dim=32, depth=2, num_heads=2, mlp_dim=64,
                num_classes=10)
BERT_OVERRIDES = "hidden_dim=32,depth=2,num_heads=2,mlp_dim=64"
KW = dict(buckets=(8, 16), rows=8, max_new_tokens=4)


@pytest.fixture(scope="module")
def mesh1(devices):
    return jax_build_mesh(JaxMeshSpec(data=1), devices=devices[:1])


def image_batch(n=5, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 32, 32, 3)).astype(np.uint8)


def bert_prompts(ns=(5, 8, 3), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, BERT_VOCAB, n).astype(np.int32) for n in ns]


def flax_model(name, kw, dtype=jnp.float32):
    return jax_get_model(name, dtype=dtype, **kw)


def flax_init(name, kw):
    """(params, batch_stats) as flax trees, drawn by the port's own init
    (cheaper than flax's at ResNet-18's width; the weights are the same
    arrays on both sides); a ResNet's running statistics drawn at random
    near the init's (means about 0, variances about 1, so the activations
    live past the ReLUs), so that the served forward reads them."""
    model = get_model(name, **kw,
                      **({"image_size": 32} if name == "vit_b16" else {}))
    model.reset_parameters(torch.Generator().manual_seed(0))
    stats = batch_stats_to_flax(model) or None
    if stats is not None:
        rng = np.random.RandomState(1)

        def draw(path, x):
            if path[-1].key == "mean":
                return (rng.randn(*x.shape) * 0.1).astype(np.float32)
            return (rng.rand(*x.shape) * 0.5 + 0.75).astype(np.float32)

        stats = jax.tree_util.tree_map_with_path(draw, stats)
    return torch_to_flax(model), stats


IMAGE_MODELS = {"resnet18": {}, "vit_b16": TINY_VIT}


@pytest.fixture(scope="module")
def image_weights():
    return {name: flax_init(name, kw) for name, kw in IMAGE_MODELS.items()}


@pytest.fixture(scope="module")
def bert_weights():
    return flax_init("bert_base", TINY_BERT)[0]


def port_model(name, kw, params, stats=None, dtype=torch.float32):
    extra = {"image_size": 32} if name == "vit_b16" else {}
    model = get_model(name, dtype=dtype, **kw, **extra)
    load_flax_params(model, params, stats)
    return model


def port_engine(name, kw, params, stats, serve_dtype, min_elements=4096,
                dtype=torch.float32):
    model = port_model(name, kw, params, stats, dtype)
    batch_stats = ({n: b for n, b in model.named_buffers()}
                   if stats is not None else None)
    return InferenceEngine(model, ServeConfig(
        **KW, serve_dtype=serve_dtype, quantize_min_elements=min_elements),
        dict(model.named_parameters()), device="cpu",
        batch_stats=batch_stats)


def jax_engine(mesh, name, kw, params, stats, serve_dtype,
               min_elements=4096, dtype=jnp.float32):
    return JaxEngine(flax_model(name, kw, dtype), mesh, JaxServeConfig(
        **KW, serve_dtype=serve_dtype, quantize_min_elements=min_elements),
        params, batch_stats=stats)


# ---------------------------------------------------------------------------
# image batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("serve_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("name", list(IMAGE_MODELS))
def test_serve_images_matches_jax_engine(mesh1, image_weights, name,
                                         serve_dtype):
    params, stats = image_weights[name]
    kw = IMAGE_MODELS[name]
    ref = jax_engine(mesh1, name, kw, params, stats, serve_dtype)
    port = port_engine(name, kw, params, stats, serve_dtype)
    x = image_batch()
    want = ref.serve_images(x, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)
    got = port.serve_images(x, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)
    assert got.shape == want.shape == (5, 10) and got.dtype == np.float32
    tol = LOGIT_ATOL if name == "resnet18" else ATOL
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=tol)
    assert np.abs(want).max() > 100 * tol   # the logits are not ~0


def test_serve_images_reads_the_given_statistics(image_weights):
    """The served forward reads the running statistics the engine was
    given: other statistics, other logits; the template's buffers are
    not read."""
    params, stats = image_weights["resnet18"]
    port = port_engine("resnet18", {}, params, stats, "fp32")
    x = image_batch()
    want = port.serve_images(x, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)
    with torch.no_grad():
        for b in port.model.buffers():
            b.fill_(7.0)
    np.testing.assert_array_equal(
        port.serve_images(x, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD), want)
    other = InferenceEngine(port.model, port.config,
                            dict(port.model.named_parameters()),
                            device="cpu", batch_stats={
                                n: torch.ones_like(b) for n, b in
                                port.model.named_buffers()})
    assert np.abs(other.serve_images(x, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)
                  - want).max() > 1e-2


@pytest.mark.parametrize("name", list(IMAGE_MODELS))
def test_bf16_serve_images_matches_flax(image_weights, name):
    params, stats = image_weights[name]
    kw = IMAGE_MODELS[name]
    port = port_engine(name, kw, params, stats, "bf16",
                       dtype=torch.bfloat16)
    x = image_batch()
    got = port.serve_images(x, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)
    padded = np.zeros((8, 32, 32, 3), np.uint8)
    padded[:5] = x
    variables = {"params": params, **({"batch_stats": stats}
                                      if stats is not None else {})}
    from distributed_pytorch_training_tpu.data.augment import (
        normalize_images as jax_normalize,
    )

    with jax.disable_jit():
        want = np.asarray(flax_model(name, kw, jnp.bfloat16).apply(
            variables, jax_normalize(padded, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD,
                                     jnp.bfloat16), train=False))[:5]
    fp32 = np.asarray(flax_model(name, kw).apply(
        variables, jax_normalize(padded, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD),
        train=False))[:5]
    # ResNet-18 at full width: one bf16 step of the largest logit
    # (module docstring); the tiny ViT: BF16_ATOL
    tol = (2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
           if name == "resnet18" else BF16_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.abs(want - fp32).max() > max(tol, 100 * BF16_ATOL)


def test_serve_images_pads_and_refuses_past_rows(image_weights):
    params, stats = image_weights["vit_b16"]
    port = port_engine("vit_b16", TINY_VIT, params, stats, "fp32")
    x = image_batch(8)
    whole = port.serve_images(x, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)
    np.testing.assert_allclose(
        port.serve_images(x[:3], SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD), whole[:3],
        rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match=re.escape("9 images exceed "
                                                   "rows=8")):
        port.serve_images(image_batch(9), SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)


# ---------------------------------------------------------------------------
# token batch (BERT)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("serve_dtype", ["fp32", "int8"])
def test_bert_serve_tokens_matches_jax_engine(mesh1, bert_weights,
                                              serve_dtype):
    ref = jax_engine(mesh1, "bert_base", TINY_BERT, bert_weights, None,
                     serve_dtype)
    port = port_engine("bert_base", TINY_BERT, bert_weights, None,
                       serve_dtype)
    group = bert_prompts()
    want = ref.serve_tokens(group, return_prompt_logits=True)
    got = port.serve_tokens(group, return_prompt_logits=True)
    for r, o, p in zip(want, got, group):
        assert o.bucket == r.bucket == 8
        assert o.tokens.shape == (0,) and o.tokens.dtype == np.int32
        assert o.decode_s == 0.0 and o.prefill_s > 0
        np.testing.assert_allclose(o.last_logits, r.last_logits, atol=ATOL,
                                   rtol=RTOL)
        assert o.prompt_logits.shape == (len(p), BERT_VOCAB)
        np.testing.assert_allclose(o.prompt_logits, r.prompt_logits,
                                   atol=ATOL, rtol=RTOL)
    # without prompt logits only the last rows come back
    assert all(o.prompt_logits is None for o in port.serve_tokens(group))


def test_bf16_bert_serve_tokens_matches_flax(bert_weights):
    port = port_engine("bert_base", TINY_BERT, bert_weights, None, "bf16",
                       dtype=torch.bfloat16)
    group = bert_prompts(seed=3)
    got = port.serve_tokens(group, return_prompt_logits=True)
    ids, _, _ = pack.pack_token_rows(group, 8, 8)
    with jax.disable_jit():
        want = np.asarray(flax_model("bert_base", TINY_BERT,
                                     jnp.bfloat16).apply(
            {"params": bert_weights}, ids, train=False))
    fp32 = np.asarray(flax_model("bert_base", TINY_BERT).apply(
        {"params": bert_weights}, ids, train=False))
    for i, (o, p) in enumerate(zip(got, group)):
        np.testing.assert_allclose(o.prompt_logits, want[i, :len(p)],
                                   rtol=0, atol=BF16_ATOL)
        np.testing.assert_allclose(o.last_logits, want[i, len(p) - 1],
                                   rtol=0, atol=BF16_ATOL)
    assert np.abs(want - fp32).max() > 100 * BF16_ATOL


def test_warmup_runs_every_bucket(bert_weights, image_weights):
    bert = port_engine("bert_base", TINY_BERT, bert_weights, None, "fp32")
    assert bert.warmup() == len(KW["buckets"])
    params, stats = image_weights["vit_b16"]
    assert port_engine("vit_b16", TINY_VIT, params, stats,
                       "fp32").warmup() == 0


def test_worker_serves_results_without_tokens(bert_weights):
    """The queue's worker resolves a token model's results, which carry
    no tokens, with their queue wait."""
    import threading

    port = port_engine("bert_base", TINY_BERT, bert_weights, None, "fp32")
    queue = RequestQueue(KW["buckets"])
    stop = threading.Event()
    worker = threading.Thread(target=serve_forever,
                              args=(port, queue, stop), daemon=True)
    worker.start()
    reqs = [queue.submit(p) for p in bert_prompts((5, 12, 3))]
    results = [r.result(timeout=60.0) for r in reqs]
    stop.set()
    worker.join(timeout=60.0)
    assert not worker.is_alive()
    assert [r.bucket for r in results] == [8, 16, 8]
    assert all(r.tokens.size == 0 and r.queue_wait_s >= 0
               for r in results)


# ---------------------------------------------------------------------------
# int8: bitwise JAX's codes and scales
# ---------------------------------------------------------------------------


def served_leaves(tree, prefix=()):
    if isinstance(tree, JaxQuantizedLeaf) or not hasattr(tree, "items"):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from served_leaves(v, prefix + (k,))


# ResNet-18 at full width and the default 4096: every conv kernel (the
# 7x7 stem's 9408 elements too) and the (512, 10) head; the tiny
# transformers at 64, so that their kernels and embeddings quantize
INT8_CASES = [("resnet18", 4096, 21), ("vit_b16", 64, 13),
              ("bert_base", 64, 14)]


@pytest.mark.parametrize("name,min_elements,n_int8", INT8_CASES,
                         ids=[c[0] for c in INT8_CASES])
def test_quantize_params_bitwise_jax(mesh1, image_weights, bert_weights,
                                     name, min_elements, n_int8):
    if name == "bert_base":
        kw, (params, stats) = TINY_BERT, (bert_weights, None)
    else:
        kw, (params, stats) = IMAGE_MODELS[name], image_weights[name]
    ref = jax_engine(mesh1, name, kw, params, stats, "int8", min_elements)
    port = port_engine(name, kw, params, stats, "int8", min_elements)
    want = dict(served_leaves(jax.device_get(ref._served)))
    assert set(map(flax_path_to_name, want)) == set(port._served)
    n = 0
    for path, leaf in want.items():
        mine = port._served[flax_path_to_name(path)]
        if isinstance(leaf, JaxQuantizedLeaf):
            assert isinstance(mine, QuantizedLeaf), path
            np.testing.assert_array_equal(mine.q.numpy(), np.asarray(leaf.q))
            np.testing.assert_array_equal(
                mine.scale.numpy().view(np.uint32),
                np.asarray(leaf.scale).view(np.uint32))
            n += 1
        else:
            assert not isinstance(mine, QuantizedLeaf), path
            np.testing.assert_array_equal(mine.numpy(), np.asarray(leaf))
    assert n == n_int8
    if stats is not None:   # the statistics are served exact
        for path, s in iter_flax_leaves(stats):
            np.testing.assert_array_equal(
                port._batch_stats[flax_path_to_name(path)].numpy(), s)


# ---------------------------------------------------------------------------
# the refusals, with the JAX package's messages
# ---------------------------------------------------------------------------


def raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_cross_mode_calls_raise_jax_messages(mesh1, image_weights,
                                             bert_weights):
    params, stats = image_weights["resnet18"]
    img = (jax_engine(mesh1, "resnet18", {}, params, stats, "fp32"),
           port_engine("resnet18", {}, params, stats, "fp32"))
    tok = (jax_engine(mesh1, "bert_base", TINY_BERT, bert_weights, None,
                      "fp32"),
           port_engine("bert_base", TINY_BERT, bert_weights, None, "fp32"))
    want, got = (raised(lambda e=e: e.serve_tokens(bert_prompts()))
                 for e in img)
    assert got == want
    # the JAX engine runs a token model's image call into flax; the port
    # refuses it by name
    assert "serve_images needs an image model" in raised(
        lambda: tok[1].serve_images(image_batch(), SMOKE_IMAGE_MEAN,
                                    SMOKE_IMAGE_STD))


@pytest.mark.parametrize("name", ["bert_base", "resnet18"])
def test_slot_engine_refuses_what_is_not_a_causal_lm(mesh1, image_weights,
                                                     bert_weights, name):
    if name == "bert_base":
        kw, params, stats = TINY_BERT, bert_weights, None
    else:
        kw, (params, stats) = {}, image_weights[name]
    cfg = dict(buckets=(8,), rows=2, max_new_tokens=4)
    want = raised(lambda: JaxSlotEngine(
        flax_model(name, kw), mesh1, JaxPagedServeConfig(**cfg), params,
        batch_stats=stats))
    model = port_model(name, kw, params, stats)
    got = raised(lambda: SlotEngine(
        model, PagedServeConfig(**cfg), dict(model.named_parameters()),
        device="cpu"))
    assert got == want == "continuous batching decodes causal LMs only"


def test_measure_serving_refuses_an_image_model_as_jax(devices):
    want = raised(lambda: jax_harness.measure_serving(
        "vit_b16", n_requests=2, devices=devices[:1],
        model_overrides=TINY_VIT))
    got = raised(lambda: measure_serving(
        "vit_b16", n_requests=2, device="cpu", model_overrides=TINY_VIT))
    assert got == want and "serves images" in got


def test_bert_bench_row_has_no_token_rate():
    row = measure_serving("bert_base", n_requests=6, offered_rps=200.0,
                          buckets=(8, 16), device="cpu",
                          model_overrides=dict(TINY_BERT))
    assert "tokens_per_sec" not in row
    assert {"p50_ms", "p99_ms", "mean_ms", "achieved_rps", "offered_rps",
            "n_requests", "checkpoint"} <= set(row)
    assert row["mode"] == "serving" and row["model"] == "bert_base"


def test_image_engine_needs_its_statistics(image_weights):
    params, stats = image_weights["resnet18"]
    model = port_model("resnet18", {}, params, stats)
    with pytest.raises(ValueError, match="pass batch_stats"):
        InferenceEngine(model, ServeConfig(**KW),
                        dict(model.named_parameters()), device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("serve_dtype", ["fp32", "int8"])
def test_smoke_cli_serves_images(serve_dtype, capsys, tmp_path):
    report = run(["smoke", "--device", "cpu", "--model", "resnet18",
                  "--serve-dtype", serve_dtype, "--model-overrides",
                  "num_filters=8", "--output-dir", str(tmp_path)])
    out = capsys.readouterr().out
    logits = np.stack(report.results)
    assert logits.shape == (2, 10) and np.isfinite(logits).all()
    assert (f"serving smoke: 2 images -> logits (2, 10), top-1 "
            f"{logits.argmax(-1).tolist()}") in out
    from distributed_pytorch_training_tpu_torch.telemetry.__main__ import (
        read_stream, summarize,
    )

    events, bad = read_stream(str(tmp_path / "telemetry_rank0.jsonl"))
    assert bad == 0 and summarize(events)["spans"]["prefill"]["count"] == 1
    # the images of --seed 0, normalized with CIFAR-10's statistics
    np.testing.assert_array_equal(np.stack(report.prompts), np.random.
                                  RandomState(0).randint(
                                      0, 256, (2, 32, 32, 3)))
    np.testing.assert_array_equal(report.engine.serve_images(
        np.stack(report.prompts), SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD), logits)


def test_smoke_cli_serves_bert(capsys, tmp_path):
    assert main(["smoke", "--device", "cpu", "--model", "bert_base",
                 "--model-overrides", BERT_OVERRIDES, "--output-dir",
                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("serving smoke: prompt[") == 3
    assert out.count("-> [] (prefill") == 3
    assert "serving smoke: ok (3 requests)" in out


@pytest.mark.parametrize("argv", [["serve", "--port", "0"],
                                  ["bench", "--continuous"]],
                         ids=["serve", "bench-continuous"])
def test_continuous_commands_refuse_bert_as_jax(argv, tmp_path):
    with pytest.raises(ValueError, match="continuous batching decodes "
                                         "causal LMs only"):
        main(argv + ["--device", "cpu", "--model", "bert_base",
                     "--model-overrides", BERT_OVERRIDES, "--requests", "2",
                     "--output-dir", str(tmp_path)])


def test_resnet_checkpoint_serves_its_statistics(tmp_path):
    """A ResNet trained through the entry with --checkpoint-dir: serving
    restores the checkpoint's BatchNorm statistics (sgd, the vision
    models' auto optimizer) and serves them."""
    from distributed_pytorch_training_tpu_torch import train

    ckpt = tmp_path / "ckpt"
    state = train.main(["--device", "cpu", "--model", "resnet18",
                        "--model-overrides", "num_filters=4", "--synthetic",
                        "--synthetic-size", "16", "--batch-size", "8",
                        "--epochs", "1", "--no-telemetry", "--output-dir",
                        str(tmp_path), "--checkpoint-dir", str(ckpt)])
    engine = build_serving_engine("resnet18", device="cpu",
                                  ckpt_dir=str(ckpt),
                                  model_overrides=dict(num_filters=4))
    assert engine.checkpoint_info["step"] == state.step == 2
    trained = dict(state.model.named_buffers())
    assert set(engine._batch_stats) == set(trained)
    moved = 0.0
    for name, b in engine._batch_stats.items():
        assert torch.equal(b, trained[name]), name
        init = 1.0 if name.endswith("var") else 0.0
        moved = max(moved, float((b - init).abs().max()))
    assert moved > 0   # the statistics are the trained ones, not the init
