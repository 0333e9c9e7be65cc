"""The port's BERT masked LM against the JAX package's, on converted
weights, and remat on every transformer of the port.

* Forward: the flax init's parameters through ``convert.py``; logits
  within ATOL = RTOL = 1e-5 in float32 (reassociation and LayerNorm's
  variance formula, measured ~2e-6 at logits of ~4), with the einsum
  attention and with the flash attention (its plain version on the CPU,
  ``causal=False``); under bf16 compute BITWISE flax's run op by op
  (``jax.disable_jit``), with the JAX package's own bf16-vs-float32 gap
  asserted beside them.
* Parameters: 109,514,298 at BERT-base's widths, on ``device="meta"``,
  as the flax model counts them; the converted tree round-trips bitwise
  and ``flax_ordered`` is flax's leaf order.
* Remat, for GPT-2, BERT and ViT: the loss and every gradient BITWISE the
  model's without remat (the recompute runs the same ops on the same
  inputs), and each block's attention runs twice a step.
* A 3-step Trainer trajectory against the JAX Trainer on the 8-device
  CPU mesh (global batch 16, 3 rows weighted 0; SGD with momentum): the
  masked weight of every step exactly (the masks are the JAX step key's),
  the losses within LOSS_RTOL = 1e-5, the parameters within PARAM_ATOL =
  1e-5 + PARAM_RTOL = 1e-4, then one evaluation batch's metrics
  (``PRNGKey(0)``'s masks), its loss within 1e-4. (AdamW divides each
  gradient by its own running RMS, so an entry whose gradient sits at
  float32 noise, as some of a post-LN LayerNorm's bias do after two
  steps, moves by up to lr either way; test_torch_training.py holds the
  port's AdamW to optax's on GPT-2.)
* The entry point at a tiny width: bert_base trains, writes the CSV, and
  ``--remat`` writes the same losses; the two vocab guards raise the JAX
  entry's messages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.ops.flash_attention import (
    make_flash_attention_fn as jax_flash_fn,
)
from distributed_pytorch_training_tpu.parallel import shard_batch
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
    make_schedule as jax_make_schedule,
)
from distributed_pytorch_training_tpu.training.tasks import (
    MaskedLMTask as JaxMLMTask,
)
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import (
    flax_ordered,
    iter_flax_leaves,
    load_flax_params,
    name_to_flax_path,
    torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.models.layers import (
    dot_product_attention,
)
from distributed_pytorch_training_tpu_torch.ops.flash_attention import (
    make_flash_attention_fn,
)
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig,
    Trainer,
    make_optimizer,
    make_schedule,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    ImageClassificationTask,
    LanguageModelingTask,
    MaskedLMTask,
)
from distributed_pytorch_training_tpu_torch.utils import MetricsCSV
from _torch_rig import port_process_state  # noqa: F401

ATOL = RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
SEQ = 16
# the JAX suites' tiny BERT (tests/test_training.py): vocab 128, [MASK] 3
TINY = dict(vocab_size=128, hidden_dim=64, depth=2, num_heads=2,
            mlp_dim=128, max_position=SEQ)
MASK_ID = 3
BERT_BASE_PARAMS = 109_514_298


def ids_of(shape, seed=0):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], shape).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params():
    return jax.device_get(jax_get_model("bert_base", **TINY).init(
        jax.random.PRNGKey(0), ids_of((1, SEQ)), train=False)["params"])


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_logits_match_flax(flax_params, attention):
    ids = ids_of((3, SEQ), seed=1)
    ref = np.asarray(jax_get_model("bert_base", **TINY).apply(
        {"params": flax_params}, ids, train=False))
    kw = dict(TINY)
    if attention == "flash":
        kw["attention_fn"] = make_flash_attention_fn(causal=False)
    model = get_model("bert_base", **kw)
    load_flax_params(model, flax_params)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32 and out.shape == (3, SEQ, 128)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_bf16_logits_bitwise_flax(flax_params):
    ids = ids_of((3, SEQ), seed=2)
    with jax.disable_jit():
        ref = np.asarray(jax_get_model(
            "bert_base", dtype=jnp.bfloat16, **TINY).apply(
            {"params": flax_params}, ids, train=False))
    fp32 = np.asarray(jax_get_model("bert_base", **TINY).apply(
        {"params": flax_params}, ids, train=False))
    model = get_model("bert_base", dtype=torch.bfloat16, **TINY)
    load_flax_params(model, flax_params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.abs(ref - fp32).max() > 1e-3 * np.abs(fp32).max()


def jax_param_count(name, **kw):
    inputs = (jnp.zeros((1, 512), jnp.int32) if name == "bert_base"
              else jnp.zeros((1, 224, 224, 3), jnp.float32))
    shapes = jax.eval_shape(lambda: jax_get_model(name, **kw).init(
        jax.random.PRNGKey(0), inputs, train=False))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))


def test_bert_tokens_are_the_jax_packages(tmp_path):
    from distributed_pytorch_training_tpu.data.text import (
        get_token_dataset as jax_get_token_dataset,
    )
    from distributed_pytorch_training_tpu_torch.data.text import (
        get_token_dataset,
    )

    np.save(tmp_path / "bert_train.npy",
            np.random.RandomState(0).randint(0, 30522, 1000))
    for data_dir, size in (("/nonexistent", 8), (str(tmp_path), None)):
        a = get_token_dataset("bert", 64, data_dir, train=True,
                              synthetic_size=size, seed=42)
        b = jax_get_token_dataset("bert", 64, data_dir, train=True,
                                  synthetic_size=size, seed=42)
        assert (a.name, a.vocab_size, a.synthetic) == (
            b.name, b.vocab_size, b.synthetic)
        assert a.vocab_size == 30522
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_bert_base_parameter_count_is_the_jax_models():
    model = get_model("bert_base", device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == BERT_BASE_PARAMS == jax_param_count("bert_base")
    padded = get_model("bert_base", device="meta",
                       pad_vocab_to_multiple_of=128)
    assert padded.padded_vocab == 30592


def test_converted_tree_round_trips_in_flax_order(flax_params):
    model = get_model("bert_base", **TINY)
    load_flax_params(model, flax_params)
    want = list(iter_flax_leaves(flax_params))
    got = list(iter_flax_leaves(torch_to_flax(model)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [name_to_flax_path(n) for n, _ in
            flax_ordered(model.named_parameters())] == [p for p, _ in want]
    assert ("mlm_bias",) in dict(want) and ("token_embedding",
                                            "embedding") in dict(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_hot_lookup_is_the_lookup(dtype):
    """The type table's one-hot product: the lookup's values bitwise, and
    in float32 its gradient the lookup's within reassociation (rtol 1e-6;
    in bf16 the two sum in other precisions, and neither in flax's)."""
    from distributed_pytorch_training_tpu_torch.models.layers import Embed

    table = Embed(2, 64, dtype=dtype)
    table.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(ids_of((4, SEQ)) % 2).long()
    up = torch.randn((4, SEQ, 64), generator=torch.Generator().manual_seed(1))
    got = table.one_hot_lookup(ids)
    assert got.dtype == dtype and torch.equal(got, table(ids))
    if dtype == torch.float32:
        (g_hot,) = torch.autograd.grad(got, table.embedding, up)
        (g_ref,) = torch.autograd.grad(table(ids), table.embedding, up)
        np.testing.assert_allclose(g_hot.numpy(), g_ref.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_padded_vocab_masks_its_columns(flax_params):
    model = get_model("bert_base", pad_vocab_to_multiple_of=48, **TINY)
    assert model.padded_vocab == 144 and model.mlm_bias.shape == (128,)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(torch.from_numpy(ids_of((2, SEQ))).long())
    assert out.shape == (2, SEQ, 144)
    assert (out[..., 128:] == torch.finfo(torch.float32).min).all()
    assert (out[..., :128].argmax(-1) == out.argmax(-1)).all()


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def counting(calls):
    def attention_fn(q, k, v, mask=None, dtype=torch.float32):
        calls.append(1)
        return dot_product_attention(q, k, v, mask=mask, dtype=dtype)
    return attention_fn


def remat_case(name, remat, calls):
    """(model, loss of one step) at a tiny width, weights from seed 0."""
    g = torch.Generator().manual_seed(0)
    if name == "vit_b16":
        model = get_model(name, num_classes=10, patch_size=8, hidden_dim=32,
                          depth=2, num_heads=2, mlp_dim=64, image_size=32,
                          attention_fn=counting(calls), remat=remat)
        batch = {"image": torch.randint(0, 256, (4, 32, 32, 3),
                                        generator=g, dtype=torch.uint8),
                 "label": torch.arange(4), "weight": torch.ones(4)}
        task = ImageClassificationTask(mean=(0.5,) * 3, std=(0.25,) * 3,
                                       augment=False)
    else:
        kw = dict(TINY) if name == "bert_base" else dict(
            vocab_size=128, hidden_dim=32, depth=2, num_heads=2,
            max_position=SEQ)
        model = get_model(name, attention_fn=counting(calls), remat=remat,
                          **kw)
        batch = {"input_ids": torch.from_numpy(ids_of((4, SEQ), seed=3)),
                 "weight": torch.ones(4)}
        task = (MaskedLMTask(vocab_size=128, mask_token_id=MASK_ID)
                if name == "bert_base" else LanguageModelingTask())
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = Trainer(task, TrainConfig(seed=0), device="cpu")
    key = trainer._step_keys(0, 4, replica=False)[0]
    loss, _, _ = task.loss_and_metrics(model, batch, True, None, key)
    loss.backward()
    return model, loss


@pytest.mark.parametrize("name", ["gpt2_124m", "bert_base", "vit_b16"])
def test_remat_bitwise_no_remat(name):
    plain_calls, remat_calls = [], []
    plain, loss = remat_case(name, False, plain_calls)
    rematted, loss_r = remat_case(name, True, remat_calls)
    assert rematted.remat and not plain.remat
    assert torch.equal(loss, loss_r)
    for (n, p), (_, q) in zip(plain.named_parameters(),
                              rematted.named_parameters()):
        assert torch.equal(p.grad, q.grad), n
    # the recompute: every block's attention again in the backward
    assert len(plain_calls) == 2 and len(remat_calls) == 4
    with torch.no_grad():       # no gradients: no recompute
        remat_calls.clear()
        rematted(torch.zeros((1, 32, 32, 3)) if name == "vit_b16"
                 else torch.zeros((1, SEQ), dtype=torch.long))
    assert len(remat_calls) == 2


# ---------------------------------------------------------------------------
# the trajectory against the JAX Trainer
# ---------------------------------------------------------------------------


def _batches(n_steps, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        w = np.ones(batch, np.float32)
        w[-3:] = 0.0
        out.append({"input_ids": rng.randint(0, TINY["vocab_size"],
                                              (batch, SEQ)).astype(np.int32),
                    "weight": w})
    return out


@pytest.mark.parametrize("attention,accum", [("xla", 1), ("flash", 2)],
                         ids=["xla-sgd", "flash-sgd-accum2"])
def test_trainer_trajectory_matches_jax(mesh8, attention, accum):
    steps, lr = 3, 0.05
    jax_kw, kw = dict(TINY), dict(TINY)
    if attention == "flash":
        jax_kw["attention_fn"] = jax_flash_fn(causal=False)
        kw["attention_fn"] = make_flash_attention_fn(causal=False)
    jt = JaxTrainer(JaxMLMTask(vocab_size=128, mask_token_id=MASK_ID),
                    mesh8, JaxTrainConfig(seed=0, print_freq=1000,
                                          grad_accum=accum))
    jstate = jt.init_state(jax_get_model("bert_base", **jax_kw),
                           np.zeros((1, SEQ), np.int32),
                           jax_make_optimizer("sgd", jax_make_schedule(
                               "constant", lr)), jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate.params)
    model = get_model("bert_base", **kw)
    load_flax_params(model, params0)
    trainer = Trainer(MaskedLMTask(vocab_size=128, mask_token_id=MASK_ID),
                      TrainConfig(seed=0, print_freq=1000, grad_accum=accum),
                      device="cpu")
    state = trainer.init_state(model, make_optimizer(
        "sgd", make_schedule("constant", lr)))
    # the port's epoch 0 key, as train_epoch hands the JAX step
    epoch_key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    for batch in _batches(steps):
        jstate, jm = jt._train_step(jstate, shard_batch(batch, mesh8),
                                    epoch_key)
        m = trainer.train_step(state, {k: torch.from_numpy(x)
                                       for k, x in batch.items()})
        assert float(m["weight"]) == float(jm["weight"]) > 0
        assert float(m["correct"]) == float(jm["correct"])
        np.testing.assert_allclose(float(m["loss_sum"]),
                                   float(jm["loss_sum"]), rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == steps
    ours = dict(iter_flax_leaves(torch_to_flax(state.model)))
    ref = dict(iter_flax_leaves(jax.device_get(jstate.params)))
    moved = 0.0
    for path, want in ref.items():
        got, want = ours[path], np.asarray(want)
        start = np.asarray(dict(iter_flax_leaves(params0))[path])
        moved = max(moved, float(np.abs(want - start).max()))
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=str(path))
    assert moved > 10 * PARAM_ATOL
    # evaluation: PRNGKey(0)'s masks over the global batch
    batch = _batches(1, seed=9)[0]
    jm = jt._eval_step(jstate, shard_batch(batch, mesh8))
    m = trainer.eval_step(state, {k: torch.from_numpy(x)
                                  for k, x in batch.items()})
    assert float(m["weight"]) == float(jm["weight"]) > 0
    np.testing.assert_allclose(float(m["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

# the synthetic corpus carries BERT's ids: the model keeps vocab 30522
TINY_CLI = ["--device", "cpu", "--model", "bert_base", "--model-overrides",
            "hidden_dim=32,depth=2,num_heads=2,mlp_dim=64,max_position=32",
            "--seq-len", "32", "--synthetic", "--synthetic-size", "32",
            "--epochs", "2", "--optimizer", "adamw", "--lr", "1e-3",
            "--batch-size", "4", "--print-freq", "4", "--no-telemetry"]


def csv_losses(path):
    return [ln.split(",")[1:5] for ln in
            (path / "metrics_rank0.csv").read_text().splitlines()[1:]]


def test_entry_point_trains_bert_and_remat_keeps_its_losses(tmp_path,
                                                            capsys):
    train.main(TINY_CLI + ["--output-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "NOTE: using synthetic data (bert-synthetic, n=32)" in out
    assert "Epoch [1] Step [8/8] Loss: " in out
    lines = (tmp_path / "a" / "metrics_rank0.csv").read_text().splitlines()
    assert lines[0] == MetricsCSV.HEADER.strip()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "2"]
    losses = csv_losses(tmp_path / "a")
    assert all(np.isfinite(float(x)) for row in losses for x in row)
    assert float(losses[1][0]) < float(losses[0][0])
    train.main(TINY_CLI + ["--remat", "--output-dir", str(tmp_path / "b")])
    assert csv_losses(tmp_path / "b") == losses


def guard_messages(argv, tmp_path):
    """The ValueError of the port's entry and of the JAX entry (8 CPU
    devices) on the same flags."""
    import importlib

    with pytest.raises(ValueError) as ours:
        train.main(["--device", "cpu"] + argv
                   + ["--output-dir", str(tmp_path / "port")])
    jax_train = importlib.import_module("train")
    with pytest.raises(ValueError) as theirs:
        jax_train.main(argv + ["--output-dir", str(tmp_path / "jax")])
    return str(ours.value), str(theirs.value)


def test_vocab_guards_raise_the_jax_messages(tmp_path):
    flags = [f for f in TINY_CLI if f != "--device" and f != "cpu"]
    over = flags.index("--model-overrides") + 1
    # ids past the model's vocab
    shrunk = list(flags)
    shrunk[over] += ",vocab_size=1000"
    ours, theirs = guard_messages(shrunk, tmp_path)
    assert ours == theirs and "exceeds the model's vocab_size (1000)" in ours
    # a corpus inside a vocab without the [MASK] id
    data = tmp_path / "data"
    data.mkdir()
    for split in ("train", "val"):
        np.save(data / f"bert_{split}.npy",
                np.random.RandomState(0).randint(0, 100, 2048))
    small = [f for f in shrunk if f != "--synthetic"]
    small[over] = small[over].replace("vocab_size=1000", "vocab_size=100")
    ours, theirs = guard_messages(small + ["--data-dir", str(data)],
                                  tmp_path)
    assert ours == theirs
    assert "does not contain the [MASK] token id 103" in ours
