"""Tensor parallelism over the mesh's ``model`` axis (GPT-2), the port
against the JAX package on the CPU: megatron column/row-split blocks, the
vocab-parallel embedding and cross-entropy, and TP x FSDP.

* The region operators (``copy_to_tp``, ``reduce_from_tp``) and
  ``tp_parallel_cross_entropy``, forward and
  gradients, on 2 and 4 gloo model ranks against the JAX custom_vjp forms
  under ``shard_map`` on as many CPU devices, and the cross-entropy
  against the CE of the gathered logits.
* The layout helpers (``tp_split_dims``, ``tp_local_struct``,
  ``tp_unflatten_leaf`` of JAX's ``tp_flat_leaf``, the clip's weights
  (``mesh_clip_weights`` over ``model``, JAX's ``tp_clip_weights``),
  ``tp_psum_bytes_per_step``, the rules table, the wire accounting's TP
  row) bitwise against the JAX package's on GPT-2's template, the
  indivisible vocab included; ``convert.py``'s weight carrier's round
  trip bitwise.
* A tiny GPT-2's logits and gradients on 2 and 4 model ranks against the
  JAX model, and the model-axis all-reduces of one step (4 a block, 2
  for the vocab-parallel embedding, 2 for the cross-entropy's stats).
* The Trainer, AdamW with the global-norm clip on, 3 steps on
  ``data=2,model=2``: the implicit step against the JAX Trainer's GSPMD
  step, explicit TP x FSDP fp32 against the JAX explicit step; the
  replicated leaves bitwise equal on every rank, the split leaves bitwise
  equal across the data axis. The ``int8`` and ``int8_multihop`` wires,
  WIRE_STEPS steps on one batch as the JAX package's own test of its
  int8_multihop wire (``tests/test_tp.py``): the loss falls, the losses
  stay within that test's bound of the fp32 run's (rtol 2e-2), and the
  parameters' movement from the start stays within WIRE_PARAM_REL of the
  fp32 run's, leaf by leaf.
* ``train.main`` on 4 gloo ranks, ``--mesh data=2,model=2``, implicit and
  ``--fsdp-explicit``, against the JAX Trainer from the same initial
  weights over the same global batches (the entry's AdamW has no clip,
  in both packages); a run stopped after one epoch and ``--resume``d at
  the same mesh ends bitwise the uninterrupted run; its checkpoint holds
  the global model in the JAX package's layout (the model-major flat
  vectors of ``tp_flat_leaf`` under ``--fsdp-explicit``), and serving's
  restore writes it into the global model bitwise.
* The refusals, with the JAX package's messages where it refuses.

The ranks are ``tests/_torch_dp_worker.py`` processes: one module-scoped
run of 4 serves every leg.

Tolerances (float32 reassociation: the split products, the all-reduces'
order): the region operators exact (rtol 0) except the sums, within
SUM_RTOL = 1e-6; the cross-entropy and its gradient within CE_TOL = 1e-5
(JAX's own test of it); logits within LOGIT_TOL = 1e-5; gradients within
GRAD_REL = 1e-5 of each leaf's largest; trajectories' losses within
LOSS_RTOL = 2e-5 and parameters within PARAM_RTOL = 2e-2, PARAM_ATOL =
2e-3 under AdamW (JAX's bound for its own TP x FSDP against the
replicated run: Adam's normalized step turns a gradient's last-bit
difference near zero into a visible one); ``int8_multihop`` losses
within MH_RTOL = 2e-2 of the fp32 run, and each leaf's distance from the
fp32 run's within WIRE_PARAM_REL = 0.4 of that run's movement from the
start (measured on the CPU: at most 0.21 on the int8 wire, 0.25 on
int8_multihop; a wire that updated nothing is off by 1).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models.gpt2 import (
    GPT2LMHead as JaxGPT2,
)
from distributed_pytorch_training_tpu.parallel import (
    MeshSpec as JaxMeshSpec, build_mesh as jax_build_mesh, shard_batch,
)
from distributed_pytorch_training_tpu.parallel import (
    collectives as jax_coll, grad_sync as jax_grad_sync,
    sharding as jax_sharding,
)
from distributed_pytorch_training_tpu.parallel.mesh import (
    BATCH_AXES, MODEL, validate_mesh_usage as jax_validate_mesh_usage,
)
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig, Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
)
from distributed_pytorch_training_tpu.training.optim import adamw as jax_adamw
from distributed_pytorch_training_tpu.training.tasks import (
    LanguageModelingTask as JaxLMTask,
)
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import (
    flax_to_torch, load_tp_params, tp_global_params, tp_local_params,
    torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.data.text import (
    TokenLoader, get_token_dataset, synthetic_token_dataset,
)
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.models.gpt2 import GPT2LMHead
from distributed_pytorch_training_tpu_torch.models.layers import (
    tp_fsdp_rules,
)
from distributed_pytorch_training_tpu_torch.parallel import grad_sync
from distributed_pytorch_training_tpu_torch.parallel.collectives import (
    TpAxis,
)
from distributed_pytorch_training_tpu_torch.parallel.mesh import (
    Mesh, MeshSpec, validate_mesh_usage,
)
from distributed_pytorch_training_tpu_torch.parallel.sharding import (
    flax_path, mesh_clip_weights, tp_join, tp_local_struct, tp_slice,
    tp_split_dims, tp_unflatten_leaf,
)
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig, Trainer, make_optimizer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    LanguageModelingTask,
)

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401 (autouse)

SUM_RTOL = 1e-6
CE_TOL = 1e-5
LOGIT_TOL = 1e-5
GRAD_REL = 1e-5
LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-2, 2e-3
MH_RTOL = 2e-2
WIRE_PARAM_REL = 0.4

SEQ, VOCAB = 16, 64
TINY = dict(vocab_size=VOCAB, hidden_dim=32, depth=2, num_heads=4,
            max_position=SEQ)
# the entry's runs: GPT-2's vocab (the synthetic corpus carries its ids),
# padded to lcm(128, 2) by the entry
ENTRY_SEQ, ENTRY_SYNTHETIC, SEED, LR = 32, 16, 0, 1e-3
ENTRY_KW = dict(vocab_size=50257, hidden_dim=32, depth=2, num_heads=2,
                max_position=ENTRY_SEQ)
OVERRIDES = ",".join(f"{k}={v}" for k, v in ENTRY_KW.items())
MESH_A = dict(data=2, model=2)
MESH_M4 = dict(data=1, model=4)
TP_AXES = (MODEL,) + BATCH_AXES


# ---------------------------------------------------------------------------
# the rank pool
# ---------------------------------------------------------------------------


def ops_spec(mesh, m):
    rng = np.random.RandomState(m)
    return dict(mesh=mesh,
                a=rng.randn(m, 3, 5).astype(np.float32),
                g=rng.randn(m, 3, 5).astype(np.float32),
                logits=(rng.randn(4, 7, VOCAB) * 4.0).astype(np.float32),
                targets=rng.randint(0, VOCAB, (4, 7)).astype(np.int64))


def jax_tiny_params(kw=TINY):
    model = JaxGPT2(**kw)
    return jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, kw["max_position"]),
                                         jnp.int32))["params"])


def tiny_ids(kw=TINY, rows=3):
    return np.random.RandomState(1).randint(
        0, kw["vocab_size"], (rows, kw["max_position"])).astype(np.int64)


def tiny_batches(steps=3, rows=8):
    rng = np.random.RandomState(0)
    return [{"input_ids": rng.randint(0, VOCAB, (rows, SEQ)).astype(
                np.int32),
             "weight": np.ones(rows, np.float32)} for _ in range(steps)]


def clip_tx():
    return ("adamw", dict(grad_clip_norm=1.0, weight_decay=0.01))


TRAIN_RUNS = {"a": dict(), "b": dict(fsdp_explicit=True)}
# the TP x FSDP wires: WIRE_STEPS steps on one batch (the JAX package's
# test of its int8_multihop wire takes 8 on one batch)
WIRES = ("fp32", "int8", "int8_multihop")
WIRE_STEPS = 8


def cli(tmp, data_dir, mesh, epochs, *extra):
    return ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
            OVERRIDES, "--seq-len", str(ENTRY_SEQ), "--synthetic",
            "--synthetic-size", str(ENTRY_SYNTHETIC), "--data-dir",
            str(data_dir), "--epochs", str(epochs), "--batch-size", "2",
            "--optimizer", "adamw", "--lr", str(LR), "--print-freq",
            "1000", "--no-telemetry", "--seed", str(SEED), "--mesh", mesh,
            "--output-dir", str(tmp), *extra]


# (name, flags, epochs, checkpoint dir key, resume)
CLI_RUNS = [("a", [], 2, None, False),
            ("a part", [], 1, "a ckpt", False),
            ("a resumed", [], 2, "a ckpt", True),
            ("b", ["--fsdp-explicit"], 2, None, False),
            ("b part", ["--fsdp-explicit"], 1, "b ckpt", False),
            ("b resumed", ["--fsdp-explicit"], 2, "b ckpt", True)]


# BERT-base and ViT-B/16 on the model axis: tiny models (BERT's vocab
# padded to 128 as the entry pads it at model=2, so its padding columns
# 200..255 sit on the second shard), one loss and backward of each
SPLIT_MODELS = {
    "bert": ("bert_base", dict(vocab_size=200, hidden_dim=32, depth=2,
                               num_heads=4, mlp_dim=64, max_position=SEQ,
                               pad_vocab_to_multiple_of=128)),
    "vit": ("vit_b16", dict(hidden_dim=32, depth=2, num_heads=4,
                            mlp_dim=64, num_classes=10)),
}
IMAGE_MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
# train.main at data=2,model=2 (4 ranks; 16 sequences or images, global
# batch 4: 4 steps), each with a checkpoint: BERT, and ViT (SGD, no
# augmentation: its draws are per batch coordinate); BERT keeps its
# 30522 ids (the synthetic corpus's), padded to 30592. Neither takes
# --fsdp-explicit on a model mesh: the JAX Trainer refuses it
SPLIT_OVERRIDES = {
    "bert": "hidden_dim=32,depth=2,num_heads=2,mlp_dim=64,max_position=32",
    "vit": "hidden_dim=32,depth=2,num_heads=2,mlp_dim=64,patch_size=56"}
SPLIT_CLI_RUNS = {
    "bert": ("bert", []),
    "vit": ("vit", []),
}
SPLIT_CKPT = ("bert", "vit")


def split_cli(name, tmp, data_dir, mesh_free=False):
    """The entry's command line of SPLIT_CLI_RUNS[name] (without its
    --mesh); ``mesh_free`` drops the checkpoint too (the model=1
    yardstick)."""
    family, extra = SPLIT_CLI_RUNS[name]
    tag = name.replace(" ", "_")
    argv = ["--device", "cpu", "--model-overrides", SPLIT_OVERRIDES[family],
            "--synthetic", "--synthetic-size", "16", "--data-dir",
            str(data_dir), "--epochs", "1", "--batch-size", "2",
            "--print-freq", "1000", "--no-telemetry", "--seed", str(SEED),
            "--output-dir", str(tmp / f"split_{tag}"), *extra]
    if family == "bert":
        argv += ["--model", "bert_base", "--seq-len", "32", "--optimizer",
                 "adamw", "--lr", str(LR)]
    else:
        argv += ["--model", "vit_b16", "--dataset", "imagenet",
                 "--no-augment", "--optimizer", "sgd", "--lr", "0.05"]
    if name in SPLIT_CKPT and not mesh_free:
        argv += ["--checkpoint-dir", str(tmp / f"split_{tag}_ckpt")]
    return argv


def jax_split_params(model, kw):
    from distributed_pytorch_training_tpu.models import (
        get_model as jax_get_model,
    )

    sample = (jnp.zeros((1, 32, 32, 3)) if model == "vit_b16"
              else jnp.zeros((2, SEQ), jnp.int32))
    return jax.device_get(jax_get_model(model, **kw).init(
        jax.random.PRNGKey(0), sample, train=False)["params"])


def split_inputs(model):
    """The tp_model job's batch: 3 rows of BERT ids and its step key, or
    3 uint8 32x32 images and their labels."""
    rng = np.random.RandomState(2)
    if model == "vit_b16":
        return dict(images=rng.randint(0, 256, (3, 32, 32, 3)).astype(
                        np.uint8),
                    labels=rng.randint(0, 10, 3).astype(np.int64),
                    stats=IMAGE_MEAN_STD)
    return dict(ids=rng.randint(0, 200, (3, SEQ)).astype(np.int64),
                key=np.asarray(jax.random.PRNGKey(5), np.uint32))


# the BERT Trainer test's AdamW rate: the attention's key bias has a zero
# gradient up to float32 rounding (softmax is invariant to a per-query
# shift), which Adam's normalized step turns into steps of up to lr a
# side; at 1e-2 five of its 96 elements ended 3.7e-3 from JAX's, past
# PARAM_ATOL, at 3e-3 that noise stays inside it
BERT_CLIP_LR = 3e-3


def bert_batches(steps=3, rows=8):
    rng = np.random.RandomState(3)
    return [{"input_ids": rng.randint(0, 200, (rows, SEQ)).astype(np.int32),
             "weight": np.ones(rows, np.float32)} for _ in range(steps)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_data")


@pytest.fixture(scope="module")
def pool(tmp_path_factory, data_dir):
    tmp = tmp_path_factory.mktemp("tp4")
    params = jax_tiny_params()
    indiv_kw = dict(TINY, vocab_size=50257)
    indiv = jax_tiny_params(indiv_kw)
    jobs = {
        "ops 2": ("tp_ops", ops_spec(MESH_A, 2)),
        "ops 4": ("tp_ops", ops_spec(MESH_M4, 4)),
        "model 2": ("tp_model", dict(mesh=MESH_A, params=params,
                                     model_kwargs=TINY, ids=tiny_ids())),
        "model 4": ("tp_model", dict(mesh=MESH_M4, params=params,
                                     model_kwargs=TINY, ids=tiny_ids())),
        "model 2 indivisible": ("tp_model", dict(
            mesh=MESH_A, params=indiv, model_kwargs=indiv_kw,
            ids=tiny_ids(indiv_kw))),
    }
    for name, config in TRAIN_RUNS.items():
        jobs[f"train {name}"] = ("tp_train", dict(
            mesh=MESH_A, params=params, model_kwargs=TINY,
            batches=tiny_batches(), config=config, optimizer=clip_tx(),
            lr=1e-2))
    for wire in WIRES:
        jobs[f"wire {wire}"] = ("tp_train", dict(
            mesh=MESH_A, params=params, model_kwargs=TINY,
            batches=tiny_batches(steps=1) * WIRE_STEPS,
            config=dict(fsdp_explicit=True, wire_dtype=wire),
            optimizer=clip_tx(), lr=1e-2))
    bert, bert_kw = SPLIT_MODELS["bert"]
    jobs["train bert"] = ("tp_train", dict(
        mesh=MESH_A, model=bert, params=jax_split_params(bert, bert_kw),
        model_kwargs=bert_kw, mlm=dict(vocab_size=bert_kw["vocab_size"]),
        batches=bert_batches(), config={}, optimizer=clip_tx(),
        lr=BERT_CLIP_LR))
    split_params = {}
    for name, (model, kw) in SPLIT_MODELS.items():
        split_params[name] = jax_split_params(model, kw)
        jobs[f"{name} 2"] = ("tp_model", dict(
            mesh=MESH_A, model=model, params=split_params[name],
            model_kwargs=dict(kw, **({"image_size": 32}
                                     if model == "vit_b16" else {})),
            **split_inputs(model)))
    runs = []
    for name, flags, epochs, ckpt, resume in CLI_RUNS:
        extra = list(flags)
        if ckpt:
            extra += ["--checkpoint-dir", str(tmp / ckpt.replace(" ", "_"))]
        if resume:
            extra.append("--resume")
        runs.append(cli(tmp / name.replace(" ", "_"), data_dir,
                        "data=2,model=2", epochs, *extra))
    for name, argv in SPLIT_CLI_RUNS.items():
        runs.append(split_cli(name, tmp, data_dir) + ["--mesh",
                                                      "data=2,model=2"])
    jobs["clis"] = ("clis", dict(runs=[[argv] * 4 for argv in runs]))
    res = run_ranks(tmp, 4, jobs, timeout=600)
    return {"ranks": res, "dir": tmp, "params": params, "indiv": indiv,
            "split_params": split_params}


def by_model_index(ranks, job, batch_index=0):
    """The job's results of the ranks at ``batch_index`` (data=2 meshes)
    or of every rank (data=1), in model-index order."""
    out = [r[job] for r in ranks
           if r[job].get("batch_index", 0) == batch_index]
    return sorted(out, key=lambda o: o["index"])


# ---------------------------------------------------------------------------
# region operators and the parallel-vocab cross-entropy
# ---------------------------------------------------------------------------


def jax_shards(devices, m, fn, *stacked):
    """``fn`` on each of ``m`` model shards under the JAX package's
    shard_map (axis "model"); inputs and outputs stacked on dim 0."""
    mesh = jax.sharding.Mesh(np.array(devices[:m]), ("model",))
    spec = jax.sharding.PartitionSpec("model")

    def body(*xs):
        outs = fn(*(x[0] for x in xs))
        return tuple(o[None] for o in outs)

    f = jax_coll.shard_map(body, mesh, in_specs=(spec,) * len(stacked),
                           out_specs=spec)
    return [np.asarray(o) for o in jax.jit(f)(*stacked)]


def jax_region(devices, m, spec, name):
    """(outputs, input gradients) of JAX's operator ``name`` per shard."""
    op = {"copy": lambda a: jax_coll.copy_to_tp(a, "model"),
          "reduce": lambda a: jax_coll.reduce_from_tp(a, "model")}[name]

    def one(a, ct):
        y, vjp = jax.vjp(op, a)
        return y, vjp(ct)[0]

    return jax_shards(devices, m, one, spec["a"], spec["g"])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", ["copy", "reduce"])
def test_region_operators_match_jax(devices, pool, m, name):
    spec = ops_spec(MESH_A if m == 2 else MESH_M4, m)
    ours = by_model_index(pool["ranks"], f"ops {m}")
    y_ref, g_ref = jax_region(devices, m, spec, name)
    for i, shard in enumerate(ours):
        y, g = shard[name]
        rtol = SUM_RTOL if name == "reduce" else 0
        np.testing.assert_allclose(y, y_ref[i], rtol=rtol, atol=0)
        np.testing.assert_allclose(g, g_ref[i],
                                   rtol=SUM_RTOL if name == "copy" else 0,
                                   atol=0)
    # every shard holds the same sum, bit for bit
    if name == "reduce":
        for shard in ours[1:]:
            np.testing.assert_array_equal(shard[name][0], ours[0][name][0])


@pytest.mark.parametrize("m", [2, 4])
def test_bf16_reduce_sums_in_float32_once(pool, m):
    """A 16-bit row-parallel partial is summed in float32 and rounded
    once (gloo on CUDA tensors takes no 16-bit sum): on 2 ranks that is a
    bf16 add, bit for bit."""
    spec = ops_spec(MESH_A if m == 2 else MESH_M4, m)
    parts = torch.from_numpy(spec["a"]).to(torch.bfloat16)
    want = parts.float().sum(0).to(torch.bfloat16)
    if m == 2:
        assert torch.equal(want, parts[0] + parts[1])
    for shard in by_model_index(pool["ranks"], f"ops {m}"):
        np.testing.assert_array_equal(shard["reduce bf16"],
                                      want.float().numpy())


@pytest.mark.parametrize("m", [2, 4])
def test_parallel_cross_entropy_matches_jax_and_gathered(devices, pool, m):
    spec = ops_spec(MESH_A if m == 2 else MESH_M4, m)
    full, tgt = spec["logits"], spec["targets"]
    rows = VOCAB // m
    stacked = np.stack([full[..., i * rows:(i + 1) * rows]
                        for i in range(m)])

    def one(local, t):
        def ce(x):
            return jax_coll.tp_parallel_cross_entropy(
                jax_coll.TpShardedLogits(x, "model", rows, VOCAB), t)

        c, vjp, correct = jax.vjp(ce, local, has_aux=True)
        return c, correct, vjp(jnp.ones_like(c))[0]

    t_stack = np.stack([tgt.astype(np.int32)] * m)
    ce_ref, correct_ref, g_ref = jax_shards(devices, m, one, stacked,
                                            t_stack)
    # CE over the gathered logits
    logits = torch.from_numpy(full).requires_grad_()
    whole = torch.nn.functional.cross_entropy(
        logits.reshape(-1, VOCAB), torch.from_numpy(tgt).reshape(-1),
        reduction="none").reshape(tgt.shape)
    (g_whole,) = torch.autograd.grad(whole.sum(), logits)
    ours = by_model_index(pool["ranks"], f"ops {m}")
    for i, shard in enumerate(ours):
        ce, correct, g = shard["ce"]
        np.testing.assert_array_equal(ce, ours[0]["ce"][0])
        np.testing.assert_allclose(ce, ce_ref[i], rtol=CE_TOL, atol=CE_TOL)
        np.testing.assert_allclose(ce, whole.detach().numpy(), rtol=CE_TOL,
                                   atol=CE_TOL)
        np.testing.assert_array_equal(correct, correct_ref[i])
        np.testing.assert_array_equal(correct, full.argmax(-1) == tgt)
        np.testing.assert_allclose(g, g_ref[i], rtol=CE_TOL, atol=1e-6)
        np.testing.assert_allclose(
            g, g_whole.numpy()[..., i * rows:(i + 1) * rows], rtol=CE_TOL,
            atol=1e-6)


# ---------------------------------------------------------------------------
# layout helpers, bitwise the JAX package's
# ---------------------------------------------------------------------------


def jax_template(kw):
    return jax.eval_shape(lambda: JaxGPT2(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((2, kw["max_position"]),
                                         jnp.int32), train=False))["params"]


def port_template(kw):
    model = get_model("gpt2_124m", device="meta", **kw)
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def jax_by_path(tree, is_leaf=None):
    return {jax_sharding._path_str(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


SPLIT_CASES = [("tiny", TINY, 2), ("tiny", TINY, 4),
               ("indivisible vocab", dict(TINY, vocab_size=50257), 2),
               ("gpt2_124m", dict(vocab_size=50304, hidden_dim=768,
                                  depth=12, num_heads=12,
                                  max_position=1024), 2)]


@pytest.mark.parametrize("name,kw,m", SPLIT_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in SPLIT_CASES])
def test_split_dims_and_local_struct_bitwise_jax(name, kw, m):
    jt = jax_template(kw)
    jsd = jax_sharding.tp_split_dims(jt, JaxGPT2.partition_rules(), m)
    want = jax_by_path(jsd, is_leaf=lambda x: x is None)
    jlocal = jax_by_path(jax_sharding.tp_local_struct(jt, jsd, m))
    tmpl = port_template(kw)
    sd = tp_split_dims(tmpl, GPT2LMHead.partition_rules(), m)
    local = tp_local_struct(tmpl, sd, m)
    assert {flax_path(n): d for n, d in sd.items()} == want
    assert {flax_path(n): s for n, s in local.items()} == {
        p: tuple(s.shape) for p, s in jlocal.items()}
    if name == "indivisible vocab":
        assert sd["wte.embedding"] is None
        assert not get_model("gpt2_124m", device="meta",
                             tp=TpAxis(m), **kw).tp_vocab


def clip_weights(tmpl, split_dims, m):
    """{flax path: the clip's weight} of a model split over ``model``
    alone, as the Trainer weighs it."""
    names = [n for n, _ in tmpl]
    return dict(zip(map(flax_path, names), mesh_clip_weights(
        [[split_dims[n] for n in names]], [m])))


@pytest.mark.parametrize("m", [2, 4])
def test_clip_weights_bitwise_jax(m):
    jt = jax_template(TINY)
    want = jax_sharding.tp_clip_weights(
        jt, jax_sharding.tp_split_dims(jt, JaxGPT2.partition_rules(), m), m)
    tmpl = port_template(TINY)
    got = clip_weights(tmpl, tp_split_dims(
        tmpl, GPT2LMHead.partition_rules(), m), m)
    assert got == want
    assert got["wpe/embedding"] == 1.0 / m and got["wte/embedding"] == 1.0


@pytest.mark.parametrize("dim,m,n", [(0, 3, 2), (1, 2, 3), (None, 2, 2),
                                     (2, 2, 4)])
def test_flat_leaf_and_unflatten_bitwise_jax(dim, m, n):
    """The port reads JAX's model-major flat layout (its checkpoints'):
    ``tp_unflatten_leaf`` of ``tp_flat_leaf``'s vector is the leaf, as
    JAX's own inverse gives it; ``tp_join`` inverts ``tp_slice``."""
    x = np.random.RandomState(0).randn(12, 6, 4).astype(np.float32)
    want = np.array(jax_sharding.tp_flat_leaf(jnp.asarray(x), dim, m, n))
    back = tp_unflatten_leaf(torch.from_numpy(want), x.shape, dim, m)
    np.testing.assert_array_equal(back.numpy(), x)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tp_join(
        [tp_slice(t, dim, m, i) for i in range(m)], dim).numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_sharding.tp_unflatten_leaf(jnp.asarray(want), x.shape,
                                       np.float32, dim, m)))


@pytest.mark.parametrize("args", [(32, 2, 4, 16, 2, True, 64),
                                  (32, 2, 4, 16, 2, False, 0),
                                  (768, 12, 8, 1024, 2, True, 50304),
                                  (1024, 24, 4, 1024, 4, True, 50304),
                                  (32, 2, 4, 16, 1, True, 64)])
def test_psum_bytes_per_step_bitwise_jax(args):
    # the last argument, the padded vocab, is one the JAX function
    # ignores; the port's has no such parameter
    assert grad_sync.tp_psum_bytes_per_step(*args[:-1]) == \
        jax_grad_sync.tp_psum_bytes_per_step(*args)


def test_rules_table_matches_jax():
    rules, jrules = tp_fsdp_rules(), JaxGPT2.partition_rules()
    assert rules.axes_used() == jrules.axes_used()
    for path, leaf in jax_by_path(jax_template(TINY)).items():
        assert rules.spec_for(path, leaf.ndim) == tuple(
            jrules.spec_for(path, leaf.ndim)), path


def test_wire_accounting_tp_row_matches_jax(tmp_path):
    from distributed_pytorch_training_tpu import telemetry as jax_tele
    from distributed_pytorch_training_tpu_torch import telemetry

    tmpl = port_template(TINY)
    local = tp_local_struct(tmpl, tp_split_dims(
        tmpl, GPT2LMHead.partition_rules(), 2), 2)
    leaves = [np.zeros(s, np.float32) for s in local.values()]
    cfg = dict(fsdp_explicit=True, wire_dtype="int8_multihop",
               model_shards=2, tp_psum_bytes=grad_sync.tp_psum_bytes_per_step(
                   32, 2, 4, SEQ, 2, True))
    jax_tele.configure(str(tmp_path / "j.jsonl"), meta={"entry": "test"})
    try:
        want = jax_grad_sync.emit_wire_accounting(
            {str(i): x for i, x in enumerate(leaves)}, cfg, 2)
    finally:
        jax_tele.reset()
    telemetry.configure(str(tmp_path / "p.jsonl"), meta={"entry": "test"})
    try:
        got = grad_sync.emit_wire_accounting(
            [torch.empty(x.shape, device="meta") for x in leaves], cfg, 2)
    finally:
        telemetry.reset()
    assert got == want
    rows = [json.loads(line) for line in
            (tmp_path / "p.jsonl").read_text().splitlines()]
    tp_rows = [e for e in rows if e.get("name") == "tp_psum_bytes_per_replica"]
    assert tp_rows and tp_rows[0]["axis"] == "model"


@pytest.mark.parametrize("m", [2, 4])
def test_carrier_round_trip_bitwise(m):
    params = jax_tiny_params()
    tmpl = port_template(TINY)
    sd = tp_split_dims(tmpl, GPT2LMHead.partition_rules(), m)
    shards = []
    for i in range(m):
        local = get_model("gpt2_124m", tp=TpAxis(m, i), **TINY)
        load_tp_params(local, params, sd)
        shards.append(dict(local.named_parameters()))
        assert {k: v.shape for k, v in tp_local_params(
            params, sd, m, i).items()} == {k: v.shape for k, v in
                                           shards[-1].items()}
    back = tp_global_params(shards, sd)
    for name, want in flax_to_torch(params).items():
        assert torch.equal(back[name], want), name


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def jax_loss_and_grads(params, kw, ids):
    model = JaxGPT2(**kw)
    task = JaxLMTask()

    class _State:
        apply_fn = staticmethod(model.apply)
        batch_stats = {}

    def loss_fn(p):
        loss, _ = task.loss_and_metrics(
            _State, p, {"input_ids": jnp.asarray(ids, jnp.int32),
                        "weight": jnp.ones(ids.shape[0])},
            jax.random.PRNGKey(0), train=True)
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(params)
    logits = model.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    return float(loss), jax.device_get(grads), np.asarray(logits)


MODEL_CASES = [("model 2", 2, TINY), ("model 4", 4, TINY),
               ("model 2 indivisible", 2, dict(TINY, vocab_size=50257))]


@pytest.mark.parametrize("job,m,kw", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
def test_tiny_gpt2_logits_and_grads_match_jax(pool, job, m, kw):
    params = pool["indiv" if "indivisible" in job else "params"]
    ids = tiny_ids(kw)
    loss_ref, g_ref, logits_ref = jax_loss_and_grads(params, kw, ids)
    shards = by_model_index(pool["ranks"], job)
    vocab_parallel = shards[0]["tp_vocab"]
    assert vocab_parallel == ("indivisible" not in job)
    logits = (np.concatenate([s["logits"] for s in shards], -1)
              if vocab_parallel else shards[0]["logits"])
    np.testing.assert_allclose(logits, logits_ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for s in shards:
        assert s["loss"] == shards[0]["loss"]
        np.testing.assert_allclose(s["loss"], loss_ref, rtol=LOSS_RTOL)
    # the model-axis all-reduces of one loss and backward: 4 a block, 2
    # for the vocab-parallel embedding, 2 for the cross-entropy's stats
    want = 4 * kw["depth"] + (4 if vocab_parallel else 0)
    assert all(s["all_reduces"] == want for s in shards)
    tmpl = port_template(kw)
    sd = {flax_path(n): d for n, d in tp_split_dims(
        tmpl, GPT2LMHead.partition_rules(), m).items()}
    for path, want_g in jax_by_path(g_ref).items():
        dim = sd[path]
        got = (shards[0]["grads"][path] if dim is None else
               np.concatenate([s["grads"][path] for s in shards], dim))
        for s in shards[1:]:
            if dim is None:      # a replicated leaf: the same bits
                np.testing.assert_array_equal(s["grads"][path], got)
        scale = float(np.abs(want_g).max())
        assert float(np.abs(got - np.asarray(want_g)).max()) <= \
            GRAD_REL * scale + 1e-12, path


# ---------------------------------------------------------------------------
# the Trainer: AdamW with the clip on, 3 steps on data=2,model=2
# ---------------------------------------------------------------------------


def jax_trainer_run(devices, config, params):
    """(per-step metrics, final global params) of the JAX Trainer on
    data=2,model=2 from ``params``: GSPMD TP under the rules, or explicit
    TP x FSDP."""
    mesh = jax_build_mesh(JaxMeshSpec(**MESH_A), devices=devices[:4])
    fsdp = config.get("fsdp_explicit", False)
    rules = JaxGPT2.partition_rules()
    if fsdp:
        tmpl = jax_template(TINY)
        sd = jax_sharding.tp_split_dims(tmpl, rules, 2)
        tx = jax_adamw(1e-2, grad_clip_norm=1.0, weight_decay=0.01,
                       shard_axes=TP_AXES,
                       clip_leaf_weights=jax_sharding.tp_clip_weights(
                           tmpl, sd, 2))
    else:
        tx = jax_adamw(1e-2, grad_clip_norm=1.0, weight_decay=0.01)
    t = JaxTrainer(JaxLMTask(), mesh, JaxTrainConfig(seed=0, **config),
                   rules=rules)
    s = t.init_state(JaxGPT2(**TINY), np.zeros((1, SEQ), np.int32), tx,
                     jax.random.PRNGKey(0))
    if fsdp:
        s = s.replace(params=jax_sharding.fsdp_tp_flat_params(
            params, mesh, 2, 2, t._tp_split_dims, TP_AXES))
    else:
        s = s.replace(params=jax.tree_util.tree_map(
            lambda new, old: jax.device_put(np.asarray(new), old.sharding),
            params, s.params))
    metrics = []
    for b in tiny_batches():
        s, m = t._train_step(s, shard_batch(b, mesh), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    final = t._fsdp_unflatten(s.params) if fsdp else s.params
    return metrics, jax_by_path(jax.device_get(final))


def port_global(pool_ranks, job, batch_index=0):
    shards = by_model_index(pool_ranks, job, batch_index)
    sd = {flax_path(n): d for n, d in tp_split_dims(
        port_template(TINY), GPT2LMHead.partition_rules(), 2).items()}
    return {p: (shards[0]["params"][p] if d is None else np.concatenate(
        [s["params"][p] for s in shards], d)) for p, d in sd.items()}


def check_tp_ranks_agree(ranks, job):
    """Replicated leaves bitwise equal on every rank; split leaves
    bitwise equal across the data axis."""
    sd = {flax_path(n): d for n, d in tp_split_dims(
        port_template(TINY), GPT2LMHead.partition_rules(), 2).items()}
    runs = [r[job] for r in ranks]
    for p, d in sd.items():
        for r in runs:
            same = [o for o in runs if d is None or o["index"] == r["index"]]
            for o in same:
                np.testing.assert_array_equal(o["params"][p],
                                              r["params"][p], err_msg=p)


@pytest.mark.parametrize("run", ["a", "b"])
def test_trainer_adamw_clip_matches_jax(devices, pool, run):
    metrics, want = jax_trainer_run(devices, TRAIN_RUNS[run],
                                    pool["params"])
    check_tp_ranks_agree(pool["ranks"], f"train {run}")
    ours = pool["ranks"][0][f"train {run}"]
    for m_ours, m_ref in zip(ours["metrics"], metrics):
        assert m_ours["weight"] == m_ref["weight"]
        np.testing.assert_allclose(m_ours["loss_sum"], m_ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    got = port_global(pool["ranks"], f"train {run}")
    start = jax_by_path(pool["params"])
    moved = 0.0
    for p, w in want.items():
        np.testing.assert_allclose(got[p], np.asarray(w), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=p)
        moved = max(moved, float(np.abs(np.asarray(w) - start[p]).max()))
    assert moved > 10 * PARAM_ATOL


@pytest.mark.parametrize("wire", ["int8", "int8_multihop"])
def test_trainer_int8_wires_within_jax_bound(pool, wire):
    """The int8 wires under TP x FSDP, WIRE_STEPS steps on one batch: the
    loss falls and stays within the JAX package's bound of the fp32
    run's; each leaf's movement from the start is the fp32 run's within
    WIRE_PARAM_REL (a wire that updated nothing, or the wrong chunk, is
    off by about its whole movement); the replicated leaves still
    bitwise equal on every rank (their own layer groups quantize them on
    one grid on every model rank); a residual per layer group, not all
    zero."""
    fp32 = pool["ranks"][0]["wire fp32"]["metrics"]
    run = pool["ranks"][0][f"wire {wire}"]
    losses = [m["loss_sum"] / m["weight"] for m in run["metrics"]]
    assert len(losses) == WIRE_STEPS and losses[-1] < losses[0]
    np.testing.assert_allclose(
        losses, [m["loss_sum"] / m["weight"] for m in fp32], rtol=MH_RTOL)
    check_tp_ranks_agree(pool["ranks"], f"wire {wire}")
    assert run["ef_groups"] == ["block0", "block0.replicated", "block1",
                                "block1.replicated", "ln_f", "wpe", "wte"]
    assert all(r[f"wire {wire}"]["ef_abs_sum"] > 0 for r in pool["ranks"])
    got = port_global(pool["ranks"], f"wire {wire}")
    ref = port_global(pool["ranks"], "wire fp32")
    start = jax_by_path(pool["params"])
    for p, want in ref.items():
        moved = float(np.linalg.norm(want - start[p]))
        off = float(np.linalg.norm(got[p] - want))
        assert moved > 0 and off <= WIRE_PARAM_REL * moved, (p, off, moved)


def test_tp_fsdp_at_rest_is_the_slice_over_the_data_ranks(pool):
    """Params and both AdamW moments: a split leaf holds its local
    slice's flat-padded size / N (1/(N x M) of the leaf), a replicated
    leaf its whole size / N."""
    tmpl = port_template(TINY)
    sd = tp_split_dims(tmpl, GPT2LMHead.partition_rules(), 2)
    local = tp_local_struct(tmpl, sd, 2)
    order = sorted(local, key=lambda n: tuple(flax_path(n).split("/")))
    want = [-(-math.prod(local[n]) // 2) for n in order]
    at_rest = pool["ranks"][0]["train b"]["at_rest"]
    assert at_rest["params"] == want
    assert sorted(at_rest["opt"]) == sorted(want * 2)


# ---------------------------------------------------------------------------
# train.main on 4 ranks
# ---------------------------------------------------------------------------


def entry_initial_params():
    """The global weights ``train.main`` draws from ``--seed`` at
    model=2 (the vocab padded to 128), as a flax tree."""
    model = get_model("gpt2_124m", pad_vocab_to_multiple_of=128, **ENTRY_KW)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return torch_to_flax(model)


def entry_batches(data_dir, epochs):
    ds = get_token_dataset("gpt2", ENTRY_SEQ, str(data_dir), train=True,
                           synthetic_size=ENTRY_SYNTHETIC, seed=SEED)
    loader = TokenLoader(ds, 4, shuffle=True, seed=SEED)
    return [{k: v.numpy() for k, v in b.items()}
            for e in range(epochs) for b in loader.epoch(e)]


def jax_entry_run(devices, data_dir, params, epochs):
    mesh = jax_build_mesh(JaxMeshSpec(**MESH_A), devices=devices[:4])
    model = JaxGPT2(pad_vocab_to_multiple_of=128, **ENTRY_KW)
    t = JaxTrainer(JaxLMTask(), mesh, JaxTrainConfig(seed=SEED),
                   rules=JaxGPT2.partition_rules())
    s = t.init_state(model, np.zeros((1, ENTRY_SEQ), np.int32),
                     jax_make_optimizer("adamw", LR, weight_decay=5e-4),
                     jax.random.PRNGKey(0))
    s = s.replace(params=jax.tree_util.tree_map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        params, s.params))
    metrics = []
    for b in entry_batches(data_dir, epochs):
        s, m = t._train_step(s, shard_batch(b, mesh), jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax_by_path(jax.device_get(s.params))


def entry_global_params(ranks, index, fsdp):
    """The global flax params of CLI run ``index`` from the 4 ranks'
    states (rank = batch index x 2 + model index): split leaves
    concatenated over the model ranks; FSDP chunks joined over the data
    ranks first."""
    tmpl = port_template(dict(ENTRY_KW, vocab_size=50304))
    sd = tp_split_dims(tmpl, GPT2LMHead.partition_rules(), 2)
    local = tp_local_struct(tmpl, sd, 2)
    states = [r["clis"][index]["state"] for r in ranks]
    out = {}
    for name, d in sd.items():
        shards = []
        for m in range(2):
            if fsdp:
                flat = np.concatenate([states[b * 2 + m][f"model/{name}"]
                                       for b in range(2)])
                t = flat[:math.prod(local[name])].reshape(local[name])
            else:
                t = states[m][f"model/{name}"]
            shards.append(t)
        out[flax_path(name)] = (shards[0] if d is None
                                else np.concatenate(shards, d))
    return out


@pytest.mark.parametrize("index,fsdp", [(0, False), (3, True)],
                         ids=["implicit", "fsdp-explicit"])
def test_train_main_matches_jax_trainer(devices, data_dir, pool, index,
                                        fsdp):
    params = entry_initial_params()
    metrics, want = jax_entry_run(devices, data_dir, params, 2)
    runs = [r["clis"][index] for r in pool["ranks"]]
    assert all(r["step"] == len(metrics) for r in runs)
    for ours, ref in zip(runs[0]["metrics"], metrics):
        assert ours["weight"] == ref["weight"] == 4 * (ENTRY_SEQ - 1)
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    # replicated over the data axis: the same bits (FSDP: each data rank
    # its own chunk, so the model-shaped comparison below covers it)
    if not fsdp:
        for m in range(2):
            for key, v in runs[m]["state"].items():
                if key.startswith("model/"):
                    np.testing.assert_array_equal(runs[2 + m]["state"][key],
                                                  v, err_msg=key)
    got = entry_global_params(pool["ranks"], index, fsdp)
    for p, w in want.items():
        np.testing.assert_allclose(got[p], np.asarray(w), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=p)


@pytest.mark.parametrize("full,resumed", [(0, 2), (3, 5)],
                         ids=["implicit", "fsdp-explicit"])
def test_resume_at_the_same_mesh_is_bitwise(pool, full, resumed):
    for rank in pool["ranks"]:
        a, b = rank["clis"][full], rank["clis"][resumed]
        assert a["step"] == b["step"]
        assert a["state"].keys() == b["state"].keys()
        for key, value in a["state"].items():
            np.testing.assert_array_equal(b["state"][key], value,
                                          err_msg=key)


# (checkpoint directory, its layout, the CLI run that wrote its newest
# checkpoint: the resumed one)
CKPTS = [("a_ckpt", "replicated", 2), ("b_ckpt", "fsdp", 5)]


@pytest.mark.parametrize("ckpt,layout,index", CKPTS,
                         ids=[f"{c[0]}-{c[1]}" for c in CKPTS])
def test_checkpoint_holds_the_global_model(pool, ckpt, layout, index):
    """The saved parameters are the run's global model in the JAX
    package's layout, bitwise: the global arrays, or under
    ``--fsdp-explicit`` JAX's ``tp_flat_leaf`` vectors of them."""
    d = pool["dir"] / ckpt
    labels = sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())
    meta = json.loads((d / str(labels[-1]) / "meta.json").read_text())
    assert meta["mesh"] == MeshSpec(**MESH_A).resolved(4)
    assert meta["model_shards"] == 2 and meta["layout"] == layout
    assert meta["param_shapes"]["wte.embedding"] == [50304, 32]
    params = torch.load(d / str(labels[-1]) / "params.pt",
                        weights_only=True)
    fsdp = layout == "fsdp"
    want = entry_global_params(pool["ranks"], index, fsdp)
    sd = {flax_path(n): d for n, d in tp_split_dims(
        port_template(dict(ENTRY_KW, vocab_size=50304)),
        GPT2LMHead.partition_rules(), 2).items()}
    for name, t in params.items():
        leaf = want[flax_path(name)]
        if fsdp:     # JAX's model-major flat layout
            leaf = np.asarray(jax_sharding.tp_flat_leaf(
                jnp.asarray(leaf), sd[flax_path(name)], 2, 2))
        np.testing.assert_array_equal(t.numpy(), leaf, err_msg=name)


@pytest.mark.parametrize("ckpt,layout,index", CKPTS,
                         ids=[f"{c[0]}-{c[1]}" for c in CKPTS])
def test_serving_restores_the_global_model(pool, ckpt, layout, index):
    """Serving's restore (``restore_params``) of either layout writes the
    run's global model into the global (unsplit) GPT-2, bitwise."""
    from distributed_pytorch_training_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )

    model = get_model("gpt2_124m", pad_vocab_to_multiple_of=128, **ENTRY_KW)
    meta = CheckpointManager(str(pool["dir"] / ckpt)).restore_params(
        model, layout, "AdamW")
    assert meta["model_shards"] == 2
    want = entry_global_params(pool["ranks"], index, layout == "fsdp")
    for p, leaf in jax_by_path(torch_to_flax(model)).items():
        np.testing.assert_array_equal(leaf, want[p], err_msg=p)


def test_restore_at_another_model_degree_raises_the_layout_hint(pool):
    """A checkpoint of model=2 restored into a model=1 state: the JAX
    entry's hint, not a shape error."""
    import re

    from distributed_pytorch_training_tpu_torch.training.checkpoint import (
        LAYOUT_HINT, CheckpointManager,
    )

    model = get_model("gpt2_124m", pad_vocab_to_multiple_of=128, **ENTRY_KW)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    state = Trainer(LanguageModelingTask(), TrainConfig(),
                    device="cpu").init_state(
        model, make_optimizer("adamw", LR))
    mgr = CheckpointManager(str(pool["dir"] / "a_ckpt"))
    with pytest.raises(ValueError, match=re.escape(LAYOUT_HINT)):
        mgr.restore_latest(state)


# ---------------------------------------------------------------------------
# the loader, the MFU reference
# ---------------------------------------------------------------------------


def test_model_ranks_of_a_batch_coordinate_read_the_same_rows():
    mesh_shape = MeshSpec(**MESH_A).resolved(4)
    ds = synthetic_token_dataset(16, SEQ, VOCAB, seed=0)
    rows = {}
    for r in range(4):
        mesh = Mesh(mesh_shape, r)
        loader = TokenLoader(ds, 2, shuffle=True, seed=0,
                             process_index=mesh.batch_index, process_count=2)
        rows[r] = [b["input_ids"] for b in loader.epoch(0)]
    for r, other in ((0, 1), (2, 3)):      # one batch coordinate each
        assert all(torch.equal(x, y) for x, y in zip(rows[r], rows[other]))
    assert not torch.equal(rows[0][0], rows[2][0])


def test_mfu_counts_the_global_model_with_its_padded_head():
    from distributed_pytorch_training_tpu_torch.experiments import flops

    ids = torch.zeros((1, SEQ), dtype=torch.long, device="meta")
    plain = flops.matmul_flops(get_model(
        "gpt2_124m", device="meta", **dict(TINY, vocab_size=50257)), ids)
    padded = flops.matmul_flops(get_model(
        "gpt2_124m", device="meta", pad_vocab_to_multiple_of=128,
        **dict(TINY, vocab_size=50257)), ids)
    assert padded - plain == 2 * SEQ * 32 * (50304 - 50257)


# ---------------------------------------------------------------------------
# BERT-base and ViT-B/16 on the model axis
# ---------------------------------------------------------------------------


def split_template(model, kw):
    m = get_model(model, device="meta", **kw,
                  **({"image_size": 32} if model == "vit_b16" else {}))
    return m, [(n, tuple(p.shape)) for n, p in m.named_parameters()]


def jax_split_template(model, kw):
    from distributed_pytorch_training_tpu.models import (
        get_model as jax_get_model,
    )

    jm = jax_get_model(model, **kw)
    sample = (jnp.zeros((1, 32, 32, 3)) if model == "vit_b16"
              else jnp.zeros((2, SEQ), jnp.int32))
    return jm, jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), sample, train=False))["params"]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(SPLIT_MODELS))
def test_bert_vit_split_dims_local_struct_and_clip_bitwise_jax(name, m):
    """The layout of BERT's and ViT's leaves over ``model``: the split
    dims, the local shapes and the clip's weights, bitwise the JAX
    package's (BERT at its full 30522 vocab padded to lcm(128, M) too)."""
    model, kw = SPLIT_MODELS[name]
    cases = [kw] + ([dict(kw, vocab_size=30522,
                          pad_vocab_to_multiple_of=math.lcm(128, m))]
                    if model == "bert_base" else [])
    for case in cases:
        jm, jt = jax_split_template(model, case)
        jsd = jax_sharding.tp_split_dims(jt, jm.partition_rules(), m)
        want = jax_by_path(jsd, is_leaf=lambda x: x is None)
        jlocal = jax_by_path(jax_sharding.tp_local_struct(jt, jsd, m))
        pm, tmpl = split_template(model, case)
        sd = tp_split_dims(tmpl, pm.partition_rules(), m)
        assert {flax_path(n): d for n, d in sd.items()} == want
        assert {flax_path(n): s for n, s in tp_local_struct(
            tmpl, sd, m).items()} == {p: tuple(v.shape)
                                      for p, v in jlocal.items()}
        assert clip_weights(tmpl, sd, m) == \
            jax_sharding.tp_clip_weights(jt, jsd, m)
        # what stays whole over model: BERT's position and type tables,
        # LayerNorms, MLM dense and bias; ViT's patch embedding, CLS,
        # positions, final LayerNorm and head
        whole = {n for n, d in sd.items() if d is None}
        if model == "bert_base":
            assert sd["token_embedding.embedding"] == 0
            assert case["pad_vocab_to_multiple_of"] * (
                -(-case["vocab_size"]
                  // case["pad_vocab_to_multiple_of"])) % m == 0
            assert {"mlm_bias", "position_embedding.embedding",
                    "type_embedding.embedding", "mlm_dense.kernel",
                    "blocks.0.ln1.scale"} <= whole
        else:
            assert {"patch_embed.kernel", "cls_token", "pos_embedding",
                    "ln_final.scale", "head.kernel"} <= whole
        assert sd["blocks.1.attn.qkv.kernel"] == 2
        assert sd["blocks.1.mlp.fc2.kernel"] == 0


@pytest.mark.parametrize("name", list(SPLIT_MODELS))
def test_bert_vit_carrier_round_trip_bitwise(name):
    model, kw = SPLIT_MODELS[name]
    params = jax_split_params(model, kw)
    full, tmpl = split_template(model, kw)
    sd = tp_split_dims(tmpl, full.partition_rules(), 2)
    extra = {"image_size": 32} if model == "vit_b16" else {}
    shards = []
    for i in range(2):
        local = get_model(model, tp=TpAxis(2, i), **kw, **extra)
        load_tp_params(local, params, sd)
        shards.append(dict(local.named_parameters()))
    if model == "bert_base":
        assert local.tp_vocab
        assert shards[1]["token_embedding.embedding"].shape == (128, 32)
        assert shards[1]["mlm_bias"].shape == (200,)
    back = tp_global_params(shards, sd)
    for leaf, want in flax_to_torch(params).items():
        assert torch.equal(back[leaf], want), leaf
    with pytest.raises(ValueError, match="slices of the global"):
        local.reset_parameters(torch.Generator().manual_seed(0))


def jax_split_loss_and_grads(model, kw, params, inputs):
    """(loss, grads, logits) of the JAX model and task on the global
    weights: BERT's masked LM under the step key (logits of its masked
    inputs), ViT's image task without augmentation."""
    from distributed_pytorch_training_tpu.data.augment import (
        normalize_images as jax_normalize,
    )
    from distributed_pytorch_training_tpu.training.tasks import (
        ImageClassificationTask as JaxImageTask, MaskedLMTask as JaxMLMTask,
    )

    jm, _ = jax_split_template(model, kw)

    class _State:
        apply_fn = staticmethod(jm.apply)
        batch_stats = {}

    if model == "vit_b16":
        task = JaxImageTask(*IMAGE_MEAN_STD, augment=False)
        x = inputs["images"]
        batch = {"image": jnp.asarray(x),
                 "label": jnp.asarray(inputs["labels"], jnp.int32),
                 "weight": jnp.ones(x.shape[0])}
        rng = jax.random.PRNGKey(0)
        model_in = jax_normalize(jnp.asarray(x), *IMAGE_MEAN_STD)
    else:
        task = JaxMLMTask(vocab_size=kw["vocab_size"])
        ids = jnp.asarray(inputs["ids"], jnp.int32)
        batch = {"input_ids": ids, "weight": jnp.ones(ids.shape[0])}
        rng = jax.random.PRNGKey(5)
        k_sel, k_act, k_rand = jax.random.split(rng, 3)
        selected = jax.random.bernoulli(k_sel, task.mask_prob, ids.shape)
        action = jax.random.uniform(k_act, ids.shape)
        masked = jnp.where(action < 0.8, task.mask_token_id, jnp.where(
            action < 0.9, jax.random.randint(k_rand, ids.shape, 0,
                                             task.vocab_size), ids))
        model_in = jnp.where(selected, masked, ids)

    def loss_fn(p):
        loss, _ = task.loss_and_metrics(_State, p, batch, rng, train=True)
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(params)
    logits = jm.apply({"params": params}, model_in)
    return float(loss), jax.device_get(grads), np.asarray(logits)


@pytest.mark.parametrize("name", list(SPLIT_MODELS))
def test_tiny_bert_vit_logits_and_grads_match_jax(pool, name):
    """One loss and backward at model=2 against the JAX model and task on
    the global weights: the logits (BERT's gathered from its two vocab
    shards, the padding columns masked on the second), the loss (equal
    on both ranks), the gathered gradients, and the model-axis
    all-reduces of the step: 4 a block, and for BERT 2 for the
    vocab-parallel embedding and tied decoder, 1 for the replicated
    bias's slices and 2 for the cross-entropy's stats."""
    model, kw = SPLIT_MODELS[name]
    params = pool["split_params"][name]
    loss_ref, g_ref, logits_ref = jax_split_loss_and_grads(
        model, kw, params, split_inputs(model))
    shards = by_model_index(pool["ranks"], f"{name} 2")
    if model == "bert_base":
        assert shards[0]["tp_vocab"]
        logits = np.concatenate([sh["logits"] for sh in shards], -1)
        # the padded columns, all on shard 1, hold the float32 minimum
        pad = shards[1]["logits"][..., 200 - 128:]
        assert (pad == np.finfo(np.float32).min).all()
        want_reduces = 4 * kw["depth"] + 5
    else:
        logits = shards[0]["logits"]
        np.testing.assert_array_equal(shards[1]["logits"], logits)
        want_reduces = 4 * kw["depth"]
    np.testing.assert_allclose(logits, logits_ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for sh in shards:
        assert sh["loss"] == shards[0]["loss"]
        assert sh["all_reduces"] == want_reduces
        np.testing.assert_allclose(sh["loss"], loss_ref, rtol=LOSS_RTOL)
    full, tmpl = split_template(model, kw)
    sd = {flax_path(n): d for n, d in tp_split_dims(
        tmpl, full.partition_rules(), 2).items()}
    for path, want_g in jax_by_path(g_ref).items():
        dim = sd[path]
        got = (shards[0]["grads"][path] if dim is None else
               np.concatenate([sh["grads"][path] for sh in shards], dim))
        if dim is None:      # a replicated leaf: the same bits
            np.testing.assert_array_equal(shards[1]["grads"][path], got)
        scale = float(np.abs(want_g).max())
        assert float(np.abs(got - np.asarray(want_g)).max()) <= \
            GRAD_REL * scale + 1e-12, path


def test_trainer_adamw_clip_bert_matches_jax(devices, pool):
    """The Trainer, AdamW with the global-norm clip on (its weights by
    parameter, F5), 3 steps of BERT's masked LM on data=2,model=2 against
    the JAX Trainer's GSPMD step from the same weights and step keys, at
    BERT_CLIP_LR: the replicated leaves bitwise equal on every rank, the
    split ones across the data axis; every step's loss within LOSS_RTOL,
    the parameters within PARAM_RTOL, PARAM_ATOL."""
    from distributed_pytorch_training_tpu.training.tasks import (
        MaskedLMTask as JaxMLMTask,
    )

    model, kw = SPLIT_MODELS["bert"]
    jm, _ = jax_split_template(model, kw)
    mesh = jax_build_mesh(JaxMeshSpec(**MESH_A), devices=devices[:4])
    t = JaxTrainer(JaxMLMTask(vocab_size=kw["vocab_size"]), mesh,
                   JaxTrainConfig(seed=0), rules=jm.partition_rules())
    params = pool["ranks"][0]["train bert"]
    start = jax_split_params(model, kw)
    s = t.init_state(jm, np.zeros((1, SEQ), np.int32),
                     jax_adamw(BERT_CLIP_LR, grad_clip_norm=1.0,
                               weight_decay=0.01), jax.random.PRNGKey(0))
    s = s.replace(params=jax.tree_util.tree_map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        start, s.params))
    epoch_key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    metrics = []
    for b in bert_batches():
        s, m = t._train_step(s, shard_batch(b, mesh), epoch_key)
        metrics.append({k: float(v) for k, v in m.items()})
    want = jax_by_path(jax.device_get(s.params))
    full, tmpl = split_template(model, kw)
    sd = {flax_path(n): d for n, d in tp_split_dims(
        tmpl, full.partition_rules(), 2).items()}
    runs = [r["train bert"] for r in pool["ranks"]]
    for p, d in sd.items():
        for r in runs:
            for o in runs:
                if d is None or o["index"] == r["index"]:
                    np.testing.assert_array_equal(o["params"][p],
                                                  r["params"][p], err_msg=p)
    for ours, ref in zip(params["metrics"], metrics):
        assert ours["weight"] == ref["weight"] > 0
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    shards = by_model_index(pool["ranks"], "train bert")
    start = jax_by_path(start)
    moved = 0.0
    for p, w in want.items():
        got = (shards[0]["params"][p] if sd[p] is None else np.concatenate(
            [sh["params"][p] for sh in shards], sd[p]))
        np.testing.assert_allclose(got, np.asarray(w), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=p)
        moved = max(moved, float(np.abs(np.asarray(w) - start[p]).max()))
    # every step moved the weights: Adam's steps are about lr each
    assert moved > 2 * BERT_CLIP_LR


def split_run_index(name):
    return len(CLI_RUNS) + list(SPLIT_CLI_RUNS).index(name)


def split_global_params(ranks, name, fsdp, batch_index=0):
    """The global flax params of a SPLIT_CLI_RUNS run from the states of
    the ranks of one batch coordinate (rank = batch index x 2 + model
    index); under FSDP each model shard's chunks joined over the data
    ranks first."""
    states = [r["clis"][split_run_index(name)]["state"] for r in ranks]
    full = one_rank_model(SPLIT_CLI_RUNS[name][0])
    tmpl = [(n, tuple(p.shape)) for n, p in full.named_parameters()]
    sd = tp_split_dims(tmpl, full.partition_rules(), 2)
    local = tp_local_struct(tmpl, sd, 2)
    out = {}
    for leaf, d in sd.items():
        parts = []
        for m in range(2):
            if fsdp:
                flat = np.concatenate([states[b * 2 + m][f"model/{leaf}"]
                                       for b in range(2)])
                parts.append(flat[:math.prod(local[leaf])]
                             .reshape(local[leaf]))
            else:
                parts.append(states[batch_index * 2 + m][f"model/{leaf}"])
        out[leaf] = parts[0] if d is None else np.concatenate(parts, d)
    return out


def one_rank_model(family):
    """The global model the entry builds at model=2 (BERT's vocab padded
    to 128), on the meta device."""
    model = SPLIT_MODELS[family][0]
    kw = dict(pair.split("=") for pair in SPLIT_OVERRIDES[family].split(","))
    kw = {k: int(v) for k, v in kw.items()}
    if model == "bert_base":
        return get_model(model, device="meta", pad_vocab_to_multiple_of=128,
                         **kw)
    return get_model(model, device="meta", image_size=224,
                     num_classes=1000, **kw)


@pytest.fixture(scope="module")
def split_model1(pool, data_dir, tmp_path_factory):
    """The model=1 yardsticks: each SPLIT_CLI_RUNS family's command in
    this process without a mesh, over the same global batches (batch 4,
    BERT's vocab padded to 128 as at model=2): every step's metrics and
    the final parameters."""
    from distributed_pytorch_training_tpu_torch.training import (
        Trainer as PortTrainer,
    )

    tmp = tmp_path_factory.mktemp("split_model1")
    step = PortTrainer.train_step
    out = {}
    for family in ("bert", "vit"):
        metrics = []

        def recording(self, state, batch):
            m = step(self, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            return m

        argv = split_cli(family, tmp, data_dir, mesh_free=True)
        argv[argv.index("--batch-size") + 1] = "4"
        if family == "bert":
            i = argv.index("--model-overrides") + 1
            argv[i] += ",pad_vocab_to_multiple_of=128"
        PortTrainer.train_step = recording
        try:
            state = train.main(argv)
        finally:
            PortTrainer.train_step = step
        out[family] = {"metrics": metrics, "params": {
            n: p.detach().numpy().copy()
            for n, p in state.model.named_parameters()}}
    return out


@pytest.mark.parametrize("name", ["bert", "vit"])
def test_entry_trains_bert_and_vit_on_the_model_axis(pool, split_model1,
                                                     name):
    """``train.main --model bert_base|vit_b16 --mesh data=2,model=2`` on
    4 gloo ranks: the replicated leaves bitwise equal on every rank and
    the split ones across the data axis; every step's loss and the final
    parameters against the model=1 run over the same global batches."""
    ranks = pool["ranks"]
    runs = [r["clis"][split_run_index(name)] for r in ranks]
    ref = split_model1[name]
    assert all(r["step"] == len(ref["metrics"]) == 4 for r in runs)
    for ours, want in zip(runs[0]["metrics"], ref["metrics"]):
        assert ours["weight"] == want["weight"]
        np.testing.assert_allclose(ours["loss_sum"], want["loss_sum"],
                                   rtol=LOSS_RTOL)
    full = one_rank_model(name)
    sd = tp_split_dims([(n, tuple(p.shape)) for n, p in
                        full.named_parameters()], full.partition_rules(), 2)
    for leaf, d in sd.items():
        key = f"model/{leaf}"
        for r, run in enumerate(runs):
            peers = [o for i, o in enumerate(runs)
                     if d is None or i % 2 == r % 2]
            for o in peers:
                np.testing.assert_array_equal(o["state"][key],
                                              run["state"][key],
                                              err_msg=key)
    got = split_global_params(ranks, name, fsdp=False)
    for leaf, want in ref["params"].items():
        np.testing.assert_allclose(got[leaf], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=leaf)


@pytest.mark.parametrize("name", ["bert", "vit"])
def test_serving_restores_a_bert_or_vit_tp_checkpoint(pool, name):
    """A data=2,model=2 checkpoint of BERT or ViT is served on one device
    as the global model, bitwise the run's final parameters."""
    from distributed_pytorch_training_tpu_torch.experiments.harness import (
        build_serving_engine,
    )

    family = SPLIT_CLI_RUNS[name][0]
    ckpt = pool["dir"] / f"split_{name.replace(' ', '_')}_ckpt"
    overrides = dict(pair.split("=")
                     for pair in SPLIT_OVERRIDES[family].split(","))
    overrides = {k: int(v) for k, v in overrides.items()}
    if family == "bert":
        overrides["pad_vocab_to_multiple_of"] = 128
    else:
        overrides.update(image_size=224, num_classes=1000)
    engine = build_serving_engine(
        SPLIT_MODELS[family][0], device="cpu", ckpt_dir=str(ckpt),
        layout="replicated", model_overrides=overrides)
    assert engine.checkpoint_info["step"] == 4
    want = split_global_params(pool["ranks"], name, fsdp=False)
    for leaf, t in engine._served.items():
        np.testing.assert_array_equal(t.numpy(), want[leaf], err_msg=leaf)
    if family == "bert":
        res = engine.serve_tokens([np.arange(1, 9, dtype=np.int32)])
        assert res[0].last_logits.shape == (30592,)
        assert np.isfinite(res[0].last_logits[:30522]).all()
    else:
        logits = engine.serve_images(
            np.zeros((2, 224, 224, 3), np.uint8), *IMAGE_MEAN_STD)
        assert logits.shape == (2, 1000) and np.isfinite(logits).all()


def test_mfu_counts_bert_with_its_padded_head():
    from distributed_pytorch_training_tpu_torch.experiments import flops

    ids = torch.zeros((1, SEQ), dtype=torch.long, device="meta")
    kw = dict(hidden_dim=32, depth=2, num_heads=2, mlp_dim=64,
              max_position=SEQ)
    plain = flops.matmul_flops(get_model("bert_base", device="meta", **kw),
                               ids)
    padded = flops.matmul_flops(get_model(
        "bert_base", device="meta", pad_vocab_to_multiple_of=128, **kw), ids)
    assert padded - plain == 2 * SEQ * 32 * (30592 - 30522)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def one_process_mesh(**kw):
    return Mesh(MeshSpec(**kw).resolved(kw.get("model", 1)
                                        * kw.get("data", 1)), 0)


def test_int8_hier_refused_under_explicit_tp_as_jax(devices):
    cfg = dict(fsdp_explicit=True, wire_dtype="int8_hier")
    with pytest.raises(ValueError) as ref:
        JaxTrainer(JaxLMTask(), jax_build_mesh(
            JaxMeshSpec(data=1, model=2), devices=devices[:2]),
            JaxTrainConfig(**cfg))
    with pytest.raises(ValueError) as ours:
        Trainer(LanguageModelingTask(), TrainConfig(**cfg), device="cpu",
                mesh=one_process_mesh(data=1, model=2))
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("config", [dict(wire_dtype="int8"),
                                    dict(bucket_cap_mb=25.0)],
                         ids=["int8-wire", "bucketed"])
def test_explicit_reducer_refused_on_a_model_mesh_as_jax(devices, config):
    with pytest.raises(ValueError) as ref:
        JaxTrainer(JaxLMTask(), jax_build_mesh(
            JaxMeshSpec(data=1, model=2), devices=devices[:2]),
            JaxTrainConfig(**config))
    with pytest.raises(ValueError) as ours:
        Trainer(LanguageModelingTask(), TrainConfig(**config), device="cpu",
                mesh=one_process_mesh(data=1, model=2))
    assert str(ours.value) == str(ref.value)


def test_tp_needs_a_tp_capable_model_as_jax(devices):
    from distributed_pytorch_training_tpu.models.resnet import (
        resnet18 as jax_resnet18,
    )
    from distributed_pytorch_training_tpu.training.optim import sgd

    jt = JaxTrainer(JaxLMTask(), jax_build_mesh(
        JaxMeshSpec(data=1, model=2), devices=devices[:2]),
        JaxTrainConfig(seed=0, fsdp_explicit=True))
    with pytest.raises(ValueError) as ref:
        jt.init_state(jax_resnet18(num_classes=10),
                      np.zeros((1, 32, 32, 3), np.float32), sgd(0.1),
                      jax.random.PRNGKey(0))
    t = Trainer(LanguageModelingTask(), TrainConfig(fsdp_explicit=True),
                device="cpu", mesh=one_process_mesh(data=1, model=2))
    with pytest.raises(ValueError) as ours:
        t.init_state(get_model("resnet18", num_classes=10, num_filters=4),
                     make_optimizer("sgd", 0.1))
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("name", list(SPLIT_MODELS))
def test_fsdp_explicit_refuses_bert_and_vit_on_the_model_axis_as_jax(
        devices, name):
    """BERT and ViT split over ``model`` on the implicit path only: under
    fsdp_explicit the JAX Trainer refuses every model without GPT-2's
    explicit-TP fields, and the port refuses with its message."""
    from distributed_pytorch_training_tpu.models import (
        get_model as jax_get_model,
    )
    from distributed_pytorch_training_tpu.training.optim import sgd

    model, kw = SPLIT_MODELS[name]
    sample = (np.zeros((1, 32, 32, 3), np.float32) if model == "vit_b16"
              else np.zeros((1, SEQ), np.int32))
    jt = JaxTrainer(JaxLMTask(), jax_build_mesh(
        JaxMeshSpec(data=1, model=2), devices=devices[:2]),
        JaxTrainConfig(seed=0, fsdp_explicit=True))
    with pytest.raises(ValueError) as ref:
        jt.init_state(jax_get_model(model, **kw), sample, sgd(0.1),
                      jax.random.PRNGKey(0))
    t = Trainer(LanguageModelingTask(), TrainConfig(fsdp_explicit=True),
                device="cpu", mesh=one_process_mesh(data=1, model=2))
    with pytest.raises(ValueError) as ours:
        t.init_state(get_model(model, **kw), make_optimizer("sgd", 0.1))
    assert str(ours.value) == str(ref.value)


def test_tp_refuses_indivisible_heads_as_jax(devices):
    kw = dict(vocab_size=VOCAB, hidden_dim=32, depth=1, num_heads=2,
              max_position=SEQ)
    from distributed_pytorch_training_tpu.training.optim import sgd

    jt = JaxTrainer(JaxLMTask(), jax_build_mesh(
        JaxMeshSpec(data=1, model=4), devices=devices[:4]),
        JaxTrainConfig(seed=0, fsdp_explicit=True))
    with pytest.raises(ValueError) as ref:
        jt.init_state(JaxGPT2(**kw), np.zeros((1, SEQ), np.int32),
                      sgd(0.1), jax.random.PRNGKey(0))
    t = Trainer(LanguageModelingTask(), TrainConfig(fsdp_explicit=True),
                device="cpu", mesh=one_process_mesh(data=1, model=4))
    with pytest.raises(ValueError) as ours:
        t.init_state(get_model("gpt2_124m", **kw),
                     make_optimizer("sgd", 0.1))
    assert str(ours.value) == str(ref.value)
    # the module's own check, JAX's message too
    with pytest.raises(ValueError, match="num_heads=2 not divisible by "
                                         "tp_size=4"):
        get_model("gpt2_124m", tp=TpAxis(4), **kw)


def test_tp_refuses_dropout_as_jax():
    kw = dict(vocab_size=50257, hidden_dim=32, depth=1, num_heads=2,
              max_position=SEQ, dropout_rate=0.1)
    model = JaxGPT2(tp_size=2, tp_axis=MODEL, **kw)
    with pytest.raises(ValueError) as ref:
        jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((2, SEQ), jnp.int32), train=True))
    with pytest.raises(ValueError) as ours:
        get_model("gpt2_124m", tp=TpAxis(2), **kw)
    assert str(ours.value) == str(ref.value)


def test_tp_refuses_a_kv_cache_as_jax():
    kw = dict(vocab_size=VOCAB, hidden_dim=32, depth=1, num_heads=2,
              max_position=SEQ)
    jm = JaxGPT2(tp_size=2, tp_axis=MODEL, **kw)
    with pytest.raises(ValueError) as ref:
        jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
            cache=jm.init_cache(1, 8)))
    model = get_model("gpt2_124m", tp=TpAxis(2), **kw)
    with pytest.raises(ValueError) as ours:
        model(torch.zeros((1, 4), dtype=torch.long),
              cache=model.init_cache(1, 8))
    assert str(ours.value) == str(ref.value)


def test_tp_local_model_refuses_its_own_init():
    model = get_model("gpt2_124m", tp=TpAxis(2), **TINY)
    with pytest.raises(ValueError, match="slices of the global"):
        model.reset_parameters(torch.Generator().manual_seed(0))


def test_ruleless_model_on_a_model_axis_refused_as_jax(devices):
    jmesh = jax_build_mesh(JaxMeshSpec(data=1, model=2), devices=devices[:2])
    with pytest.raises(ValueError) as ref:
        jax_validate_mesh_usage(jmesh, rules=None)
    mesh = one_process_mesh(data=1, model=2)
    with pytest.raises(ValueError) as ours:
        validate_mesh_usage(mesh, rules=None)
    assert str(ours.value) == str(ref.value)
    validate_mesh_usage(mesh, rules=GPT2LMHead.partition_rules())


def test_zero1_on_a_model_mesh_refused_naming_its_slice():
    """ZeRO-1 on a model mesh runs (tests/test_torch_mesh_compose.py);
    what still waits is a model split over model and expert at once."""
    mesh = Mesh(MeshSpec(model=2, expert=2).resolved(4), 0)
    with pytest.raises(NotImplementedError, match="the expert x model slice"):
        Trainer(LanguageModelingTask(), TrainConfig(zero1=True),
                device="cpu", mesh=mesh)


ENTRY = ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
         OVERRIDES, "--seq-len", str(ENTRY_SEQ), "--synthetic",
         "--synthetic-size", "8", "--batch-size", "2", "--epochs", "1",
         "--no-telemetry"]

# ZeRO-1, seq x model and the fsdp axis with model run now
# (tests/test_torch_mesh_compose.py, test_torch_fsdp_axis.py); each case
# is the refusal that still stands beside it
@pytest.mark.parametrize("argv,match", [
    (ENTRY + ["--mesh", "model=2,expert=2", "--zero1"],
     "the expert x model slice"),
    (ENTRY + ["--mesh", "fsdp=2,seq=2,model=2", "--attention", "ring"],
     "a later slice of the fsdp axis"),
    (ENTRY + ["--mesh", "fsdp=2,pipe=2"],
     "a later slice of the fsdp axis"),
], ids=["zero1", "seq-x-model", "fsdp-axis"])
def test_entry_refuses_what_waits_naming_its_slice(tmp_path, argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train.main(argv + ["--output-dir", str(tmp_path)])
    assert not (tmp_path / "metrics_rank0.csv").exists()
