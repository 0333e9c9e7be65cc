"""Pipeline parallelism over the mesh's ``pipe`` axis (GPipe, GPT-2), the
port against the JAX package on the CPU.

* ``pipeline_apply`` of a toy residual layer on 2 gloo stages against
  ``sequential_apply`` and against JAX's ``pipeline_apply`` (a
  ``shard_map`` over ``pipe`` on 2 CPU devices), forward and gradients
  (of the stage leaves and of the input), float32; bf16 against the
  float32 run; at P = 1 the plain loop over the merged stack.
* A tiny ``GPT2PipeLMHead`` on 2 stages: logits, the causal LM loss and
  its gradients against JAX's ``GPT2PipeLMHead`` under ``jax.grad`` on
  the pipe mesh, and against the port's sequential GPT-2 (``gpt2_124m``)
  of the same weights (``convert.pipe_to_gpt2_params``). JAX's gradients
  through its masked ``psum`` broadcast are the sequential model's: no
  reference-side fault to record.
* The Trainer, AdamW with the global-norm clip on, 3 steps on
  ``data=1,pipe=2`` against the JAX Trainer on the same mesh shape; the
  replicated leaves (``wte``, ``wpe``, ``ln_f``) bitwise equal on both
  stages.
* ``train.main`` under 2 gloo ranks, ``--mesh pipe=2 --microbatches 2``,
  against the JAX Trainer from the entry's initial weights over the same
  batches; a run stopped after one epoch and ``--resume``d at the same
  mesh ends bitwise the uninterrupted run; its checkpoint holds JAX's
  global layout (the (P, L/P, ...) stacks); another layout raises with
  ``LAYOUT_HINT``.
* The carrier: a ``gpt2_*`` model's blocks stacked into the pipelined
  model's global stacks and back, and the stacks cut to a stage's slice
  and joined back, bitwise; one seed draws the same weights for both
  models.
* The refusals (JAX's messages), ``--attention auto`` inside the stages,
  the loader's rows, the MFU's FLOPs.

The ranks are ``tests/_torch_dp_worker.py`` processes: one module-scoped
run of 2 serves every leg.

Tolerances (float32 reassociation: microbatched products, the order of
the layers' gradient sums): outputs within OUT_TOL = 1e-5 and gradients
within GRAD_REL = 1e-5 of each leaf's largest; bf16 within BF16_REL =
2e-2 of the float32 run's largest (each layer rounds its output to
bf16); trajectories' losses within LOSS_RTOL = 2e-5 and parameters within
PARAM_RTOL = 2e-2, PARAM_ATOL = 2e-3 under AdamW (the bound of
``tests/test_torch_tp.py``: Adam's normalized step turns a last-bit
gradient difference near zero into a visible one).
"""

import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models.gpt2_pipe import (
    GPT2PipeLMHead as JaxPipe,
)
from distributed_pytorch_training_tpu.parallel import (
    MeshSpec as JaxMeshSpec, build_mesh as jax_build_mesh, shard_batch,
)
from distributed_pytorch_training_tpu.parallel import pipeline as jax_pipe
from distributed_pytorch_training_tpu.parallel.mesh import (
    validate_mesh_usage as jax_validate_mesh_usage,
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
    flax_to_torch, gpt2_to_pipe_params, load_flax_params,
    pipe_to_gpt2_params, tp_global_params, tp_local_params, torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.data.text import (
    TokenLoader, get_token_dataset, synthetic_token_dataset,
)
from distributed_pytorch_training_tpu_torch.models import (
    GPT2PipeLMHead, get_model,
)
from distributed_pytorch_training_tpu_torch.models.layers import gelu
from distributed_pytorch_training_tpu_torch.parallel.collectives import (
    TpAxis,
)
from distributed_pytorch_training_tpu_torch.parallel.mesh import (
    PIPE, Mesh, MeshSpec, validate_mesh_usage,
)
from distributed_pytorch_training_tpu_torch.parallel.pipeline import (
    pipeline_apply, sequential_apply, stack_to_stages,
)
from distributed_pytorch_training_tpu_torch.parallel.sharding import (
    flax_path, tp_split_dims,
)
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig, Trainer, make_optimizer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    LanguageModelingTask,
)

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401 (autouse)

OUT_TOL = 1e-5
GRAD_REL = 1e-5
BF16_REL = 2e-2
LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-2, 2e-3

SEQ, VOCAB, DIM = 16, 64, 8
TINY = dict(vocab_size=VOCAB, hidden_dim=32, depth=4, num_heads=2,
            max_position=SEQ)
MESH = dict(data=1, pipe=2)
STAGES, MICRO = 2, 2
# the entry's runs: GPT-2's vocab (the synthetic corpus carries its ids)
ENTRY_SEQ, ENTRY_SYNTHETIC, SEED, LR = 32, 16, 0, 1e-3
ENTRY_KW = dict(vocab_size=50257, hidden_dim=32, depth=4, num_heads=2,
                max_position=ENTRY_SEQ)
OVERRIDES = ",".join(f"{k}={v}" for k, v in ENTRY_KW.items())


def toy_setup():
    """(stacked toy-layer leaves (L=4, ...), x, cotangent), numpy."""
    rng = np.random.RandomState(0)
    stacked = {"kernel": (rng.randn(4, DIM, DIM) * 0.3).astype(np.float32),
               "bias": (rng.randn(4, DIM) * 0.1).astype(np.float32)}
    x = rng.randn(8, 4, DIM).astype(np.float32)
    ct = rng.randn(8, 4, DIM).astype(np.float32)
    return stacked, x, ct


def jax_tiny_params():
    """JAX's GPT2PipeLMHead init on the pipe=2 mesh, as a flax tree."""
    mesh = jax_build_mesh(JaxMeshSpec(**MESH), devices=jax.devices()[:2])
    model = JaxPipe(mesh=mesh, num_microbatches=MICRO, **TINY)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"])


def tiny_ids(rows=4):
    return np.random.RandomState(1).randint(
        0, VOCAB, (rows, SEQ)).astype(np.int64)


def tiny_batches(steps=3, rows=4):
    rng = np.random.RandomState(0)
    return [{"input_ids": rng.randint(0, VOCAB, (rows, SEQ)).astype(
                np.int32),
             "weight": np.ones(rows, np.float32)} for _ in range(steps)]


def clip_tx():
    return ("adamw", dict(grad_clip_norm=1.0, weight_decay=0.01))


def cli(tmp, data_dir, epochs, *extra):
    return ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
            OVERRIDES, "--seq-len", str(ENTRY_SEQ), "--synthetic",
            "--synthetic-size", str(ENTRY_SYNTHETIC), "--data-dir",
            str(data_dir), "--epochs", str(epochs), "--batch-size", "4",
            "--optimizer", "adamw", "--lr", str(LR), "--print-freq",
            "1000", "--no-telemetry", "--seed", str(SEED), "--mesh",
            "pipe=2", "--microbatches", str(MICRO), "--output-dir",
            str(tmp), *extra]


# (name, epochs, checkpoint dir, resume)
CLI_RUNS = [("full", 2, None, False), ("part", 1, "ckpt", False),
            ("resumed", 2, "ckpt", True)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("pipe_data")


@pytest.fixture(scope="module")
def pool(tmp_path_factory, data_dir):
    tmp = tmp_path_factory.mktemp("pipe2")
    params = jax_tiny_params()
    stacked, x, ct = toy_setup()
    spec = dict(kind="pipe", mesh=MESH, params=params,
                model_kwargs=dict(TINY, num_stages=STAGES,
                                  num_microbatches=MICRO))
    jobs = {
        "ops": ("pipe_ops", dict(mesh=MESH, stacked=stacked, x=x, ct=ct,
                                 microbatches=MICRO)),
        "model": ("split_model", dict(spec, ids=tiny_ids())),
        "train": ("split_train", dict(spec, batches=tiny_batches(),
                                      optimizer=clip_tx(), lr=1e-2)),
    }
    runs = []
    for name, epochs, ckpt, resume in CLI_RUNS:
        extra = ["--checkpoint-dir", str(tmp / ckpt)] if ckpt else []
        if resume:
            extra.append("--resume")
        runs.append(cli(tmp / name, data_dir, epochs, *extra))
    jobs["clis"] = ("clis", dict(runs=[[argv] * 2 for argv in runs]))
    res = run_ranks(tmp, 2, jobs, timeout=600)
    return {"ranks": sorted(res, key=lambda r: r["ops"]["index"]),
            "dir": tmp, "params": params}


def by_path(tree):
    return {"/".join(p): np.asarray(v) for p, v in
            ((tuple(str(getattr(k, "key", k)) for k in path), v) for path, v
             in jax.tree_util.tree_flatten_with_path(tree)[0])}


def assert_rel(got, want, rel, what):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale + 1e-12, what


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------


def toy_apply(p, h):
    return h + gelu(h) @ p["kernel"] + p["bias"]


def jax_toy(stages):
    """JAX's pipeline_apply of the toy layer on ``stages`` pipe devices:
    (y, grads of the (P, L/P, ...) leaves, grad of x)."""
    stacked, x, ct = toy_setup()
    mesh = jax_build_mesh(JaxMeshSpec(data=1, pipe=stages),
                          devices=jax.devices()[:stages])

    def layer(p, h):
        return h + jax.nn.gelu(h) @ p["kernel"] + p["bias"]

    def loss(sp, xx):
        y = jax_pipe.pipeline_apply(layer, sp, xx, mesh, MICRO)
        return (y * ct).sum(), y

    sp = jax_pipe.stack_to_stages(
        {k: jnp.asarray(v) for k, v in stacked.items()}, stages)
    (_, y), (g, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(sp, jnp.asarray(x))
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}, \
        np.asarray(gx)


def port_sequential():
    stacked, x, ct = toy_setup()
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in stacked.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = sequential_apply(toy_apply, params, xt)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                                [xt, params["bias"], params["kernel"]])
    return y.detach().numpy(), grads


def test_pipeline_apply_matches_sequential_and_jax(pool):
    y_ref, g_ref, gx_ref = jax_toy(STAGES)
    y_seq, (gx_seq, gb_seq, gk_seq) = port_sequential()
    np.testing.assert_allclose(y_seq, y_ref, rtol=OUT_TOL, atol=OUT_TOL)
    for r, rank in enumerate(pool["ranks"]):
        got = rank["ops"][str(torch.float32)]
        for want in (y_ref, y_seq):
            np.testing.assert_allclose(got["y"], want, rtol=OUT_TOL,
                                       atol=OUT_TOL)
        # the input's gradient is whole on every stage (summed over pipe)
        assert_rel(got["g_x"], gx_ref, GRAD_REL, "x")
        assert_rel(got["g_x"], gx_seq.numpy(), GRAD_REL, "x")
        for name, seq in (("bias", gb_seq), ("kernel", gk_seq)):
            stage = g_ref[name][r:r + 1]
            assert_rel(got["g"][name], stage, GRAD_REL, name)
            seq_stage = stack_to_stages({name: seq}, STAGES)[name][r:r + 1]
            assert_rel(got["g"][name], seq_stage.numpy(), GRAD_REL, name)
    # both stages hold the same outputs and input gradient, bit for bit
    a, b = (rank["ops"][str(torch.float32)] for rank in pool["ranks"])
    np.testing.assert_array_equal(a["y"], b["y"])
    np.testing.assert_array_equal(a["g_x"], b["g_x"])


def test_pipeline_apply_bf16_near_float32(pool):
    for rank in pool["ranks"]:
        f32, b16 = rank["ops"][str(torch.float32)], \
            rank["ops"][str(torch.bfloat16)]
        assert_rel(b16["y"], f32["y"], BF16_REL, "y")
        assert_rel(b16["g_x"], f32["g_x"], BF16_REL, "x")
        for name in f32["g"]:
            assert_rel(b16["g"][name], f32["g"][name], BF16_REL, name)


def test_one_stage_is_the_plain_loop_over_the_merged_stack():
    y_ref, g_ref, gx_ref = jax_toy(1)
    stacked, x, ct = toy_setup()
    params = {k: torch.from_numpy(v[None]).requires_grad_()
              for k, v in stacked.items()}
    xt = torch.from_numpy(x).requires_grad_()
    for pipe in (None, TpAxis(1)):
        y = pipeline_apply(toy_apply, params, xt, pipe, 4)
        gx, gk = torch.autograd.grad((y * torch.from_numpy(ct)).sum(),
                                     [xt, params["kernel"]])
        np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=OUT_TOL,
                                   atol=OUT_TOL)
        assert_rel(gx.numpy(), gx_ref, GRAD_REL, "x")
        assert_rel(gk.numpy(), g_ref["kernel"], GRAD_REL, "kernel")


def test_stack_to_stages_matches_jax_and_its_message():
    stacked, _, _ = toy_setup()
    ours = stack_to_stages({k: torch.from_numpy(v)
                            for k, v in stacked.items()}, 2)
    want = jax_pipe.stack_to_stages(stacked, 2)
    for k, v in want.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))
    with pytest.raises(ValueError) as ref:
        jax_pipe.stack_to_stages(stacked, 3)
    with pytest.raises(ValueError) as got:
        stack_to_stages({k: torch.from_numpy(v)
                         for k, v in stacked.items()}, 3)
    assert str(got.value) == str(ref.value)


def test_indivisible_microbatches_refused_as_jax():
    x = torch.zeros(6, 4, DIM)
    params = {"kernel": torch.zeros(1, 2, DIM, DIM),
              "bias": torch.zeros(1, 2, DIM)}
    with pytest.raises(ValueError,
                       match="local batch 6 not divisible into 4 "
                             "microbatches"):
        pipeline_apply(toy_apply, params, x, TpAxis(2), 4)


# ---------------------------------------------------------------------------
# the pipelined GPT-2
# ---------------------------------------------------------------------------


def jax_pipe_loss_and_grads(params, ids):
    mesh = jax_build_mesh(JaxMeshSpec(**MESH), devices=jax.devices()[:2])
    model = JaxPipe(mesh=mesh, num_microbatches=MICRO, **TINY)
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

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    logits = jax.jit(model.apply)({"params": params},
                                  jnp.asarray(ids, jnp.int32))
    return float(loss), by_path(jax.device_get(grads)), np.asarray(logits)


def port_sequential_gpt2(params, ids):
    """The port's plain GPT-2 of the same weights: loss, gradients
    (stacked back into the pipelined layout), logits."""
    model = get_model("gpt2_124m", **TINY)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for n, t in pipe_to_gpt2_params(params).items():
            own[n].copy_(t)
    ids_t = torch.from_numpy(ids)
    loss, _, _ = LanguageModelingTask().loss_and_metrics(
        model, {"input_ids": ids_t, "weight": torch.ones(ids.shape[0])},
        True)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(model.parameters()))))
    stacked = gpt2_to_pipe_params(grads, STAGES)
    with torch.no_grad():
        logits = model(ids_t)
    return float(loss), {flax_path(n): g.numpy() for n, g in
                         stacked.items()}, logits.numpy()


def split_dims():
    model = GPT2PipeLMHead(num_stages=STAGES, device="meta", **TINY)
    return {flax_path(n): d for n, d in tp_split_dims(
        list(model.named_parameters()), model.partition_rules(), STAGES,
        PIPE).items()}


def test_tiny_pipelined_gpt2_matches_jax_and_the_sequential_model(pool):
    ids = tiny_ids()
    loss_jax, g_jax, logits_jax = jax_pipe_loss_and_grads(pool["params"],
                                                          ids)
    loss_seq, g_seq, logits_seq = port_sequential_gpt2(pool["params"], ids)
    stages = [rank["model"] for rank in pool["ranks"]]
    sd = split_dims()
    assert sd["blocks/attn/qkv/kernel"] == 0 and sd["wte/embedding"] is None
    for s in stages:
        assert s["loss"] == stages[0]["loss"]
        np.testing.assert_array_equal(s["logits"], stages[0]["logits"])
        for want in (loss_jax, loss_seq):
            np.testing.assert_allclose(s["loss"], want, rtol=LOSS_RTOL)
        for want in (logits_jax, logits_seq):
            np.testing.assert_allclose(s["logits"], want, rtol=OUT_TOL,
                                       atol=OUT_TOL)
    for path, d in sd.items():
        got = (stages[0]["grads"][path] if d is None else
               np.concatenate([s["grads"][path] for s in stages], d))
        if d is None:     # a replicated leaf: the same bits on each stage
            np.testing.assert_array_equal(stages[1]["grads"][path], got)
        for want in (g_jax[path], g_seq[path]):
            assert_rel(got, want, GRAD_REL, path)


def test_one_seed_draws_the_same_weights_as_gpt2():
    kw = dict(TINY, vocab_size=97)
    plain = get_model("gpt2_124m", **kw)
    plain.reset_parameters(torch.Generator().manual_seed(3))
    pipe = GPT2PipeLMHead(num_stages=STAGES, **kw)
    pipe.reset_parameters(torch.Generator().manual_seed(3))
    stacked = gpt2_to_pipe_params(dict(plain.named_parameters()), STAGES)
    for n, p in pipe.named_parameters():
        assert torch.equal(p, stacked[n]), n


def test_carrier_round_trips_are_bitwise(pool):
    params = pool["params"]
    named = flax_to_torch(params)
    # the global stacks <-> a gpt2_* model's blocks
    back = gpt2_to_pipe_params(pipe_to_gpt2_params(named), STAGES)
    assert set(back) == set(named)
    for n, t in named.items():
        assert torch.equal(back[n], t), n
    # the global stacks <-> each stage's (1, L/P, ...) slice
    model = GPT2PipeLMHead(num_stages=STAGES, **TINY)
    load_flax_params(model, params)
    sd = tp_split_dims(list(model.named_parameters()),
                       model.partition_rules(), STAGES, PIPE)
    shards = [tp_local_params(params, sd, STAGES, p) for p in range(STAGES)]
    assert shards[1]["blocks.attn.qkv.kernel"].shape[:2] == (1, 2)
    joined = tp_global_params(shards, sd)
    for n, t in named.items():
        assert torch.equal(joined[n], t), n
    # torch_to_flax of the global model is JAX's tree
    tree = by_path(torch_to_flax(model))
    for path, v in by_path(params).items():
        np.testing.assert_array_equal(tree[path], v)


def test_remat_changes_memory_not_math():
    model = GPT2PipeLMHead(num_stages=STAGES, **TINY)
    model.reset_parameters(torch.Generator().manual_seed(0))
    remat = model.clone(remat=True)
    remat.load_state_dict(model.state_dict())
    ids = torch.from_numpy(tiny_ids())
    batch = {"input_ids": ids, "weight": torch.ones(ids.shape[0])}
    out = []
    for m in (model, remat):
        loss, _, _ = LanguageModelingTask().loss_and_metrics(m, batch, True)
        out.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the Trainer and the entry
# ---------------------------------------------------------------------------


def jax_trainer_run(params, batches, tx, epochs_of=None):
    mesh = jax_build_mesh(JaxMeshSpec(**MESH), devices=jax.devices()[:2])
    model = JaxPipe(mesh=mesh, num_microbatches=MICRO,
                    **(epochs_of or TINY))
    t = JaxTrainer(JaxLMTask(), mesh, JaxTrainConfig(seed=0),
                   rules=JaxPipe.partition_rules())
    s = t.init_state(model, np.zeros((1, model.max_position), np.int32), tx,
                     jax.random.PRNGKey(0))
    s = s.replace(params=jax.tree_util.tree_map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        params, s.params))
    metrics = []
    for b in batches:
        s, m = t._train_step(s, shard_batch(b, mesh), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, by_path(jax.device_get(s.params))


def joined(stages, key, sd):
    return {p: (stages[0][key][p] if d is None else np.concatenate(
        [s[key][p] for s in stages], d)) for p, d in sd.items()}


def test_trainer_adamw_clip_matches_jax(pool):
    tx = jax_adamw(1e-2, grad_clip_norm=1.0, weight_decay=0.01)
    metrics, want = jax_trainer_run(pool["params"], tiny_batches(), tx)
    stages = [rank["train"] for rank in pool["ranks"]]
    sd = split_dims()
    for path, d in sd.items():
        if d is None:
            np.testing.assert_array_equal(stages[1]["params"][path],
                                          stages[0]["params"][path])
    for s in stages:
        assert s["metrics"] == stages[0]["metrics"]
    for ours, ref in zip(stages[0]["metrics"], metrics):
        assert ours["weight"] == ref["weight"]
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    got = joined(stages, "params", sd)
    start = by_path(pool["params"])
    moved = 0.0
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=p)
        moved = max(moved, float(np.abs(w - start[p]).max()))
    assert moved > 10 * PARAM_ATOL


def entry_initial_params():
    """The global weights ``train.main`` draws from ``--seed`` for the
    pipelined model, as a flax tree."""
    model = GPT2PipeLMHead(num_stages=STAGES, **ENTRY_KW)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return torch_to_flax(model)


def entry_batches(data_dir, epochs):
    ds = get_token_dataset("gpt2", ENTRY_SEQ, str(data_dir), train=True,
                           synthetic_size=ENTRY_SYNTHETIC, seed=SEED)
    loader = TokenLoader(ds, 4, shuffle=True, seed=SEED)
    return [{k: v.numpy() for k, v in b.items()}
            for e in range(epochs) for b in loader.epoch(e)]


def entry_stage_state(rank, key):
    return {k[len(key):]: v for k, v in rank.items() if k.startswith(key)}


def test_train_main_matches_jax_trainer(data_dir, pool):
    params = entry_initial_params()
    metrics, want = jax_trainer_run(
        params, entry_batches(data_dir, 2),
        jax_make_optimizer("adamw", LR, weight_decay=5e-4),
        epochs_of=ENTRY_KW)
    runs = [r["clis"][0] for r in pool["ranks"]]
    assert all(r["step"] == len(metrics) for r in runs)
    for ours, ref in zip(runs[0]["metrics"], metrics):
        assert ours["weight"] == ref["weight"] == 4 * (ENTRY_SEQ - 1)
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    model = GPT2PipeLMHead(num_stages=STAGES, device="meta", **ENTRY_KW)
    sd = tp_split_dims(list(model.named_parameters()),
                       model.partition_rules(), STAGES, PIPE)
    states = [entry_stage_state(r["state"], "model/") for r in runs]
    for name, d in sd.items():
        if d is None:
            np.testing.assert_array_equal(states[1][name], states[0][name])
        got = states[0][name] if d is None else np.concatenate(
            [s[name] for s in states], d)
        np.testing.assert_allclose(got, want[flax_path(name)],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


def test_resume_at_the_same_mesh_is_bitwise(pool):
    for rank in pool["ranks"]:
        a, b = rank["clis"][0], rank["clis"][2]
        assert a["step"] == b["step"]
        assert a["state"].keys() == b["state"].keys()
        for key, value in a["state"].items():
            np.testing.assert_array_equal(b["state"][key], value,
                                          err_msg=key)


def test_checkpoint_holds_the_stage_stacks_in_jax_layout(pool):
    d = pool["dir"] / "ckpt"
    labels = sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())
    meta = json.loads((d / str(labels[-1]) / "meta.json").read_text())
    assert meta["mesh"] == MeshSpec(**MESH).resolved(2)
    assert meta["pipe_shards"] == 2 and meta["model_shards"] == 1
    assert meta["param_shapes"]["blocks.attn.qkv.kernel"] == \
        [STAGES, 2, 32, 3, 2, 16]
    params = torch.load(d / str(labels[-1]) / "params.pt",
                        weights_only=True)
    states = [entry_stage_state(r["clis"][2]["state"], "model/")
              for r in pool["ranks"]]
    for name, t in params.items():
        want = (np.concatenate([s[name] for s in states], 0)
                if name.startswith("blocks.") else states[0][name])
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)


def test_restore_at_another_layout_raises_the_layout_hint(pool):
    from distributed_pytorch_training_tpu_torch.training.checkpoint import (
        LAYOUT_HINT, CheckpointManager,
    )

    model = GPT2PipeLMHead(num_stages=STAGES, **ENTRY_KW)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    state = Trainer(LanguageModelingTask(), TrainConfig(),
                    device="cpu").init_state(model,
                                             make_optimizer("adamw", LR))
    mgr = CheckpointManager(str(pool["dir"] / "ckpt"))
    with pytest.raises(ValueError, match=re.escape(LAYOUT_HINT)):
        mgr.restore_latest(state)


# ---------------------------------------------------------------------------
# the loader, attention, FLOPs
# ---------------------------------------------------------------------------


def test_pipe_ranks_of_a_batch_coordinate_read_the_same_rows():
    shape = MeshSpec(data=2, pipe=2).resolved(4)
    ds = synthetic_token_dataset(16, SEQ, VOCAB, seed=0)
    rows = {}
    for r in range(4):
        mesh = Mesh(shape, r)
        loader = TokenLoader(ds, 2, shuffle=True, seed=0,
                             process_index=mesh.batch_index,
                             process_count=2)
        rows[r] = ([b["input_ids"] for b in loader.epoch(0)],
                   mesh.coords()["data"])
    # pipe is outermost: ranks r and r + 2 share a batch coordinate
    for r in (0, 1):
        assert rows[r][1] == rows[r + 2][1]
        assert all(torch.equal(x, y) for x, y in zip(rows[r][0],
                                                     rows[r + 2][0]))
    assert not torch.equal(rows[0][0][0], rows[1][0][0])


def test_auto_attention_is_xla_inside_the_stages():
    # the JAX entry's rule: auto never picks the kernels on a pipe mesh
    assert train.resolve_attention("auto", "cuda", 1024, 2) == "xla"
    assert train.resolve_attention("auto", "cuda", 1024, 1) == "flash"
    assert train.resolve_attention("xla", "cuda", 1024, 2) == "xla"


def test_mfu_counts_the_sequential_model():
    """The pipelined run's MFU reference is the sequential GPT-2's
    forward; the stages' FLOPs on one process are the same products."""
    from distributed_pytorch_training_tpu_torch.experiments import flops

    ids = torch.zeros((2, SEQ), dtype=torch.long)
    seq = flops.matmul_flops(get_model("gpt2_124m", device="meta", **TINY),
                             ids.to("meta"))
    pipe = GPT2PipeLMHead(num_stages=STAGES, **TINY)
    pipe.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert flops.matmul_flops(pipe, ids) == seq > 0


# ---------------------------------------------------------------------------
# refusals (JAX's messages)
# ---------------------------------------------------------------------------


def test_indivisible_depth_refused_as_jax():
    mesh = jax_build_mesh(JaxMeshSpec(data=1, pipe=3),
                          devices=jax.devices()[:3])
    with pytest.raises(ValueError) as ref:
        JaxPipe(mesh=mesh, **TINY).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, SEQ), jnp.int32))
    with pytest.raises(ValueError) as ours:
        GPT2PipeLMHead(num_stages=3, **TINY)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("kw", [dict(), dict(is_moe=True),
                                dict(attention="flash")],
                         ids=["bert", "moe", "unpipelined"])
def test_unpipelined_model_on_pipe_refused_as_jax(kw):
    jax_mesh = jax_build_mesh(JaxMeshSpec(data=1, pipe=2),
                              devices=jax.devices()[:2])
    mesh = Mesh(MeshSpec(data=1, pipe=2).resolved(2), 0)
    with pytest.raises(ValueError) as ref:
        jax_validate_mesh_usage(jax_mesh, **kw)
    with pytest.raises(ValueError) as ours:
        validate_mesh_usage(mesh, **kw)
    assert str(ours.value) == str(ref.value)
    assert "silently waste devices" in str(ours.value)


@pytest.mark.parametrize("config", [dict(zero1=True),
                                    dict(fsdp_explicit=True),
                                    dict(wire_dtype="int8")],
                         ids=["zero1", "fsdp", "reducer"])
def test_update_modes_refused_on_a_pipe_mesh_as_jax(config):
    mesh = Mesh(MeshSpec(data=1, pipe=2).resolved(2), 0)
    jax_mesh = jax_build_mesh(JaxMeshSpec(data=1, pipe=2),
                              devices=jax.devices()[:2])
    with pytest.raises(ValueError) as ref:
        JaxTrainer(JaxLMTask(), jax_mesh, JaxTrainConfig(**config))
    with pytest.raises(ValueError) as ours:
        Trainer(LanguageModelingTask(), TrainConfig(**config),
                device="cpu", mesh=mesh)
    assert str(ours.value) == str(ref.value)


def test_stage_local_model_refuses_its_own_init():
    local = GPT2PipeLMHead(num_stages=2, pipe=TpAxis(2, 1), **TINY)
    with pytest.raises(ValueError, match="one draw"):
        local.reset_parameters(torch.Generator())


@pytest.mark.parametrize("argv,error,match", [
    (["--mesh", "pipe=2", "--attention", "ring"], ValueError,
     "--mesh pipe>1 uses the XLA attention path"),
    (["--mesh", "pipe=2", "--attention", "ulysses"], ValueError,
     "--mesh pipe>1 uses the XLA attention path"),
], ids=["ring", "ulysses"])
def test_entry_refusals(tmp_path, argv, error, match):
    base = ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
            OVERRIDES, "--seq-len", str(ENTRY_SEQ), "--synthetic",
            "--synthetic-size", "8", "--batch-size", "4", "--epochs", "1",
            "--no-telemetry", "--output-dir", str(tmp_path)]
    with pytest.raises(error, match=re.escape(match)):
        train.main(base + argv)
