"""The mesh's ``fsdp`` axis (GSPMD's d_model sharding), the port against
the JAX package on the CPU: GPT-2's leaves that ``tp_fsdp_rules`` place
on ``fsdp`` held as their 1/F slice and gathered on use, alone
(``data=2,fsdp=2``) and with tensor parallelism (``fsdp=2,model=2``).

* The layout: ``fsdp_split_dims`` against the dims the JAX Trainer's
  state shards on ``fsdp`` (its GSPMD placement, JAX's ``feasible_spec``
  included, its warning's text for an indivisible dim); the slice a
  rank restores of a global array (``CheckpointManager._localize``: its
  model slice cut again along the fsdp dim), joined back, bitwise.
* The Trainer, 3 steps on 4 gloo ranks from flax weights, AdamW with the
  global-norm clip and SGD with momentum: every step's loss against the
  JAX Trainer's on the same mesh (the GSPMD step), the final global
  parameters against JAX's; every fsdp-split leaf and each of its
  moments 1/F a rank at rest (1/(F M) for a TP-split one).
* ``train.main`` on 4 ranks, ``--mesh data=2,fsdp=2``: a run stopped
  after one epoch and ``--resume``d at fsdp=2 ends bitwise the
  uninterrupted run, and its checkpoint holds the global arrays;
  ResNet-18 (rules that never use ``fsdp``) on ``data=2,fsdp=2``, with
  JAX's warning, is bitwise the ``data=4`` run: plain data parallelism.
* The refusals with the JAX Trainer's messages: ZeRO-1,
  ``--fsdp-explicit`` and the explicit reducer when the rules shard
  parameters over ``fsdp``.

The ranks are ``tests/_torch_dp_worker.py`` processes: one module-scoped
run of 4 serves every leg.

Tolerances: losses within LOSS_RTOL = 2e-5 (JAX's own
``test_fsdp_matches_replicated_math``), parameters within PARAM_RTOL =
2e-2, PARAM_ATOL = 2e-3 under AdamW (as ``test_torch_tp.py``: Adam's
normalized step turns a gradient's last-bit difference near zero into a
visible one) and SGD_ATOL = SGD_RTOL = 1e-5 under SGD.
"""

import logging
import math
from types import SimpleNamespace

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
    sharding as jax_sharding,
)
from distributed_pytorch_training_tpu.parallel.mesh import (
    validate_mesh_usage as jax_validate_mesh_usage,
)
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig, Trainer as JaxTrainer,
)
from distributed_pytorch_training_tpu.training.optim import (
    adamw as jax_adamw, sgd as jax_sgd,
)
from distributed_pytorch_training_tpu.training.tasks import (
    LanguageModelingTask as JaxLMTask,
)
from distributed_pytorch_training_tpu_torch.convert import (
    tp_global_params,
)
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.models.gpt2 import GPT2LMHead
from distributed_pytorch_training_tpu_torch.parallel.collectives import (
    TpAxis,
)
from distributed_pytorch_training_tpu_torch.parallel.mesh import (
    Mesh, MeshSpec, validate_mesh_usage,
)
from distributed_pytorch_training_tpu_torch.parallel.sharding import (
    flax_path, fsdp_split_dims, reset_degradation_warnings, tp_split_dims,
)
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig, Trainer,
)
from distributed_pytorch_training_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    LanguageModelingTask,
)

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401 (autouse)

LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-2, 2e-3
SGD_ATOL = SGD_RTOL = 1e-5

SEQ, VOCAB = 16, 64
TINY = dict(vocab_size=VOCAB, hidden_dim=32, depth=2, num_heads=4,
            max_position=SEQ)
# name -> (mesh, optimizer)
RUNS = {
    "d2f2 adamw": (dict(data=2, fsdp=2), "adamw"),
    "d2f2 sgd": (dict(data=2, fsdp=2), "sgd"),
    "f2m2 adamw": (dict(fsdp=2, model=2), "adamw"),
}
# a clip that engages: the tiny model's gradient norm is about 0.9 at the
# draw, so the clip's fsdp (and model) weights and group scale the update
CLIP_NORM = 0.25
OPTIMIZERS = {"adamw": ("adamw", dict(grad_clip_norm=CLIP_NORM,
                                      weight_decay=0.01)),
              "sgd": ("sgd", dict(momentum=0.9, weight_decay=5e-4))}
LR = {"adamw": 1e-2, "sgd": 0.05}

# train.main: GPT-2's vocab (the synthetic corpus's ids), 16 sequences,
# 2 rows a batch shard: 2 steps an epoch
ENTRY_SEQ, SEED = 32, 0
OVERRIDES = "vocab_size=50257,hidden_dim=32,depth=2,num_heads=2," \
    f"max_position={ENTRY_SEQ}"


def jax_tiny_params():
    return jax.device_get(JaxGPT2(**TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((2, SEQ), jnp.int32))["params"])


def tiny_batches(steps=3, rows=8):
    rng = np.random.RandomState(0)
    return [{"input_ids": rng.randint(0, VOCAB, (rows, SEQ)).astype(
                np.int32),
             "weight": np.ones(rows, np.float32)} for _ in range(steps)]


def gpt2_cli(tmp, data_dir, epochs, *extra):
    return ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
            OVERRIDES, "--seq-len", str(ENTRY_SEQ), "--synthetic",
            "--synthetic-size", "16", "--data-dir", str(data_dir),
            "--epochs", str(epochs), "--batch-size", "2", "--optimizer",
            "adamw", "--lr", "1e-3", "--print-freq", "1000",
            "--no-telemetry", "--seed", str(SEED), "--mesh", "data=2,fsdp=2",
            "--output-dir", str(tmp), *extra]


def resnet_cli(tmp, data_dir, mesh):
    return ["--device", "cpu", "--model", "resnet18", "--model-overrides",
            "num_filters=8", "--synthetic", "--synthetic-size", "32",
            "--data-dir", str(data_dir), "--epochs", "1", "--batch-size",
            "4", "--print-freq", "1000", "--no-telemetry", "--seed",
            str(SEED), "--mesh", mesh, "--output-dir", str(tmp)]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp4")
    data_dir = tmp / "data"
    params = jax_tiny_params()
    jobs = {}
    for name, (mesh, opt) in RUNS.items():
        jobs[name] = ("mesh_train", dict(
            mesh=mesh, params=params, model_kwargs=TINY,
            batches=tiny_batches(), config={}, optimizer=OPTIMIZERS[opt],
            lr=LR[opt]))
    runs = [gpt2_cli(tmp / "full", data_dir, 2),
            gpt2_cli(tmp / "part", data_dir, 1, "--checkpoint-dir",
                     str(tmp / "ckpt")),
            gpt2_cli(tmp / "part", data_dir, 2, "--checkpoint-dir",
                     str(tmp / "ckpt"), "--resume"),
            resnet_cli(tmp / "rn_fsdp", data_dir, "data=2,fsdp=2"),
            resnet_cli(tmp / "rn_data", data_dir, "data=4")]
    jobs["clis"] = ("clis", dict(runs=[[argv] * 4 for argv in runs]))
    res = run_ranks(tmp, 4, jobs, timeout=600)
    return {"ranks": res, "dir": tmp, "params": params}


def jax_run(devices, mesh_kw, opt, params):
    """(per-step metrics, final params by flax path, the state's fsdp
    dims by flax path) of the JAX Trainer's GSPMD step on ``mesh_kw``."""
    n = math.prod(mesh_kw.values())
    mesh = jax_build_mesh(JaxMeshSpec(**mesh_kw), devices=devices[:n])
    tx = (jax_adamw(LR[opt], grad_clip_norm=CLIP_NORM, weight_decay=0.01)
          if opt == "adamw" else jax_sgd(LR[opt], momentum=0.9,
                                         weight_decay=5e-4))
    t = JaxTrainer(JaxLMTask(), mesh, JaxTrainConfig(seed=0),
                   rules=JaxGPT2.partition_rules())
    s = t.init_state(JaxGPT2(**TINY), np.zeros((1, SEQ), np.int32), tx,
                     jax.random.PRNGKey(0))
    s = s.replace(params=jax.tree_util.tree_map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        params, s.params))
    dims = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(s.params)[0]:
        spec = tuple(leaf.sharding.spec)
        dims["/".join(k.key for k in path)] = next(
            (i for i, e in enumerate(spec) if e is not None
             and "fsdp" in ((e,) if isinstance(e, str) else e)), None)
    metrics = []
    for b in tiny_batches():
        s, m = t._train_step(s, shard_batch(b, mesh), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, by_path(jax.device_get(s.params)), dims


def by_path(tree):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_template(kw=TINY):
    return [(n, tuple(p.shape)) for n, p in
            get_model("gpt2_124m", device="meta", **kw).named_parameters()]


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", ["d2f2 adamw", "f2m2 adamw"])
def test_fsdp_dims_are_the_jax_states_placement(devices, pool, run):
    mesh_kw, opt = RUNS[run]
    _, _, want = jax_run(devices, mesh_kw, opt, pool["params"])
    got = pool["ranks"][0][run]["fsdp"]
    assert got == want
    # GPT-2's kernels and embeddings: every one a d_model dim
    assert sum(d is not None for d in got.values()) == 10


@pytest.mark.parametrize("hidden,f", [(32, 2), (32, 4), (30, 4)])
def test_fsdp_split_dims_follow_jax_feasible_spec(caplog, hidden, f):
    """The fsdp dim of each leaf from ``feasible_spec`` on the global
    shape: an indivisible d_model (30 over 4) leaves every leaf whole,
    with JAX's warning text."""
    kw = dict(TINY, hidden_dim=hidden, num_heads=2)
    tmpl = port_template(kw)
    mesh = jax_build_mesh(JaxMeshSpec(data=8 // f, fsdp=f),
                          devices=jax.devices())
    rules = JaxGPT2.partition_rules()
    reset_degradation_warnings()
    jax_sharding._degraded_warned.clear()
    with caplog.at_level(logging.WARNING):
        dims = fsdp_split_dims(tmpl, GPT2LMHead.partition_rules(), f)
    ours = sorted(r.getMessage() for r in caplog.records
                  if "infeasible" in r.getMessage())
    caplog.clear()
    want = {}
    with caplog.at_level(logging.WARNING):
        for name, shape in tmpl:
            spec = jax_sharding.feasible_spec(
                jax_sharding.spec_for_path(rules, flax_path(name),
                                           len(shape)), shape, mesh)
            want[name] = next((i for i, e in enumerate(spec)
                               if e == "fsdp"), None)
    theirs = sorted(r.getMessage() for r in caplog.records
                    if "infeasible" in r.getMessage())
    assert dims == want
    assert ours == theirs
    assert bool(ours) == (hidden % f != 0)


def test_carrier_round_trip_is_bitwise():
    model = get_model("gpt2_124m", **TINY)
    model.reset_parameters(torch.Generator().manual_seed(0))
    full = dict(model.named_parameters())
    tmpl = port_template()
    tp_dims = tp_split_dims(tmpl, GPT2LMHead.partition_rules(), 2)
    fs_dims = fsdp_split_dims(tmpl, GPT2LMHead.partition_rules(), 2, 2)
    shards = [[{name: CheckpointManager._localize(
        SimpleNamespace(tp=SimpleNamespace(axis=TpAxis(2, m)),
                        fsdp=SimpleNamespace(axis=TpAxis(2, f))),
        t.detach(), (tp_dims[name], fs_dims[name]))
        for name, t in full.items()} for f in range(2)] for m in range(2)]
    qkv = shards[1][0]["blocks.0.attn.qkv.kernel"]
    assert tuple(qkv.shape) == (16, 3, 2, 8)
    back = tp_global_params([tp_global_params(row, fs_dims)
                             for row in shards], tp_dims)
    for name, t in full.items():
        torch.testing.assert_close(back[name], t.detach(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_matches_jax(devices, pool, run):
    mesh_kw, opt = RUNS[run]
    metrics, want, _ = jax_run(devices, mesh_kw, opt, pool["params"])
    ranks = [r[run] for r in pool["ranks"]]
    for m_ours, m_ref in zip(ranks[0]["metrics"], metrics):
        assert m_ours["weight"] == m_ref["weight"]
        np.testing.assert_allclose(m_ours["loss_sum"], m_ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    rtol, atol = ((PARAM_RTOL, PARAM_ATOL) if opt == "adamw"
                  else (SGD_RTOL, SGD_ATOL))
    start = by_path(pool["params"])
    moved = 0.0
    for path, w in want.items():
        got = ranks[0]["params"][path]
        for other in ranks[1:]:      # every rank joins the same arrays
            np.testing.assert_array_equal(other["params"][path], got)
        np.testing.assert_allclose(got, w, rtol=rtol, atol=atol,
                                   err_msg=path)
        moved = max(moved, float(np.abs(w - start[path]).max()))
    assert moved > 10 * atol


@pytest.mark.parametrize("run", list(RUNS))
def test_fsdp_leaves_and_moments_are_one_slice_at_rest(pool, run):
    mesh_kw, opt = RUNS[run]
    f, m = mesh_kw.get("fsdp", 1), mesh_kw.get("model", 1)
    tmpl = {flax_path(n): math.prod(s) for n, s in port_template()}
    tp = {flax_path(n): d for n, d in tp_split_dims(
        port_template(), GPT2LMHead.partition_rules(), m).items()}
    for r in pool["ranks"]:
        out = r[run]
        for path, d in out["fsdp"].items():
            want = tmpl[path] // ((f if d is not None else 1)
                                  * (m if tp[path] is not None else 1))
            assert out["at_rest"]["params"][path] == want, path
            moments = out["at_rest"]["opt"][path]
            assert moments == [want] * (2 if opt == "adamw" else 1), path


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------


def model_state(rank):
    return {k: v for k, v in rank["state"].items() if k.startswith("model/")}


def test_resume_at_fsdp2_is_bitwise(pool):
    for r in pool["ranks"]:
        full, resumed = r["clis"][0], r["clis"][2]
        assert full["step"] == resumed["step"] == 4
        for k, v in full["state"].items():
            np.testing.assert_array_equal(resumed["state"][k], v, err_msg=k)


def test_checkpoint_holds_the_global_arrays(pool):
    ckpt = CheckpointManager(str(pool["dir"] / "ckpt"))
    meta = ckpt.metadata()
    params = ckpt._load(ckpt.all_steps()[-1], "params")
    opt = ckpt._load(ckpt.all_steps()[-1], "opt_state")
    ckpt.close()
    assert meta["layout"] == "replicated"
    assert meta["mesh"] == MeshSpec(data=2, fsdp=2).resolved(4)
    kw = dict(vocab_size=50257, hidden_dim=32, depth=2, num_heads=2,
              max_position=ENTRY_SEQ)
    for name, shape in port_template(kw):
        assert list(params[name].shape) == list(shape)
        assert meta["param_shapes"][name] == list(shape)
    # every moment of the global leaf's shape
    shapes = sorted(tuple(s) for _, s in port_template(kw))
    for slot in ("exp_avg", "exp_avg_sq"):
        got = sorted(tuple(v[slot].shape) for v in opt["state"].values())
        assert got == shapes


def test_resnet_on_fsdp_runs_as_data_parallelism(pool, caplog):
    """ResNet's rules never use fsdp: JAX's warning, and the run is the
    data=4 run bit for bit."""
    jmesh = jax_build_mesh(JaxMeshSpec(data=2, fsdp=2),
                           devices=jax.devices()[:4])
    with caplog.at_level(logging.WARNING):
        jax_validate_mesh_usage(jmesh, rules=None)
        validate_mesh_usage(Mesh(MeshSpec(data=2, fsdp=2).resolved(4), 0),
                            rules=None)
    msgs = [r.getMessage() for r in caplog.records
            if "running as plain data parallelism" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1]
    for r in pool["ranks"]:
        a, b = model_state(r["clis"][3]), model_state(r["clis"][4])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("config", [dict(zero1=True),
                                    dict(fsdp_explicit=True),
                                    dict(wire_dtype="int8")],
                         ids=["zero1", "fsdp-explicit", "int8-wire"])
def test_replicated_modes_refused_on_fsdp_rules_as_jax(devices, config):
    rules = JaxGPT2.partition_rules()
    with pytest.raises(ValueError) as ref:
        JaxTrainer(JaxLMTask(), jax_build_mesh(
            JaxMeshSpec(data=1, fsdp=2), devices=devices[:2]),
            JaxTrainConfig(**config), rules=rules)
    with pytest.raises(ValueError) as ours:
        Trainer(LanguageModelingTask(), TrainConfig(**config), device="cpu",
                mesh=Mesh(MeshSpec(data=1, fsdp=2).resolved(2), 0),
                rules=GPT2LMHead.partition_rules())
    assert str(ours.value) == str(ref.value)
    assert "fsdp" in str(ours.value)
