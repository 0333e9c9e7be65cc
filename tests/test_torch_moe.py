"""The MoE GPT-2 (``gpt2_moe``) with its router loss and expert
parallelism over the mesh's ``expert`` axis, the port against the JAX
package on the CPU.

* ``MoeMlp``, weights carried from flax: the ``sorted`` dispatch against
  the ``einsum`` oracle and each against JAX's, for top_k 1 and 2 and
  under capacity pressure: outputs, the aux loss and the gradients (of
  the input, the router and the experts).
* The capacity ``ceil(S k / E cf)``: JAX's dispatch buffer holds E C + 1
  rows for the port's C.
* A tiny ``gpt2_moe``: the loss (the router loss included, weight 0.01)
  and its gradients against JAX's ``MoeLanguageModelingTask`` under
  ``jax.grad``.
* expert=2 on 2 gloo ranks against expert=1 (the global model in this
  process): each rank holds experts [2r, 2r + 2) of every MoE layer, the
  dense leaves, the router and the embeddings get bitwise-equal
  gradients on both ranks, and the loss, the logits and the gradients
  are BITWISE expert=1's (each token's two shares meet in one add;
  another rank's slots read exact zeros).
* The Trainer, AdamW with the global-norm clip on, 3 steps on
  ``data=1,expert=2`` against the JAX Trainer on the same mesh shape.
* ``train.main`` under 2 gloo ranks, ``--model gpt2_moe --mesh
  expert=2``, against the JAX Trainer from the entry's initial weights
  over the same batches; ``--resume`` at the same mesh bitwise; the
  checkpoint holds JAX's global ``wi``/``wo``.
* The carrier's round trip (the experts cut to a rank's E/ep and joined
  back) bitwise; the FLOPs count equal to JAX's; the refusals.

Determinism: the sorted dispatch writes each kept slot once (only the
discarded overflow bin sums), and each token's gather gradient adds k = 2
terms, which commute; the card's runs of one step are compared bitwise
by ``chip_smoke.py`` phase 25 (b).

Tolerances (float32 reassociation): outputs within OUT_TOL = 1e-5,
gradients within GRAD_REL = 1e-5 of each leaf's largest (the router's
within ROUTER_REL = 1e-4: its gradient is a difference of near-equal
softmax terms), the aux loss within AUX_RTOL = 1e-6; trajectories'
losses within LOSS_RTOL = 2e-5 and parameters within PARAM_RTOL = 2e-2,
PARAM_ATOL = 2e-3 (``tests/test_torch_tp.py``'s bound under AdamW).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.experiments import flops as jflops
from distributed_pytorch_training_tpu.models.moe import (
    GPT2MoELMHead as JaxMoE, MoeMlp as JaxMoeMlp,
)
from distributed_pytorch_training_tpu.parallel import (
    MeshSpec as JaxMeshSpec, build_mesh as jax_build_mesh, shard_batch,
)
from distributed_pytorch_training_tpu.parallel.mesh import (
    validate_mesh_usage as jax_validate_mesh_usage,
)
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig, Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
)
from distributed_pytorch_training_tpu.training.optim import adamw as jax_adamw
from distributed_pytorch_training_tpu.training.tasks import (
    MoeLanguageModelingTask as JaxMoeTask,
)
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import (
    flax_to_torch, load_flax_params, tp_global_params, tp_local_params,
    torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.data.text import (
    TokenLoader, get_token_dataset, synthetic_token_dataset,
)
from distributed_pytorch_training_tpu_torch.experiments import flops
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.models.moe import (
    MoeMlp, expert_capacity,
)
from distributed_pytorch_training_tpu_torch.parallel.collectives import (
    TpAxis,
)
from distributed_pytorch_training_tpu_torch.parallel.mesh import (
    EXPERT, Mesh, MeshSpec, validate_mesh_usage,
)
from distributed_pytorch_training_tpu_torch.parallel.sharding import (
    flax_path, tp_split_dims,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    MoeLanguageModelingTask,
)

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401 (autouse)

OUT_TOL = 1e-5
GRAD_REL = 1e-5
ROUTER_REL = 1e-4
AUX_RTOL = 1e-6
LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-2, 2e-3

SEQ, VOCAB = 16, 64
TINY = dict(vocab_size=VOCAB, hidden_dim=32, depth=4, num_heads=2,
            num_experts=4, max_position=SEQ)
MESH = dict(data=1, expert=2)
ENTRY_SEQ, ENTRY_SYNTHETIC, SEED, LR = 32, 16, 0, 1e-3
ENTRY_KW = dict(vocab_size=50257, hidden_dim=32, depth=4, num_heads=2,
                num_experts=4, max_position=ENTRY_SEQ)
OVERRIDES = ",".join(f"{k}={v}" for k, v in ENTRY_KW.items())


def jax_tiny_params(kw=TINY):
    return jax.device_get(jax.jit(JaxMoE(**kw).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, kw["max_position"]),
                                         jnp.int32))["params"])


def tiny_ids(rows=4):
    return np.random.RandomState(1).randint(
        0, VOCAB, (rows, SEQ)).astype(np.int64)


def tiny_batches(steps=3, rows=4):
    rng = np.random.RandomState(0)
    return [{"input_ids": rng.randint(0, VOCAB, (rows, SEQ)).astype(
                np.int32),
             "weight": np.ones(rows, np.float32)} for _ in range(steps)]


def cli(tmp, data_dir, epochs, *extra):
    return ["--device", "cpu", "--model", "gpt2_moe", "--model-overrides",
            OVERRIDES, "--seq-len", str(ENTRY_SEQ), "--synthetic",
            "--synthetic-size", str(ENTRY_SYNTHETIC), "--data-dir",
            str(data_dir), "--epochs", str(epochs), "--batch-size", "4",
            "--optimizer", "adamw", "--lr", str(LR), "--print-freq",
            "1000", "--no-telemetry", "--seed", str(SEED), "--mesh",
            "expert=2", "--output-dir", str(tmp), *extra]


CLI_RUNS = [("full", 2, None, False), ("part", 1, "ckpt", False),
            ("resumed", 2, "ckpt", True)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("moe_data")


@pytest.fixture(scope="module")
def pool(tmp_path_factory, data_dir):
    tmp = tmp_path_factory.mktemp("expert2")
    params = jax_tiny_params()
    spec = dict(kind="moe", mesh=MESH, params=params, model_kwargs=TINY)
    jobs = {
        "model": ("split_model", dict(spec, ids=tiny_ids())),
        "train": ("split_train", dict(spec, batches=tiny_batches(),
                                      optimizer=("adamw", dict(
                                          grad_clip_norm=1.0,
                                          weight_decay=0.01)), lr=1e-2)),
    }
    runs = []
    for name, epochs, ckpt, resume in CLI_RUNS:
        extra = ["--checkpoint-dir", str(tmp / ckpt)] if ckpt else []
        if resume:
            extra.append("--resume")
        runs.append(cli(tmp / name, data_dir, epochs, *extra))
    jobs["clis"] = ("clis", dict(runs=[[argv] * 2 for argv in runs]))
    res = run_ranks(tmp, 2, jobs, timeout=600)
    return {"ranks": sorted(res, key=lambda r: r["model"]["index"]),
            "dir": tmp, "params": params}


def by_path(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_rel(got, want, rel, what):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale + 1e-12, what


def split_dims(kw=TINY):
    model = get_model("gpt2_moe", device="meta", **kw)
    return {flax_path(n): d for n, d in tp_split_dims(
        list(model.named_parameters()), model.partition_rules(), 2,
        EXPERT).items()}


# ---------------------------------------------------------------------------
# MoeMlp
# ---------------------------------------------------------------------------

MLP_CASES = [("top1", 1, 1.25, 4), ("top2", 2, 1.25, 4),
             ("pressure", 2, 0.4, 2)]


def jax_mlp(mode, k, cf, e, x):
    layer = JaxMoeMlp(num_experts=e, hidden_dim=32, top_k=k,
                      capacity_factor=cf, dispatch_mode=mode)
    params = jax.jit(layer.init)(jax.random.PRNGKey(0), x)["params"]

    def f(p, xx):
        y, mut = layer.apply({"params": p}, xx, mutable=["losses"])
        aux = mut["losses"]["moe_aux"][0]
        return (y ** 2).sum() + aux, (y, aux)

    (_, (y, aux)), (g, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, x)
    return jax.device_get(params), np.asarray(y), float(aux), \
        by_path(jax.device_get(g)), np.asarray(gx)


@pytest.mark.parametrize("name,k,cf,e", MLP_CASES,
                         ids=[c[0] for c in MLP_CASES])
def test_moe_mlp_sorted_and_einsum_match_each_other_and_jax(name, k, cf, e):
    x = np.random.RandomState(5).randn(2, 64, 16).astype(np.float32)
    ours = {}
    for mode in ("sorted", "einsum"):
        params, y_ref, aux_ref, g_ref, gx_ref = jax_mlp(mode, k, cf, e,
                                                        jnp.asarray(x))
        layer = MoeMlp(16, e, 32, top_k=k, capacity_factor=cf,
                       dispatch_mode=mode)
        load_flax_params(layer, params)
        xt = torch.from_numpy(x).requires_grad_()
        y = layer(xt)
        names = [n for n, _ in layer.named_parameters()]
        grads = torch.autograd.grad((y ** 2).sum() + layer.last_aux,
                                    [xt] + list(layer.parameters()))
        np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=OUT_TOL,
                                   atol=OUT_TOL)
        np.testing.assert_allclose(float(layer.last_aux), aux_ref,
                                   rtol=AUX_RTOL)
        assert_rel(grads[0].numpy(), gx_ref, GRAD_REL, "x")
        for n, g in zip(names, grads[1:]):
            path = flax_path(n)
            assert_rel(g.numpy(), g_ref[path],
                       ROUTER_REL if "router" in path else GRAD_REL, path)
        ours[mode] = (y.detach().numpy(), float(layer.last_aux),
                      [g.numpy() for g in grads])
    # the sorted dispatch against its oracle (the same weights: JAX's init
    # does not depend on the mode)
    (ys, auxs, gs), (ye, auxe, ge) = ours["sorted"], ours["einsum"]
    np.testing.assert_allclose(ys, ye, rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(auxs, auxe, rtol=AUX_RTOL)
    for a, b in zip(gs, ge):
        assert_rel(a, b, ROUTER_REL, "grad")


@pytest.mark.parametrize("s,k,e,cf", [(16, 2, 4, 1.25), (64, 2, 2, 0.4),
                                      (1024, 2, 8, 1.25), (7, 1, 3, 1.0),
                                      (4, 1, 16, 1.25)])
def test_capacity_is_jax_buffer(s, k, e, cf):
    cap = expert_capacity(s, k, e, cf)
    assert cap == max(1, int(np.ceil(s * k / e * cf)))
    layer = JaxMoeMlp(num_experts=e, hidden_dim=8, top_k=k,
                      capacity_factor=cf)
    x = jnp.zeros((1, s, 4), jnp.float32)
    params = jax.eval_shape(layer.init, jax.random.PRNGKey(0), x)
    jaxpr = jax.make_jaxpr(lambda p, xx: layer.apply(p, xx))(params, x)
    shapes = {tuple(v.aval.shape) for eqn in jaxpr.jaxpr.eqns
              for v in eqn.outvars}
    assert (1, e * cap + 1, 4) in shapes
    if s == 1024:
        assert cap == 320      # gpt2_moe's at S 1024


def test_router_noise_refused_naming_its_slice():
    with pytest.raises(NotImplementedError, match="the dropout slice"):
        MoeMlp(16, 4, 32, router_noise=0.1)
    with pytest.raises(NotImplementedError, match="router_noise"):
        get_model("gpt2_moe", router_noise=0.5, **TINY)


# ---------------------------------------------------------------------------
# gpt2_moe
# ---------------------------------------------------------------------------


def jax_loss_and_grads(params, ids):
    model = JaxMoE(**TINY)
    task = JaxMoeTask()

    class _State:
        apply_fn = staticmethod(model.apply)
        batch_stats = {}

    def loss_fn(p):
        loss, (m, _) = task.loss_and_metrics(
            _State, p, {"input_ids": jnp.asarray(ids, jnp.int32),
                        "weight": jnp.ones(ids.shape[0])},
            jax.random.PRNGKey(0), train=True)
        return loss, m["loss_sum"]

    (loss, loss_sum), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    logits = jax.jit(model.apply)({"params": params},
                                  jnp.asarray(ids, jnp.int32))
    return float(loss), float(loss_sum), by_path(jax.device_get(grads)), \
        np.asarray(logits)


def port_one_rank(params, ids):
    """expert=1: the global model in this process."""
    model = get_model("gpt2_moe", **TINY)
    load_flax_params(model, params)
    ids_t = torch.from_numpy(ids)
    loss, metrics, _ = MoeLanguageModelingTask().loss_and_metrics(
        model, {"input_ids": ids_t, "weight": torch.ones(ids.shape[0])},
        True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    aux = [float(a) for a in model.aux_losses]
    with torch.no_grad():
        logits = model(ids_t)
    return float(loss), aux, {flax_path(n): g.numpy() for n, g in
                              zip(names, grads)}, logits.numpy()


def test_tiny_gpt2_moe_loss_and_grads_match_jax():
    params = jax_tiny_params()
    ids = tiny_ids()
    loss_ref, _, g_ref, logits_ref = jax_loss_and_grads(params, ids)
    loss, aux, grads, logits = port_one_rank(params, ids)
    assert len(aux) == 2          # MoE on layers 1 and 3
    np.testing.assert_allclose(loss, loss_ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(logits, logits_ref, rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert set(grads) == set(g_ref)
    for path, want in g_ref.items():
        assert_rel(grads[path], want,
                   ROUTER_REL if "router" in path else GRAD_REL, path)


def test_expert2_is_expert1_bitwise(pool):
    params = pool["params"]
    # one thread, as the ranks run: the CPU's GEMMs split their sums by
    # the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss, aux, grads, logits = port_one_rank(params, tiny_ids())
    finally:
        torch.set_num_threads(threads)
    ranks = [r["model"] for r in pool["ranks"]]
    sd = split_dims()
    assert sd["block1/moe/wi"] == 0 and sd["block1/moe/router/kernel"] \
        is None
    for r, rank in enumerate(ranks):
        assert rank["index"] == r
        assert rank["loss"] == loss and rank["aux"] == aux
        np.testing.assert_array_equal(rank["logits"], logits)
        # experts [2r, 2r + 2) of every MoE layer
        assert rank["grads"]["block1/moe/wi"].shape[0] == 2
    for path, d in sd.items():
        if d is None:
            for rank in ranks:
                np.testing.assert_array_equal(rank["grads"][path],
                                              grads[path], err_msg=path)
        else:
            got = np.concatenate([rank["grads"][path] for rank in ranks], d)
            np.testing.assert_array_equal(got, grads[path], err_msg=path)


def test_carrier_round_trip_is_bitwise():
    params = jax_tiny_params()
    named = flax_to_torch(params)
    model = get_model("gpt2_moe", **TINY)
    sd = tp_split_dims(list(model.named_parameters()),
                       model.partition_rules(), 2, EXPERT)
    shards = [tp_local_params(params, sd, 2, r) for r in range(2)]
    for r, shard in enumerate(shards):
        assert torch.equal(shard["blocks.3.moe.wo"],
                           named["blocks.3.moe.wo"][2 * r:2 * r + 2])
        assert torch.equal(shard["blocks.3.moe.router.kernel"],
                           named["blocks.3.moe.router.kernel"])
    joined = tp_global_params(shards, sd)
    for n, t in named.items():
        assert torch.equal(joined[n], t), n
    load_flax_params(model, params)
    tree = by_path(torch_to_flax(model))
    for path, v in by_path(params).items():
        np.testing.assert_array_equal(tree[path], v)


def test_forward_flops_equal_jaxpr_count():
    """The expert products over all E C slots, the router and the dense
    parts: the port's count is JAX's."""
    model = JaxMoE(**TINY)
    x = jnp.zeros((2, SEQ), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)["params"]
    want = jflops.jaxpr_matmul_flops(
        lambda p, ids: model.apply({"params": p}, ids), params, x)
    meta = get_model("gpt2_moe", device="meta", **TINY)
    got = flops.matmul_flops(meta, torch.zeros((2, SEQ), dtype=torch.long,
                                               device="meta"))
    assert got == want > 0
    cap = expert_capacity(SEQ, 2, 4, 1.25)
    dense = get_model("gpt2_124m", device="meta", vocab_size=VOCAB,
                      hidden_dim=32, depth=4, num_heads=2,
                      max_position=SEQ)
    base = flops.matmul_flops(dense, torch.zeros(
        (2, SEQ), dtype=torch.long, device="meta"))
    # in each of the 2 MoE layers, a batch of B = 2: the MLP's two
    # products over E C slots in place of S tokens, and the router's (d,
    # E) product
    b, e, d, h = 2, 4, 32, 128
    per_layer = (2 * 2 * b * e * cap * d * h - 2 * 2 * b * SEQ * d * h
                 + 2 * b * SEQ * d * e)
    assert got == base + 2 * per_layer


# ---------------------------------------------------------------------------
# the Trainer and the entry
# ---------------------------------------------------------------------------


def jax_trainer_run(params, batches, tx, kw=TINY):
    mesh = jax_build_mesh(JaxMeshSpec(**MESH), devices=jax.devices()[:2])
    t = JaxTrainer(JaxMoeTask(), mesh, JaxTrainConfig(seed=0),
                   rules=JaxMoE.partition_rules())
    s = t.init_state(JaxMoE(**kw), np.zeros((1, kw["max_position"]),
                                            np.int32), tx,
                     jax.random.PRNGKey(0))
    s = s.replace(params=jax.tree_util.tree_map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        params, s.params))
    metrics = []
    for b in batches:
        s, m = t._train_step(s, shard_batch(b, mesh), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, by_path(jax.device_get(s.params))


def test_trainer_adamw_clip_matches_jax(pool):
    tx = jax_adamw(1e-2, grad_clip_norm=1.0, weight_decay=0.01)
    metrics, want = jax_trainer_run(pool["params"], tiny_batches(), tx)
    ranks = [r["train"] for r in pool["ranks"]]
    sd = split_dims()
    for path, d in sd.items():
        if d is None:
            np.testing.assert_array_equal(ranks[1]["params"][path],
                                          ranks[0]["params"][path])
    for ours, ref in zip(ranks[0]["metrics"], metrics):
        assert ours["weight"] == ref["weight"]
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    start = by_path(pool["params"])
    moved = 0.0
    for p, w in want.items():
        d = sd[p]
        got = ranks[0]["params"][p] if d is None else np.concatenate(
            [r["params"][p] for r in ranks], d)
        np.testing.assert_allclose(got, w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=p)
        moved = max(moved, float(np.abs(w - start[p]).max()))
    assert moved > 10 * PARAM_ATOL


def entry_initial_params():
    model = get_model("gpt2_moe", **ENTRY_KW)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return torch_to_flax(model)


def entry_batches(data_dir, epochs):
    ds = get_token_dataset("gpt2", ENTRY_SEQ, str(data_dir), train=True,
                           synthetic_size=ENTRY_SYNTHETIC, seed=SEED)
    loader = TokenLoader(ds, 4, shuffle=True, seed=SEED)
    return [{k: v.numpy() for k, v in b.items()}
            for e in range(epochs) for b in loader.epoch(e)]


def model_state(rank_state):
    return {k[len("model/"):]: v for k, v in rank_state.items()
            if k.startswith("model/")}


def test_train_main_matches_jax_trainer(data_dir, pool):
    metrics, want = jax_trainer_run(
        entry_initial_params(), entry_batches(data_dir, 2),
        jax_make_optimizer("adamw", LR, weight_decay=5e-4), ENTRY_KW)
    runs = [r["clis"][0] for r in pool["ranks"]]
    assert all(r["step"] == len(metrics) for r in runs)
    for ours, ref in zip(runs[0]["metrics"], metrics):
        assert ours["weight"] == ref["weight"] == 4 * (ENTRY_SEQ - 1)
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    sd = split_dims(ENTRY_KW)
    states = [model_state(r["state"]) for r in runs]
    for name in states[0]:
        d = sd[flax_path(name)]
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
        for key, value in a["state"].items():
            np.testing.assert_array_equal(b["state"][key], value,
                                          err_msg=key)


def test_checkpoint_holds_the_global_experts(pool):
    d = pool["dir"] / "ckpt"
    labels = sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())
    meta = json.loads((d / str(labels[-1]) / "meta.json").read_text())
    assert meta["mesh"] == MeshSpec(**MESH).resolved(2)
    assert meta["expert_shards"] == 2 and meta["pipe_shards"] == 1
    assert meta["param_shapes"]["blocks.1.moe.wi"] == [4, 32, 128]
    params = torch.load(d / str(labels[-1]) / "params.pt",
                        weights_only=True)
    states = [model_state(r["clis"][2]["state"]) for r in pool["ranks"]]
    for name, t in params.items():
        want = (np.concatenate([s[name] for s in states], 0)
                if name.endswith(("moe.wi", "moe.wo")) else states[0][name])
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)


def test_restore_at_another_layout_raises_the_layout_hint(pool):
    """The expert=2 checkpoint restored into an expert=1 state: the JAX
    entry's hint, not a shape error."""
    import re

    from distributed_pytorch_training_tpu_torch.training import (
        TrainConfig, Trainer, make_optimizer,
    )
    from distributed_pytorch_training_tpu_torch.training.checkpoint import (
        LAYOUT_HINT, CheckpointManager,
    )

    model = get_model("gpt2_moe", **ENTRY_KW)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    state = Trainer(MoeLanguageModelingTask(), TrainConfig(),
                    device="cpu").init_state(model,
                                             make_optimizer("adamw", LR))
    mgr = CheckpointManager(str(pool["dir"] / "ckpt"))
    with pytest.raises(ValueError, match=re.escape(LAYOUT_HINT)):
        mgr.restore_latest(state)


# ---------------------------------------------------------------------------
# the loader, refusals
# ---------------------------------------------------------------------------


def test_expert_ranks_of_a_batch_coordinate_read_the_same_rows():
    shape = MeshSpec(data=2, expert=2).resolved(4)
    ds = synthetic_token_dataset(16, SEQ, VOCAB, seed=0)
    rows = {}
    for r in range(4):
        mesh = Mesh(shape, r)
        loader = TokenLoader(ds, 2, shuffle=True, seed=0,
                             process_index=mesh.batch_index,
                             process_count=2)
        rows[r] = [b["input_ids"] for b in loader.epoch(0)]
    # expert is inside data: ranks 2b and 2b + 1 share batch coordinate b
    for r in (0, 2):
        assert all(torch.equal(x, y) for x, y in zip(rows[r], rows[r + 1]))
    assert not torch.equal(rows[0][0], rows[2][0])


@pytest.mark.parametrize("kw", [dict(), dict(attention="flash")],
                         ids=["dense", "flash"])
def test_dense_model_on_expert_refused_as_jax(kw):
    jax_mesh = jax_build_mesh(JaxMeshSpec(data=1, expert=2),
                              devices=jax.devices()[:2])
    mesh = Mesh(MeshSpec(data=1, expert=2).resolved(2), 0)
    with pytest.raises(ValueError) as ref:
        jax_validate_mesh_usage(jax_mesh, **kw)
    with pytest.raises(ValueError) as ours:
        validate_mesh_usage(mesh, **kw)
    assert str(ours.value) == str(ref.value)
    assert "has no MoE layers" in str(ours.value)


@pytest.mark.parametrize("argv,error,match", [
    (["--mesh", "model=2,expert=2"], NotImplementedError,
     "the expert x model slice"),
    (["--mesh", "fsdp=2,seq=2", "--attention", "ring"], NotImplementedError,
     "a later slice of the fsdp axis"),
    (["--model-overrides", OVERRIDES + ",router_noise=0.1"],
     NotImplementedError, "the dropout slice"),
], ids=["model", "seq", "router-noise"])
def test_entry_refuses_what_waits_naming_its_slice(tmp_path, argv, error,
                                                   match):
    base = ["--device", "cpu", "--model", "gpt2_moe", "--model-overrides",
            OVERRIDES, "--seq-len", str(ENTRY_SEQ), "--synthetic",
            "--synthetic-size", "8", "--batch-size", "4", "--epochs", "1",
            "--no-telemetry", "--output-dir", str(tmp_path)]
    with pytest.raises(error, match=match):
        train.main(base + argv)


def test_expert_local_model_refuses_its_own_init():
    local = get_model("gpt2_moe", expert=TpAxis(2, 1), **TINY)
    assert local.blocks[1].moe.wi.shape[0] == 2
    with pytest.raises(ValueError, match="one draw"):
        local.reset_parameters(torch.Generator())


def test_moe_params_at_full_width():
    """gpt2_moe at its registered width: 322,634,496 parameters, of which
    each MoE block's wi and wo hold 37,748,736; a rank of expert=2 holds
    209,388,288."""
    model = get_model("gpt2_moe", device="meta")
    total = sum(p.numel() for p in model.parameters())
    assert total == 322_634_496
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if n.endswith(("moe.wi", "moe.wo")))
    assert experts == 6 * 37_748_736
    assert total - experts // 2 == 209_388_288
    assert math.ceil(1024 * 2 / 8 * 1.25) == 320
