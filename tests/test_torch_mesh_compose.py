"""The mesh's compositions, the port against the JAX Trainer on the CPU:
ZeRO-1 on a model mesh (JAX's ``_zero1_gspmd_apply``), sequence x tensor
parallelism (ring and Ulysses on each model rank's heads), and gpt2_moe
on ``model`` and on ``seq``.

* ZeRO-1 x TP at ``data=2,model=2``, AdamW with the global-norm clip, 3
  steps from flax weights: the losses and final parameters against the
  port's own replicated TP update (the same gradient, the update sharded
  elementwise: within ZERO1_REL) and against the JAX Trainer's, the clip
  engaged at every step (``CLIP_NORM``); the moments 1/N of each
  TP-local leaf a rank; a compressed wire, and a ``seq`` axis, refused
  with JAX's messages. Through ``train.main``: a run stopped after one
  epoch and ``--resume``d ends bitwise the uninterrupted run, and the
  checkpoint's moments are JAX's layout (each global leaf flat-padded
  over the batch ranks, the JAX zero1 state's shapes).
* SP x TP at ``data=2,seq=2,model=2`` (8 ranks), ring and Ulysses: the
  logits of every rank's rows, positions and vocab columns, gathered,
  against the unsharded JAX model within LOGIT_RTOL = LOGIT_ATOL = 2e-4
  (JAX's ``test_seq_parallel_attention_logits_match``), and a 3-step
  trajectory against the JAX Trainer on the same mesh.
* gpt2_moe at ``data=2,model=2`` and at ``data=2,seq=2`` (ring): every
  step's loss and aux losses against the JAX Trainer's (the aux losses
  of the JAX model at each step's parameters on the global batch: means
  over the global batch); at seq=2 the dispatch of the first step (each
  assignment's expert slot, the dropped ones in the overflow bin) is
  bitwise the unsharded model's, and one MoE layer over 2 seq ranks is
  bitwise the unsharded layer (output, input gradient, dispatch).

Tolerances: losses within LOSS_RTOL = 2e-5, parameters within
PARAM_RTOL = 2e-2, PARAM_ATOL = 2e-3 under AdamW (as
``test_torch_tp.py``), aux losses within AUX_RTOL = 1e-5, ZeRO-1 against
the replicated update within ZERO1_REL = 1e-5 of each leaf's largest
value (the clip's norm summed in another order), but the key bias (the
k part of every ``qkv.bias``) within PARAM_ATOL: its gradient is zero up
to rounding (softmax is invariant to a per-query shift), and Adam's
normalized step turns the clip's last-bit difference into an lr-sized
one there.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models.gpt2 import (
    GPT2LMHead as JaxGPT2,
)
from distributed_pytorch_training_tpu.models.moe import (
    GPT2MoELMHead as JaxMoE,
)
from distributed_pytorch_training_tpu.ops.ring_attention import (
    make_ring_attention_fn as jax_make_ring_attention_fn,
)
from distributed_pytorch_training_tpu.ops.ulysses_attention import (
    make_ulysses_attention_fn as jax_make_ulysses_attention_fn,
)
from distributed_pytorch_training_tpu.parallel import (
    MeshSpec as JaxMeshSpec, build_mesh as jax_build_mesh, shard_batch,
)
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig, Trainer as JaxTrainer,
)
from distributed_pytorch_training_tpu.training.optim import (
    adamw as jax_adamw,
)
from distributed_pytorch_training_tpu.training.tasks import (
    LanguageModelingTask as JaxLMTask,
    MoeLanguageModelingTask as JaxMoeTask,
)
from distributed_pytorch_training_tpu_torch.convert import load_flax_params
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.models.moe import MoeMlp
from distributed_pytorch_training_tpu_torch.training.checkpoint import (
    CheckpointManager,
)

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401 (autouse)

LOSS_RTOL = 2e-5
# the k part of a (3, H, D) qkv.bias
KEY_BIAS = 1
PARAM_RTOL, PARAM_ATOL = 2e-2, 2e-3
AUX_RTOL = 1e-5
ZERO1_REL = 1e-5
LOGIT_RTOL = LOGIT_ATOL = 2e-4

SEQ, VOCAB = 16, 64
TINY = dict(vocab_size=VOCAB, hidden_dim=32, depth=2, num_heads=4,
            max_position=SEQ)
TINY_MOE = dict(vocab_size=VOCAB, hidden_dim=32, depth=2, num_heads=4,
                num_experts=4, max_position=SEQ)
# a clip that engages: the tiny model's gradient norm is about 0.9 at the
# draw, so every clip group (model, seq, the ZeRO-1 chunks' batch line)
# scales the update
CLIP_NORM = 0.25
CLIP = ("adamw", dict(grad_clip_norm=CLIP_NORM, weight_decay=0.01))
LR = 1e-2
MESH_DM = dict(data=2, model=2)
MESH_DS = dict(data=2, seq=2)
MESH_DSM = dict(data=2, seq=2, model=2)

# (name, model, mesh, config, attention)
RUNS4 = [("zero1 tp", "gpt2_124m", MESH_DM, dict(zero1=True), None),
         ("tp", "gpt2_124m", MESH_DM, {}, None),
         ("moe tp", "gpt2_moe", MESH_DM, {}, None),
         ("moe sp", "gpt2_moe", MESH_DS, {}, "ring")]
RUNS8 = [("sp tp ring", "ring"), ("sp tp ulysses", "ulysses")]

ENTRY_SEQ, SEED = 32, 0
OVERRIDES = "vocab_size=50257,hidden_dim=32,depth=2,num_heads=2," \
    f"max_position={ENTRY_SEQ}"


def jax_params(model):
    cls, kw = (JaxMoE, TINY_MOE) if model == "gpt2_moe" else (JaxGPT2, TINY)
    return jax.device_get(jax.jit(cls(**kw).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, SEQ), jnp.int32))["params"])


def tiny_batches(steps=3, rows=8):
    rng = np.random.RandomState(0)
    return [{"input_ids": rng.randint(0, VOCAB, (rows, SEQ)).astype(
                np.int32),
             "weight": np.ones(rows, np.float32)} for _ in range(steps)]


def by_path(tree):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def cli(tmp, data_dir, epochs, *extra, model="gpt2_124m"):
    """The entry's command line (``--mesh`` and the mode in ``extra``)."""
    overrides = OVERRIDES + (",num_experts=4" if model == "gpt2_moe"
                             else "")
    return ["--device", "cpu", "--model", model, "--model-overrides",
            overrides, "--seq-len", str(ENTRY_SEQ), "--synthetic",
            "--synthetic-size", "16", "--data-dir", str(data_dir),
            "--epochs", str(epochs), "--batch-size", "2", "--optimizer",
            "adamw", "--lr", "1e-3", "--print-freq", "1000",
            "--no-telemetry", "--seed", str(SEED), "--output-dir", str(tmp),
            *extra]


ZERO1 = ["--mesh", "data=2,model=2", "--zero1"]
# the entry at the meshes the Trainer tests hold to JAX, each held to a
# run over the same global batches: fsdp=2,model=2 to the ZeRO-1 run
# (same rows, bitwise the replicated update), seq=2,model=2 under the
# ring (GPT-2 and gpt2_moe) to one process (the vocab padded as at
# model=2)
ENTRY_MESHES = {
    "fsdp model": ("gpt2_124m", ["--mesh", "fsdp=2,model=2"]),
    "sp tp": ("gpt2_124m", ["--mesh", "seq=2,model=2", "--attention",
                            "ring"]),
    "moe sp tp": ("gpt2_moe", ["--mesh", "seq=2,model=2", "--attention",
                               "ring"]),
}


def layer_spec():
    rng = np.random.RandomState(4)
    layer = dict(features=16, num_experts=4, hidden_dim=32, top_k=2,
                 capacity_factor=1.0)
    ref = MoeMlp(**layer)
    ref.router.reset_parameters(torch.Generator().manual_seed(1))
    ref.reset_parameters(torch.Generator().manual_seed(2))
    return dict(mesh=MESH_DS, layer=layer,
                params={n: p.detach().numpy().copy()
                        for n, p in ref.named_parameters()},
                x=rng.randn(2, SEQ, 16).astype(np.float32),
                g=rng.randn(2, SEQ, 16).astype(np.float32))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compose4")
    params = {m: jax_params(m) for m in ("gpt2_124m", "gpt2_moe")}
    jobs = {}
    for name, model, mesh, config, attention in RUNS4:
        jobs[name] = ("mesh_train", dict(
            mesh=mesh, model=model, params=params[model],
            model_kwargs=TINY_MOE if model == "gpt2_moe" else TINY,
            attention=attention, batches=tiny_batches(), config=config,
            optimizer=CLIP, lr=LR))
    jobs["zero1 int8"] = ("mesh_train", dict(
        jobs["zero1 tp"][1], config=dict(zero1=True, wire_dtype="int8"),
        error=True))
    jobs["moe layer"] = ("moe_seq_layer", layer_spec())
    data_dir = tmp / "data"
    runs = [cli(tmp / "full", data_dir, 2, *ZERO1),
            cli(tmp / "part", data_dir, 1, *ZERO1, "--checkpoint-dir",
                str(tmp / "ckpt")),
            cli(tmp / "part", data_dir, 2, *ZERO1, "--checkpoint-dir",
                str(tmp / "ckpt"), "--resume")]
    runs += [cli(tmp / name.replace(" ", "_"), data_dir, 1, *extra,
                 model=model)
             for name, (model, extra) in ENTRY_MESHES.items()]
    jobs["clis"] = ("clis", dict(runs=[[argv] * 4 for argv in runs]))
    res = run_ranks(tmp, 4, jobs, timeout=600)
    return {"ranks": res, "dir": tmp, "params": params}


def sp_ids():
    return np.random.RandomState(1).randint(0, VOCAB, (4, SEQ)).astype(
        np.int64)


@pytest.fixture(scope="module")
def pool8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compose8")
    params = jax_params("gpt2_124m")
    jobs = {name: ("mesh_train", dict(
        mesh=MESH_DSM, params=params, model_kwargs=TINY, attention=attention,
        batches=tiny_batches(), config={}, optimizer=CLIP, lr=LR,
        ids=sp_ids())) for name, attention in RUNS8}
    jobs["sp tp zero1"] = ("mesh_train", dict(
        jobs["sp tp ring"][1], config=dict(zero1=True), error=True))
    return {"ranks": run_ranks(tmp, 8, jobs, timeout=600), "params": params}


def jax_attention(mesh, attention):
    if attention is None:
        return None
    make = (jax_make_ring_attention_fn if attention == "ring"
            else jax_make_ulysses_attention_fn)
    return make(mesh, causal=True)


def jax_run(devices, model, mesh_kw, params, config=None, attention=None):
    """(per-step metrics, the aux losses of every step's forward, final
    params by path, the optimizer state) of the JAX Trainer."""
    n = math.prod(mesh_kw.values())
    mesh = jax_build_mesh(JaxMeshSpec(**mesh_kw), devices=devices[:n])
    moe = model == "gpt2_moe"
    cls, kw = (JaxMoE, TINY_MOE) if moe else (JaxGPT2, TINY)
    net = cls(**kw, **({} if attention is None else dict(
        attention_fn=jax_attention(mesh, attention))))
    t = JaxTrainer(JaxMoeTask() if moe else JaxLMTask(), mesh,
                   JaxTrainConfig(seed=0, **(config or {})),
                   rules=cls.partition_rules())
    s = t.init_state(net, np.zeros((1, SEQ), np.int32),
                     jax_adamw(LR, grad_clip_norm=CLIP_NORM,
                               weight_decay=0.01),
                     jax.random.PRNGKey(0))
    s = s.replace(params=jax.tree_util.tree_map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        params, s.params))
    metrics, aux = [], []
    for b in tiny_batches():
        if moe:
            _, mut = jax.jit(lambda p, x: net.apply(
                {"params": p}, x, mutable=["losses"]))(
                    s.params, shard_batch(b, mesh)["input_ids"])
            aux.append([float(np.asarray(a).reshape(()))
                        for a in jax.tree_util.tree_leaves(mut["losses"])])
        s, m = t._train_step(s, shard_batch(b, mesh), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, aux, by_path(jax.device_get(s.params)), s.opt_state


def check_losses_and_params(ours, metrics, want, start):
    for m_ours, m_ref in zip(ours["metrics"], metrics):
        assert m_ours["weight"] == m_ref["weight"]
        np.testing.assert_allclose(m_ours["loss_sum"], m_ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    moved = 0.0
    for path, w in want.items():
        np.testing.assert_allclose(ours["params"][path], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)
        moved = max(moved, float(np.abs(w - start[path]).max()))
    assert moved > 10 * PARAM_ATOL


def check_ranks_agree(ranks, job):
    """Every rank joins the same global arrays."""
    for r in ranks[1:]:
        for path, v in ranks[0][job]["params"].items():
            np.testing.assert_array_equal(r[job]["params"][path], v,
                                          err_msg=path)


# ---------------------------------------------------------------------------
# ZeRO-1 x TP
# ---------------------------------------------------------------------------


def test_zero1_tp_matches_the_replicated_tp_update(pool):
    zero1 = pool["ranks"][0]["zero1 tp"]
    rep = pool["ranks"][0]["tp"]
    check_ranks_agree(pool["ranks"], "zero1 tp")
    for a, b in zip(zero1["metrics"], rep["metrics"]):
        np.testing.assert_allclose(a["loss_sum"], b["loss_sum"],
                                   rtol=LOSS_RTOL)
    for path, w in rep["params"].items():
        got = zero1["params"][path]
        if path.endswith("attn/qkv/bias"):
            np.testing.assert_allclose(got[KEY_BIAS], w[KEY_BIAS], rtol=0,
                                       atol=PARAM_ATOL, err_msg=path)
            got, w = (np.delete(x, KEY_BIAS, 0) for x in (got, w))
        scale = float(np.abs(w).max())
        assert float(np.abs(got - w).max()) <= ZERO1_REL * scale, path


def test_zero1_tp_matches_jax(devices, pool):
    metrics, _, want, _ = jax_run(devices, "gpt2_124m", MESH_DM,
                                  pool["params"]["gpt2_124m"],
                                  config=dict(zero1=True))
    check_losses_and_params(pool["ranks"][0]["zero1 tp"], metrics, want,
                            by_path(pool["params"]["gpt2_124m"]))


def test_zero1_tp_moments_are_one_nth_at_rest(pool):
    for r in pool["ranks"]:
        out = r["zero1 tp"]
        for path, n in out["at_rest"]["params"].items():
            assert out["at_rest"]["opt"][path] == [math.ceil(n / 2)] * 2, \
                path


def test_zero1_tp_refuses_a_compressed_wire_as_jax(devices, pool):
    with pytest.raises(ValueError) as ref:
        JaxTrainer(JaxLMTask(), jax_build_mesh(
            JaxMeshSpec(**MESH_DM), devices=devices[:4]),
            JaxTrainConfig(zero1=True, wire_dtype="int8"),
            rules=JaxGPT2.partition_rules())
    for r in pool["ranks"]:
        assert r["zero1 int8"]["error"] == f"ValueError: {ref.value}"


def test_zero1_tp_resume_is_bitwise(pool):
    for r in pool["ranks"]:
        full, resumed = r["clis"][0], r["clis"][2]
        assert full["step"] == resumed["step"] == 8
        for k, v in full["state"].items():
            np.testing.assert_array_equal(resumed["state"][k], v, err_msg=k)


def one_process_losses(tmp_path, argv):
    """Every step's loss of ``train.main(argv)`` in this process."""
    from distributed_pytorch_training_tpu_torch import train
    from distributed_pytorch_training_tpu_torch.training import Trainer

    step, out = Trainer.train_step, []

    def recording(self, state, batch):
        m = step(self, state, batch)
        out.append(float(m["loss_sum"]) / float(m["weight"]))
        return m

    Trainer.train_step = recording
    try:
        train.main(argv)
    finally:
        Trainer.train_step = step
    return out


@pytest.mark.parametrize("name", list(ENTRY_MESHES))
def test_entry_runs_each_mesh(tmp_path, pool, name):
    """``train.main`` at fsdp=2,model=2 takes the ZeRO-1 run's steps (the
    same rows); at seq=2,model=2 under the ring, GPT-2 and gpt2_moe take
    one process's steps over the same global batches."""
    index = 3 + list(ENTRY_MESHES).index(name)
    runs = [r["clis"][index] for r in pool["ranks"]]
    got = [m["loss_sum"] / m["weight"] for m in runs[0]["metrics"]]
    assert all(r["metrics"] == runs[0]["metrics"] for r in runs[1:])
    if name == "fsdp model":
        ref = pool["ranks"][0]["clis"][0]["metrics"][:len(got)]
        want = [m["loss_sum"] / m["weight"] for m in ref]
    else:
        model, _ = ENTRY_MESHES[name]
        argv = cli(tmp_path, pool["dir"] / "data", 1, model=model)
        i = argv.index("--model-overrides") + 1
        argv[i] += ",pad_vocab_to_multiple_of=128"
        want = one_process_losses(tmp_path, argv)
    # 16 sequences, 2 rows a batch coordinate: 2 coordinates at
    # fsdp=2,model=2, one at seq=2,model=2
    assert len(got) == len(want) == (4 if name == "fsdp model" else 8)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_zero1_tp_checkpoint_moments_are_jax_layout(devices, pool):
    """The saved moments: each global leaf flat-padded over the 2 batch
    ranks, the shapes of the JAX zero1 state on the same mesh; the
    parameters the global model's."""
    ckpt = CheckpointManager(str(pool["dir"] / "ckpt"))
    label = ckpt.all_steps()[-1]
    meta = ckpt.metadata()
    params = ckpt._load(label, "params")
    opt = ckpt._load(label, "opt_state")
    ckpt.close()
    assert meta["layout"] == "zero1" and meta["model_shards"] == 2
    kw = dict(vocab_size=50257, hidden_dim=32, depth=2, num_heads=2,
              max_position=ENTRY_SEQ, pad_vocab_to_multiple_of=128)
    model = get_model("gpt2_124m", device="meta", **kw)
    names = [n for n, _ in sorted(
        model.named_parameters(),
        key=lambda np_: tuple(np_[0].replace("blocks.", "block").split(".")))]
    shapes = dict(model.named_parameters())
    for name in names:
        assert tuple(params[name].shape) == tuple(shapes[name].shape)
    # the JAX zero1 state of this model on data=2,model=2
    mesh = jax_build_mesh(JaxMeshSpec(**MESH_DM), devices=devices[:4])
    t = JaxTrainer(JaxLMTask(), mesh, JaxTrainConfig(seed=0, zero1=True),
                   rules=JaxGPT2.partition_rules())
    s = t.init_state(JaxGPT2(**kw), np.zeros((1, 8), np.int32),
                     jax_adamw(1e-3), jax.random.PRNGKey(0))
    jax_shapes = sorted(tuple(x.shape) for x in
                        jax.tree_util.tree_leaves(s.opt_state)
                        if np.ndim(x) == 1 and x.shape[0] > 1)
    ours = sorted(tuple(v[slot].shape) for v in opt["state"].values()
                  for slot in ("exp_avg", "exp_avg_sq"))
    assert ours == jax_shapes
    for v in opt["state"].values():
        for slot in ("exp_avg", "exp_avg_sq"):
            assert v[slot].shape[0] % 2 == 0


# ---------------------------------------------------------------------------
# SP x TP
# ---------------------------------------------------------------------------


def gathered_logits(ranks, job):
    """(B, S, V) from the ranks' blocks: rows by data index, positions by
    seq index, vocab columns by model index."""
    out = np.zeros((4, SEQ, VOCAB), np.float32)
    for r in ranks:
        c, block = r[job]["coords"], r[job]["logits"]
        rows, width, cols = block.shape
        out[c["data"] * rows:(c["data"] + 1) * rows,
            c["seq"] * width:(c["seq"] + 1) * width,
            c["model"] * cols:(c["model"] + 1) * cols] = block
    return out


@pytest.mark.parametrize("job,attention", RUNS8)
def test_sp_tp_logits_match_the_unsharded_model(pool8, job, attention):
    net = JaxGPT2(**TINY)
    want = np.asarray(jax.jit(lambda p, x: net.apply({"params": p}, x))(
        pool8["params"], sp_ids()))
    np.testing.assert_allclose(gathered_logits(pool8["ranks"], job), want,
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_zero1_refuses_the_seq_axis_as_jax(devices, pool8):
    """ZeRO-1's chunks are spread over the batch axes alone: on
    ``data=2,seq=2,model=2`` it is refused with the JAX Trainer's
    message."""
    with pytest.raises(ValueError) as ref:
        JaxTrainer(JaxLMTask(), jax_build_mesh(
            JaxMeshSpec(**MESH_DSM), devices=devices[:8]),
            JaxTrainConfig(zero1=True), rules=JaxGPT2.partition_rules())
    assert "mesh axes ['seq'] > 1" in str(ref.value)
    for r in pool8["ranks"]:
        assert r["sp tp zero1"]["error"] == f"ValueError: {ref.value}"


@pytest.mark.parametrize("job,attention", RUNS8)
def test_sp_tp_trajectory_matches_jax(devices, pool8, job, attention):
    metrics, _, want, _ = jax_run(devices, "gpt2_124m", MESH_DSM,
                                  pool8["params"], attention=attention)
    check_ranks_agree(pool8["ranks"], job)
    check_losses_and_params(pool8["ranks"][0][job], metrics, want,
                            by_path(pool8["params"]))


# ---------------------------------------------------------------------------
# gpt2_moe on model and on seq
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job,mesh,attention",
                         [("moe tp", MESH_DM, None),
                          ("moe sp", MESH_DS, "ring")],
                         ids=["model", "seq"])
def test_moe_matches_jax(devices, pool, job, mesh, attention):
    metrics, aux, want, _ = jax_run(devices, "gpt2_moe", mesh,
                                    pool["params"]["gpt2_moe"],
                                    attention=attention)
    check_ranks_agree(pool["ranks"], job)
    ours = pool["ranks"][0][job]
    check_losses_and_params(ours, metrics, want,
                            by_path(pool["params"]["gpt2_moe"]))
    for r in pool["ranks"]:
        np.testing.assert_allclose(r[job]["aux"], aux, rtol=AUX_RTOL)


def test_moe_dispatch_at_seq2_is_the_unsharded_one(pool):
    """The first step's dispatch at data=2,seq=2 (each rank the whole rows
    of its batch coordinate) bitwise that of the unsharded model on the
    same rows: which tokens each expert keeps, at which slot, and the
    dropped count."""
    model = get_model("gpt2_moe", **TINY_MOE)
    load_flax_params(model, pool["params"]["gpt2_moe"])
    ids = torch.from_numpy(tiny_batches()[0]["input_ids"]).long()
    with torch.no_grad():
        model(ids)
    want = [b.moe.last_dispatch.numpy() for b in model.blocks
            if hasattr(b, "moe")]
    overflow = TINY_MOE["num_experts"] * math.ceil(
        SEQ * 2 / TINY_MOE["num_experts"] * 1.25)
    for r in pool["ranks"]:
        out = r["moe sp"]
        b = out["batch_index"]
        for got, ref in zip(out["dispatch"][0], want):
            np.testing.assert_array_equal(got, ref[b * 4:(b + 1) * 4])
            assert (got == overflow).sum() == (
                ref[b * 4:(b + 1) * 4] == overflow).sum()


def test_moe_layer_over_seq_is_the_unsharded_layer_bitwise(pool):
    spec = layer_spec()
    ref = MoeMlp(**spec["layer"])
    with torch.no_grad():
        for name, p in ref.named_parameters():
            p.copy_(torch.from_numpy(spec["params"][name]))
    x = torch.from_numpy(spec["x"]).requires_grad_()
    y = ref(x)
    (y * torch.from_numpy(spec["g"])).sum().backward()
    width = SEQ // 2
    for r in pool["ranks"]:
        out = r["moe layer"]
        part = slice(out["index"] * width, (out["index"] + 1) * width)
        np.testing.assert_array_equal(out["dispatch"],
                                      ref.last_dispatch.numpy())
        np.testing.assert_array_equal(out["y"], y.detach().numpy()[:, part])
        np.testing.assert_array_equal(out["aux"], ref.last_aux.item())
        # the input's gradient: the two seq ranks' sums of the whole row
        # (each rank's output slice), reduce-scattered: the unsharded one
        # at float32 reassociation of 2 terms
        np.testing.assert_allclose(out["dx"], x.grad.numpy()[:, part],
                                   rtol=1e-6, atol=1e-7)
