"""Sequence-parallel GPT-2 through the port's entry (``train.main --mesh
data=D,seq=N --attention ring|ulysses``) against the JAX Trainer on the
same mesh spec, on the CPU: a narrow GPT-2 (2 blocks, width 64, 4 heads,
S 32, GPT-2's vocab, which the synthetic corpus carries).

* The logits of GPT-2 from one set of flax weights, each rank running its
  rows' sequence shard (positions offset by the shard), gathered, against
  the JAX GPT-2 with the JAX ring / Ulysses attention on the JAX mesh.
* ``train.main`` on 2 gloo ranks (``data=1,seq=2``: ring, Ulysses) and on
  4 (``data=2,seq=2``: ring, Ulysses), SGD with momentum: every step's
  global metrics and the final parameters against the JAX Trainer from
  the same initial weights (the port's seed init, converted) over the
  same global batches; the ranks' parameters bitwise equal; a ring run
  stopped after one epoch and ``--resume``d at the same mesh ends bitwise
  the uninterrupted run, and its checkpoint records the mesh.
* The causal LM task's shard labels: the sums over the shards of a row
  are the unsharded task's.
* The refusals, with the JAX package's messages: BERT with ring or
  Ulysses (the JAX entry's), ``--zero1``, ``--fsdp-explicit`` and the
  int8 wire on a mesh with ``seq`` > 1 (the JAX Trainer's), ``seq`` > 1
  without ring or Ulysses (``validate_mesh_usage``'s), a mesh the ranks
  cannot fill (``MeshSpec``'s), and the mesh axes still unported, each
  naming its slice.

The ranks are ``tests/_torch_dp_worker.py`` processes: one module-scoped
run of 2 ranks and one of 4 serve every leg.

Tolerances, as the data-parallel GPT-2 test's (``test_torch_dp_gpt2.py``):
each step's loss sum within LOSS_RTOL = 1e-5, the parameters within
PARAM_ATOL = 1e-5 + PARAM_RTOL = 1e-4 (float32 reassociation: the ring's
per-block merges, the ranks' partial gradients summed); the logits within
LOGIT_ATOL = LOGIT_RTOL = 1e-5.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.ops.ring_attention import (
    make_ring_attention_fn as jax_make_ring_attention_fn,
)
from distributed_pytorch_training_tpu.ops.ulysses_attention import (
    make_ulysses_attention_fn as jax_make_ulysses_attention_fn,
)
from distributed_pytorch_training_tpu.parallel import (
    MeshSpec as JaxMeshSpec, build_mesh as jax_build_mesh, shard_batch,
)
from distributed_pytorch_training_tpu.parallel.mesh import (
    validate_mesh_usage as jax_validate_mesh_usage,
)
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
)
from distributed_pytorch_training_tpu.training.tasks import (
    LanguageModelingTask as JaxLMTask,
)
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import (
    flax_to_torch, torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.data.text import (
    TokenLoader, get_token_dataset,
)
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.parallel.mesh import (
    Mesh, MeshSpec, validate_mesh_usage,
)
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig, Trainer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    LanguageModelingTask,
)

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401 (autouse)

SEQ_LEN, SYNTHETIC, SEED, LR = 32, 16, 0, 0.05
MODEL_KW = dict(vocab_size=50257, hidden_dim=64, depth=2, num_heads=4,
                max_position=SEQ_LEN)
OVERRIDES = ",".join(f"{k}={v}" for k, v in MODEL_KW.items())
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
LOGIT_ATOL = LOGIT_RTOL = 1e-5

# (name, mesh, attention, per-batch-shard batch, epochs): 4 global rows
RUNS2 = [("ring", "data=1,seq=2", "ring", 4, 2),
         ("ulysses", "data=1,seq=2", "ulysses", 4, 2)]
RUNS4 = [("ring 2x2", "data=2,seq=2", "ring", 2, 1),
         ("ulysses 2x2", "data=2,seq=2", "ulysses", 2, 1)]


def cli(tmp, mesh, attention, batch, epochs, *extra):
    return ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
            OVERRIDES, "--seq-len", str(SEQ_LEN), "--synthetic",
            "--synthetic-size", str(SYNTHETIC), "--data-dir", str(tmp),
            "--epochs", str(epochs), "--batch-size", str(batch),
            "--optimizer", "sgd", "--lr", str(LR), "--print-freq", "1000",
            "--no-telemetry", "--seed", str(SEED), "--mesh", mesh,
            "--attention", attention, *extra]


def initial_params():
    """The weights ``train.main`` draws from ``--seed``, as a flax tree."""
    model = get_model("gpt2_124m", **MODEL_KW)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return torch_to_flax(model)


def global_batches(tmp, epochs):
    """The global batches (4 rows) the runs' loaders hold, in order."""
    ds = get_token_dataset("gpt2", SEQ_LEN, str(tmp), train=True,
                           synthetic_size=SYNTHETIC, seed=SEED)
    loader = TokenLoader(ds, 4, shuffle=True, seed=SEED)
    return [{k: v.numpy() for k, v in b.items()}
            for e in range(epochs) for b in loader.epoch(e)]


def jax_attention(mesh, attention):
    make = (jax_make_ring_attention_fn if attention == "ring"
            else jax_make_ulysses_attention_fn)
    return make(mesh, causal=True)


def jax_mesh_of(devices, spec):
    kw = {k: int(v) for k, v in (p.split("=") for p in spec.split(","))}
    n = int(np.prod(list(kw.values())))
    return jax_build_mesh(JaxMeshSpec(**kw), devices=devices[:n])


def jax_trajectory(devices, spec, attention, params, batches):
    """(per-step metrics, final params) of the JAX Trainer from
    ``params``, SGD as the entry's defaults (momentum 0.9, weight decay
    5e-4, constant lr)."""
    mesh = jax_mesh_of(devices, spec)
    model = jax_get_model("gpt2_124m", attention_fn=jax_attention(
        mesh, attention), **MODEL_KW)
    jt = JaxTrainer(JaxLMTask(), mesh, JaxTrainConfig(seed=SEED,
                                                      print_freq=1000))
    jstate = jt.init_state(model, np.zeros((1, SEQ_LEN), np.int32),
                           jax_make_optimizer("sgd", LR),
                           jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        lambda new, old: jax.device_put(np.asarray(new), old.sharding),
        params, jstate.params))
    metrics = []
    for b in batches:
        jstate, m = jt._train_step(jstate, shard_batch(b, mesh),
                                   jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(jstate.params)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sp_data")


@pytest.fixture(scope="module")
def ids(data_dir):
    return global_batches(data_dir, 1)[0]["input_ids"]


def logits_job(params, ids, mesh, attention):
    kw = {k: int(v) for k, v in (p.split("=") for p in mesh.split(","))}
    return ("lm_logits", dict(params=params, ids=ids, mesh=kw,
                              attention=attention, model_kwargs=MODEL_KW))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, data_dir, ids):
    tmp = tmp_path_factory.mktemp("sp2")
    params = initial_params()
    runs = [cli(data_dir, *r[1:], "--output-dir", str(tmp / r[0]),
                "--checkpoint-dir", str(tmp / r[0] / "ckpt"))
            for r in RUNS2]
    # the ring run again: one epoch, then --resume to two
    part = tmp / "part"
    runs.append(cli(data_dir, "data=1,seq=2", "ring", 4, 1, "--output-dir",
                    str(part), "--checkpoint-dir", str(part / "ckpt")))
    runs.append(cli(data_dir, "data=1,seq=2", "ring", 4, 2, "--output-dir",
                    str(part), "--checkpoint-dir", str(part / "ckpt"),
                    "--resume"))
    jobs = {f"logits {a}": logits_job(params, ids, "data=1,seq=2", a)
            for a in ("ring", "ulysses")}
    jobs["clis"] = ("clis", dict(runs=[[argv, argv] for argv in runs]))
    res = run_ranks(tmp, 2, jobs, timeout=400)
    return {"ranks": res, "dir": tmp, "params": params}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, data_dir, ids):
    tmp = tmp_path_factory.mktemp("sp4")
    params = initial_params()
    runs = [cli(data_dir, *r[1:], "--output-dir", str(tmp / r[0]))
            for r in RUNS4]
    jobs = {"logits ring": logits_job(params, ids, "data=2,seq=2", "ring"),
            "clis": ("clis", dict(runs=[[argv] * 4 for argv in runs]))}
    return {"ranks": run_ranks(tmp, 4, jobs, timeout=400), "params": params}


def gathered_logits(ranks, key, data, seq):
    """(B, S, V) from the ranks' blocks: rank r holds batch shard
    r // seq, sequence shard r % seq."""
    rows = [np.concatenate([ranks[d * seq + s][key] for s in range(seq)],
                           axis=1) for d in range(data)]
    return np.concatenate(rows, axis=0)


def jax_logits(devices, spec, attention, params, ids):
    mesh = jax_mesh_of(devices, spec)
    model = jax_get_model("gpt2_124m", attention_fn=jax_attention(
        mesh, attention), **MODEL_KW)
    apply = jax.jit(lambda p, x: model.apply({"params": p}, x))
    return np.asarray(apply(params, ids))


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_logits_on_two_ranks_match_jax(devices, two_ranks, ids, attention):
    got = gathered_logits(two_ranks["ranks"], f"logits {attention}", 1, 2)
    want = jax_logits(devices, "data=1,seq=2", attention,
                      two_ranks["params"], ids)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_logits_on_four_ranks_match_jax(devices, four_ranks, ids):
    got = gathered_logits(four_ranks["ranks"], "logits ring", 2, 2)
    want = jax_logits(devices, "data=2,seq=2", "ring",
                      four_ranks["params"], ids)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def check_against_jax(devices, data_dir, runs, spec, params, name, epochs,
                      attention):
    batches = global_batches(data_dir, epochs)
    jmetrics, jparams = jax_trajectory(devices, spec, attention, params,
                                       batches)
    mine = [r["clis"][name] for r in runs]
    assert all(m["step"] == len(batches) for m in mine)
    for ours, ref in zip(mine[0]["metrics"], jmetrics):
        assert ours["weight"] == ref["weight"] == 4 * (SEQ_LEN - 1)
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
        assert ours["correct"] == ref["correct"]
    start = flax_to_torch(params)
    moved = 0.0
    for pname, want in flax_to_torch(jparams).items():
        got = mine[0]["state"][f"model/{pname}"]
        for other in mine[1:]:            # replicated: the same bits
            np.testing.assert_array_equal(other["state"][f"model/{pname}"],
                                          got)
        want = want.numpy()
        moved = max(moved, float(np.abs(want - start[pname].numpy()).max()))
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=pname)
    assert moved > 10 * PARAM_ATOL


@pytest.mark.parametrize("run", RUNS2, ids=[r[0] for r in RUNS2])
def test_train_main_on_two_ranks_matches_jax_trainer(devices, data_dir,
                                                     two_ranks, run):
    name, spec, attention, _, epochs = run
    runs = [{"clis": dict(zip([r[0] for r in RUNS2], rank["clis"]))}
            for rank in two_ranks["ranks"]]
    check_against_jax(devices, data_dir, runs, spec, two_ranks["params"],
                      name, epochs, attention)


@pytest.mark.parametrize("run", RUNS4, ids=[r[0] for r in RUNS4])
def test_train_main_on_four_ranks_matches_jax_trainer(devices, data_dir,
                                                      four_ranks, run):
    name, spec, attention, _, epochs = run
    runs = [{"clis": dict(zip([r[0] for r in RUNS4], rank["clis"]))}
            for rank in four_ranks["ranks"]]
    check_against_jax(devices, data_dir, runs, spec, four_ranks["params"],
                      name, epochs, attention)


def test_resume_at_the_same_mesh_is_bitwise(two_ranks):
    for rank in two_ranks["ranks"]:
        full, _, resumed = rank["clis"][0], rank["clis"][2], \
            rank["clis"][3]
        assert resumed["step"] == full["step"]
        assert resumed["state"].keys() == full["state"].keys()
        for key, value in full["state"].items():
            np.testing.assert_array_equal(resumed["state"][key], value,
                                          err_msg=key)


def test_checkpoint_records_the_mesh(two_ranks):
    ckpt = two_ranks["dir"] / "part" / "ckpt"
    labels = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    meta = json.loads((ckpt / str(labels[-1]) / "meta.json").read_text())
    assert meta["mesh"] == MeshSpec(data=1, seq=2).resolved(2)
    assert meta["world_size"] == 2


def test_shard_labels_count_each_token_once():
    """A rank's last label is the next shard's first token and the row's
    final position has none: over the shards the task's sums are the
    unsharded task's. The model here maps each position alone (no
    attention), so every shard's logits are the whole row's."""
    torch.manual_seed(0)
    table = torch.randn(97, 33, 97)

    def model(ids, pos_offset=0):
        pos = pos_offset + torch.arange(ids.shape[1])
        return table[ids, pos]

    ids = torch.randint(0, 97, (3, 32))
    batch = {"input_ids": ids, "weight": torch.tensor([1.0, 1.0, 0.0])}
    _, whole, _ = LanguageModelingTask().loss_and_metrics(model, batch,
                                                          True)
    for n in (2, 4):
        parts = [LanguageModelingTask(seq_index=i, seq_shards=n)
                 .loss_and_metrics(model, batch, True)[1] for i in range(n)]
        assert sum(float(p["weight"]) for p in parts) == float(
            whole["weight"]) == 2 * 31
        assert sum(float(p["correct"]) for p in parts) == float(
            whole["correct"])
        np.testing.assert_allclose(sum(float(p["loss_sum"]) for p in parts),
                                   float(whole["loss_sum"]), rtol=1e-6)
    with pytest.raises(ValueError, match="not divisible by 3 'seq' shards"):
        LanguageModelingTask(seq_shards=3).loss_and_metrics(model, batch,
                                                            True)


# ---------------------------------------------------------------------------
# refusals, with the JAX package's messages
# ---------------------------------------------------------------------------

BERT = ["--model", "bert_base", "--synthetic", "--synthetic-size", "16",
        "--seq-len", "32", "--model-overrides",
        "hidden_dim=32,depth=2,num_heads=2,mlp_dim=64,max_position=32",
        "--batch-size", "2", "--epochs", "1", "--no-telemetry"]


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_bert_with_ring_or_ulysses_refused_as_the_jax_entry(tmp_path,
                                                            attention):
    jax_train = importlib.import_module("train")
    argv = BERT + ["--attention", attention]
    with pytest.raises(ValueError) as ref:
        jax_train.main(argv + ["--output-dir", str(tmp_path / "jax")])
    with pytest.raises(ValueError) as ours:
        train.main(argv + ["--device", "cpu", "--output-dir",
                           str(tmp_path / "port")])
    assert str(ours.value) == str(ref.value)
    assert "causal-only" in str(ours.value)


@pytest.mark.parametrize("config", [dict(zero1=True),
                                    dict(fsdp_explicit=True),
                                    dict(wire_dtype="int8"),
                                    dict(bucket_cap_mb=25.0)],
                         ids=["zero1", "fsdp-explicit", "int8-wire",
                              "bucketed"])
def test_explicit_sync_refused_on_a_seq_mesh_as_the_jax_trainer(devices,
                                                                config):
    jax_mesh = jax_build_mesh(JaxMeshSpec(data=1, seq=2),
                              devices=devices[:2])
    with pytest.raises(ValueError) as ref:
        JaxTrainer(JaxLMTask(), jax_mesh, JaxTrainConfig(**config))
    mesh = Mesh(MeshSpec(data=1, seq=2).resolved(2), 0)
    with pytest.raises(ValueError) as ours:
        Trainer(LanguageModelingTask(), TrainConfig(**config), device="cpu",
                mesh=mesh)
    assert str(ours.value) == str(ref.value)
    assert "need the implicit path" in str(ours.value)


@pytest.mark.parametrize("attention", ["flash", "xla", "auto"])
def test_seq_without_ring_or_ulysses_refused_as_jax(devices, attention):
    jax_mesh = jax_build_mesh(JaxMeshSpec(data=1, seq=2),
                              devices=devices[:2])
    mesh = Mesh(MeshSpec(data=1, seq=2).resolved(2), 0)
    with pytest.raises(ValueError) as ref:
        jax_validate_mesh_usage(jax_mesh, attention=attention)
    with pytest.raises(ValueError) as ours:
        validate_mesh_usage(mesh, attention=attention)
    assert str(ours.value) == str(ref.value)
    assert "does not shard the sequence" in str(ours.value)


TINY = ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
        OVERRIDES, "--seq-len", "32", "--synthetic", "--synthetic-size", "8",
        "--batch-size", "4", "--epochs", "1", "--no-telemetry"]


@pytest.mark.parametrize("flags,error,match", [
    (["--mesh", "data=1,seq=2", "--attention", "ring"], ValueError,
     "needs 2 devices but 1 are present"),
    (["--mesh", "seq=-1,data=2"], ValueError,
     "1 devices not divisible by fixed axes product 2"),
    (["--mesh", "seq=2,model=2,expert=2", "--attention", "ring"],
     NotImplementedError, "the expert x model slice"),
    (["--mesh", "fsdp=2,seq=2", "--attention", "ring"], NotImplementedError,
     "a later slice of the fsdp axis"),
    (["--mesh", "pipe=2"], ValueError,
     "1 devices not divisible by fixed axes product 2"),
    (["--mesh", "pipe=2", "--attention", "flash"], ValueError,
     "--mesh pipe>1 uses the XLA attention path"),
    (["--mesh", "expert=2"], ValueError,
     "1 devices not divisible by fixed axes product 2"),
    (["--slices", "2", "--mesh", "slice=3"], ValueError,
     "--slices 2 conflicts with --mesh"),
], ids=["one-rank-seq2", "wild-seq", "model", "fsdp", "pipe",
        "pipe-kernel-attention", "expert", "slices-conflict"])
def test_mesh_flags_refused(tmp_path, flags, error, match):
    with pytest.raises(error, match=match):
        train.main(TINY + flags + ["--output-dir", str(tmp_path)])
    assert not (tmp_path / "metrics_rank0.csv").exists()
