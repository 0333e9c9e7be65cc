"""The port's ZeRO-1 update against the JAX package's: the flat-padded
layout and its residual rows on ResNet-18's and GPT-2 124M's shapes, the
scatter and update-gather codecs on 2 gloo ranks against the same
functions inside ``shard_map`` on a 2-device CPU mesh, 3-step Trainer
trajectories on 2 ranks against the JAX Trainer (``zero1=True``) at the
fp32, bf16, int8 and int8_multihop wires, SGD on the narrow ResNet-18,
AdamW with the global-norm clip on a tiny GPT-2, and accumulation 2;
then the entry point: the one-rank passthrough, and a 2-rank run
preempted mid-epoch and resumed bitwise.

The ranks are ``tests/_torch_dp_worker.py`` processes; one module-scoped
run serves every multi-rank leg. Tolerances: ``_torch_sharded.py``'s
docstring for the trajectories. The codecs: every K1 call's codes and
scales bitwise the JAX quantizer's on the same rows; the fp32 scatter on
2 ranks bitwise (each element one float32 addition, in either order the
same); the others within CODEC_RTOL = 1e-6 of the output's largest
magnitude (a float32 rounding or two: the bf16 sum, the int8 dequant-sum
and the residual's multiply-add may round in another order than the
compiled reference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import grad_sync as jgs
from distributed_pytorch_training_tpu.parallel import sharding as jsh
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import iter_flax_leaves
from distributed_pytorch_training_tpu_torch.parallel import grad_sync as gs
from distributed_pytorch_training_tpu_torch.parallel import sharding as sh
from distributed_pytorch_training_tpu_torch.training.checkpoint import (
    CheckpointManager,
    CheckpointWorldSizeMismatch,
)
from distributed_pytorch_training_tpu_torch.training.train_state import (
    FlatSharding,
)

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state, rig  # noqa: F401
from _torch_sharded import (HOP, check_ef_rows,
                            check_trajectory, jax_codec, jax_run, port_job)

CODEC_RTOL = 1e-6

# (name, gpt2?, config): SGD on the ResNet, AdamW + clip on the GPT-2
CASES = [
    ("fp32", False, dict(zero1=True)),
    ("bf16", False, dict(zero1=True, wire_dtype="bf16")),
    ("int8", False, dict(zero1=True, wire_dtype="int8")),
    ("int8_multihop", False, dict(zero1=True, wire_dtype="int8_multihop")),
    ("int8-accum2", False, dict(zero1=True, wire_dtype="int8",
                                grad_accum=2)),
    ("gpt2-adamw-fp32", True, dict(zero1=True)),
    ("gpt2-adamw-int8", True, dict(zero1=True, wire_dtype="int8")),
]
HOPS = {"fp32": 0.0, "bf16": HOP["bf16"], "int8": HOP["int8"],
        "int8_multihop": 2 * HOP["int8"]}


def model_shapes(name):
    """(path, shape) of a model's flax params, in tree_leaves order."""
    if name == "resnet18":
        model, x = jax_get_model("resnet18"), jnp.zeros((1, 32, 32, 3))
    else:
        model, x = jax_get_model("gpt2_124m"), jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                               train=False))["params"]
    return shapes


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("model", ["resnet18", "gpt2_124m"])
def test_flat_padded_layout_and_ef_rows_equal_jax(devices, model, n):
    tree = model_shapes(model)
    named = [(".".join(p), leaf) for p, leaf in iter_flax_leaves(tree)]
    for _, leaf in named:
        size = int(np.prod(leaf.shape))
        assert sh.flat_padded_size(size, n) == jsh.flat_padded_size(size, n)
    mesh = build_mesh(MeshSpec(data=n), devices=devices[:n])
    ref = jax.eval_shape(lambda: jgs.ef_state_zero1(tree, mesh, n))["ef"]
    ours = gs.ef_state_zero1(
        [(k, torch.empty(leaf.shape, device="meta")) for k, leaf in named],
        n, device=torch.device("meta"))["ef"]
    assert list(ours) == [k for k, _ in named]
    assert [(n,) + tuple(r.shape) for r in ours.values()] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(ref)]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_flatten_pad_and_chunks_bitwise_jax(n):
    rng = np.random.RandomState(n)
    for shape in [(7,), (3, 5), (2, 3, 3, 4), (1,)]:
        x = rng.randn(*shape).astype(np.float32)
        want = np.asarray(jsh.flatten_pad(jnp.asarray(x), n))
        got = sh.flatten_pad(torch.from_numpy(x), n).numpy()
        np.testing.assert_array_equal(got, want)
        chunks = sh.fsdp_flat_params([torch.from_numpy(x)] * n, n, 0)
        np.testing.assert_array_equal(chunks[0].numpy(),
                                      want.reshape(n, -1)[0])
        np.testing.assert_array_equal(
            np.concatenate([sh.chunk_of(torch.from_numpy(x), n, i).numpy()
                            for i in range(n)]), want)
        back = sh.unflatten_padded(torch.from_numpy(want.copy()), shape)
        np.testing.assert_array_equal(back.numpy(), x)


# ---------------------------------------------------------------------------
# codecs on 2 gloo ranks
# ---------------------------------------------------------------------------

PADDED = 2 * 501        # one flat-padded leaf of 1001 elements on 2 ranks


def codec_inputs():
    rng = np.random.RandomState(7)
    v = (rng.randn(2, PADDED) * rng.rand(2, 1) * 3).astype(np.float32)
    v[:, -1] = 0.0      # the pad
    res = (rng.randn(2, PADDED) * 0.01).astype(np.float32)
    old = rng.randn(PADDED).astype(np.float32)
    new = old.reshape(2, -1) + (rng.randn(2, PADDED // 2) * 1e-3).astype(
        np.float32)
    return v, res, old, new


def codec_ops():
    v, res, old, new = codec_inputs()
    olds = old.reshape(2, -1)
    return [
        ("scatter-fp32", "compressed_psum_scatter", [v, 2, "fp32"]),
        ("scatter-bf16", "compressed_psum_scatter", [v, 2, "bf16"]),
        ("scatter-int8", "compressed_psum_scatter", [v, 2, "int8", res]),
        ("delta", "quantized_delta_all_gather",
         [new, olds, np.stack([old, old])]),
    ]


def jax_codecs(devices):
    v, res, old, new = codec_inputs()
    axes = ("data",)
    out = {}
    for wire in ("fp32", "bf16"):
        out[f"scatter-{wire}"] = jax_codec(
            devices, 2, lambda x, w=wire: jgs.compressed_psum_scatter(
                x, axes, 2, w)[0], v)
    out["scatter-int8"] = jax_codec(
        devices, 2, lambda x, r: jgs.compressed_psum_scatter(
            x, axes, 2, "int8", r, fused=False), v, res, n_out=2)
    out["delta"] = jax_codec(
        devices, 2, lambda a, b, c: jgs.quantized_delta_all_gather(
            a, b, c, axes, fused=False),
        new, old.reshape(2, -1), np.stack([old, old]))
    return out


@pytest.fixture(scope="module")
def ranks(devices, tmp_path_factory):
    """Every multi-rank leg in one 2-rank run: the JAX runs first."""
    runs = {name: jax_run(devices, 2, lm, cfg) for name, lm, cfg in CASES}
    jobs = {name: port_job(runs[name], lm, cfg)
            for name, lm, cfg in CASES}
    jobs["codec"] = ("codec", {"ops": codec_ops()})
    return runs, run_ranks(tmp_path_factory.mktemp("zero1"), 2, jobs)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("op", ["scatter-fp32", "scatter-bf16",
                                "scatter-int8", "delta"])
def test_codecs_on_2_ranks_equal_jax(devices, ranks, op):
    want = jax_codecs(devices)[op]
    for rank, r in enumerate(ranks[1]):
        got = r["codec"][op]
        for ours, ref in zip(got["out"], want):
            ref = ref[rank]
            if op == "scatter-fp32":
                np.testing.assert_array_equal(bits(ours), bits(ref))
            np.testing.assert_allclose(
                ours, ref, rtol=0,
                atol=CODEC_RTOL * max(np.abs(ref).max(), 1e-30))
        for rows, q, s in got["k1"]:     # the wire's codes, bitwise
            q_ref, s_ref = jgs._quantize_int8_rows(jnp.asarray(rows),
                                                   fused=False)
            np.testing.assert_array_equal(q, np.asarray(q_ref))
            np.testing.assert_array_equal(bits(s), bits(s_ref))
        assert len(got["k1"]) == (1 if op in ("scatter-int8", "delta")
                                  else 0)
    if op == "delta":   # replicated: the same bits on both ranks
        np.testing.assert_array_equal(ranks[1][0]["codec"][op]["out"][0],
                                      ranks[1][1]["codec"][op]["out"][0])


def test_int8_multihop_scatter_is_refused():
    with pytest.raises(ValueError, match="maps wire_dtype='int8_multihop'"):
        gs.compressed_psum_scatter(torch.zeros(4), 2, "int8_multihop")
    with pytest.raises(ValueError, match="error-feedback residual"):
        gs.compressed_psum_scatter(torch.zeros(4), 2, "int8")


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,lm,cfg", CASES, ids=[c[0] for c in CASES])
def test_zero1_trajectory_matches_jax_trainer(ranks, name, lm, cfg):
    runs, port = ranks
    run = runs[name]
    rs = [r[name] for r in port]
    check_trajectory(run, rs, HOPS[cfg.get("wire_dtype", "fp32")], lm=lm)
    # at rest: each rank's moments are padded/2 of every leaf
    for r in rs:
        assert sorted(r["at_rest"]["opt"]) == sorted(
            s // 2 for s in run["opt_sizes"])
        assert sum(r["at_rest"]["params"]) == sum(
            int(np.prod(x.shape)) for _, x in iter_flax_leaves(
                run["params"]))           # the parameters stay whole
    if run["ef"] is not None:
        ref = jax.tree_util.tree_leaves(run["ef"])
        for rank, r in enumerate(rs):
            check_ef_rows(list(r["ef"]["ef"].values()),
                          [b[rank] for b in ref])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

DP_CLI = ["--device", "cpu", "--model", "resnet18", "--model-overrides",
          "num_filters=4", "--synthetic", "--synthetic-size", "64",
          "--batch-size", "4", "--epochs", "2", "--print-freq", "2",
          "--zero1", "--wire-dtype", "int8", "--no-telemetry"]


def test_one_rank_zero1_is_the_replicated_passthrough(tmp_path, capsys):
    state = train.main(DP_CLI + ["--epochs", "1", "--output-dir",
                                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "NOTE: zero1 requested on a single batch shard — running the " \
           "replicated update" in out
    assert "ZeRO-1:" not in out
    assert state.sharding is None and state.grad_sync == {}
    assert state.step == 16


def test_two_ranks_preempted_and_resumed_bitwise(tmp_path):
    """2 ranks, zero1 on the int8 wire, 16 steps an epoch: rank 1 gets
    SIGTERM at step 2; both stop at step 4 with a checkpoint, and the
    resumed run ends bitwise equal to the uninterrupted one on each rank,
    moments and per-leaf residuals included. The checkpoint holds the
    JAX global arrays; it restores into no other layout or world."""
    ck = str(tmp_path / "ck")

    def cli(name, per_rank):
        work = tmp_path / name
        work.mkdir()
        return run_ranks(work, 2, {"cli": ("cli", {"argv": per_rank})},
                         timeout=240)

    base = DP_CLI + ["--output-dir", str(tmp_path / "b"),
                     "--checkpoint-dir", ck]
    whole = cli("a", [DP_CLI + ["--output-dir", str(tmp_path / "a")]] * 2)
    cut = cli("b", [base, base + ["--chaos", "sigterm@step=2"]])
    assert [r["cli"]["step"] for r in cut] == [4, 4]
    resumed = cli("c", [base + ["--resume"]] * 2)
    for r in range(2):
        a, b = whole[r]["cli"]["state"], resumed[r]["cli"]["state"]
        assert a.keys() == b.keys()
        assert sum(k.startswith("grad_sync/ef/") for k in a) == 62
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    mgr = CheckpointManager(ck)
    meta = mgr.metadata(4)
    assert meta["layout"] == "zero1"
    ef = torch.load(f"{ck}/4/grad_sync.pt", weights_only=True)["ef"]
    opt = torch.load(f"{ck}/4/opt_state.pt", weights_only=True)
    params = torch.load(f"{ck}/4/params.pt", weights_only=True)
    # the global arrays: (n, padded) residual rows, whole flat moments
    for name, p in params.items():
        padded = sh.flat_padded_size(p.numel(), 2)
        assert ef[name].shape == (2, padded)
    assert sorted(m["momentum_buffer"].numel()
                  for m in opt["state"].values()) == sorted(
        sh.flat_padded_size(p.numel(), 2) for p in params.values())
    # into the replicated layout: refused with the JAX entry's hint
    _, factory, _ = rig("resnet")
    with pytest.raises(ValueError, match="zero1 stores optimizer state "
                                         "flat-sharded"):
        mgr.restore_latest(factory())
    # into a zero1 layout of another world: the named error
    template = factory()
    template.sharding = FlatSharding(
        mode="zero1", n_shards=3, rank=0, owners=(0, 1, 2),
        names=tuple(params), shapes=tuple(tuple(p.shape)
                                          for p in params.values()))
    with pytest.raises(CheckpointWorldSizeMismatch, match="world size 2"):
        mgr.restore_latest(template)
    mgr.close()
    with pytest.raises(RuntimeError, match="checkpoint restore failed"):
        train.main(DP_CLI + ["--output-dir", str(tmp_path / "d"),
                             "--checkpoint-dir", ck, "--resume"])
