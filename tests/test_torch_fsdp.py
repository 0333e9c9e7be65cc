"""The port's explicit FSDP against the JAX package's: the layer plan
(names, leaf slots, chunk sizes), its residual rows and the wire
accounting on ResNet-18's and GPT-2 124M's shapes; the s8 shard gather
on 2 gloo ranks against ``shard_map``; 3-step Trainer trajectories on 2
ranks against the JAX Trainer (``fsdp_explicit=True``) at the fp32 and
int8 wires, with the parameters and moments 1/N a rank at rest; then the
entry point: the one-rank passthrough, a 2-rank run preempted mid-epoch
and resumed bitwise, and ``serving smoke --ckpt-dir`` on its checkpoint.

Tolerances: ``_torch_sharded.py``'s docstring for the trajectories (the
int8 scatter is one hop; the gathers of fp32 and int8 are exact). The
shard gather: codes and scales bitwise the JAX quantizer's, the output
within CODEC_RTOL = 1e-6 of its largest magnitude (a dequantizing
multiply, rounded once either way).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import grad_sync as jgs
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import iter_flax_leaves
from distributed_pytorch_training_tpu_torch.parallel import grad_sync as gs
from distributed_pytorch_training_tpu_torch.serving.__main__ import run
from distributed_pytorch_training_tpu_torch.training.checkpoint import (
    CheckpointManager,
)

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401
from _torch_sharded import (HOP, check_ef_rows, check_trajectory,
                            jax_codec, jax_run, port_job)

CODEC_RTOL = 1e-6
CASES = [("fp32", dict(fsdp_explicit=True)),
         ("int8", dict(fsdp_explicit=True, wire_dtype="int8"))]


def model_tree(name):
    if name == "resnet18":
        model, x = jax_get_model("resnet18"), jnp.zeros((1, 32, 32, 3))
    else:
        model, x = jax_get_model("gpt2_124m"), jnp.zeros((1, 8), jnp.int32)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                             train=False))["params"]


def named(tree):
    return [(".".join(p), torch.empty(leaf.shape, device="meta"))
            for p, leaf in iter_flax_leaves(tree)]


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("model", ["resnet18", "gpt2_124m"])
def test_layer_plan_ef_rows_and_wire_bytes_equal_jax(devices, model, n):
    tree = model_tree(model)
    ref = jgs.build_layer_plan(tree, n)
    ours = gs.build_layer_plan(named(tree), n)
    assert ours == gs.LayerPlan(
        groups=tuple(gs.LayerGroup(g.name, g.leaf_slots, g.chunk_sizes)
                     for g in ref.groups), n_shards=n)
    assert ours.total_padded == ref.total_padded
    if model == "resnet18":
        assert [g.name for g in ours.groups] == ["fc"] + [
            f"stage{s}_block{b}" for s in range(1, 5) for b in (0, 1)] + [
            "stem_bn", "stem_conv"]
    mesh = build_mesh(MeshSpec(data=n), devices=devices[:n])
    for n_inner in (1, 2) if n % 2 == 0 else (1,):
        want = jax.eval_shape(lambda: jgs.ef_state_fsdp(
            tree, mesh, n, n_inner=n_inner))["ef"]
        got = gs.ef_state_fsdp(named(tree), n, n_inner,
                               torch.device("meta"))["ef"]
        assert {k: (n,) + tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    leaves = [leaf for _, leaf in iter_flax_leaves(tree)]
    for wire in gs.WIRE_DTYPES:
        slices = 2 if wire == "int8_hier" and n % 2 == 0 else 1
        assert gs.fsdp_gather_bytes(leaves, wire, n, slices) == \
            jgs.fsdp_gather_bytes(tree, wire, n, slices)
        for cfg in (dict(fsdp_explicit=True), dict(bucket_cap_mb=25.0),
                    dict()):
            cfg = dict(cfg, wire_dtype=wire, slices=slices)
            assert gs.wire_bytes_split_for_config(leaves, cfg, n) == \
                jgs.wire_bytes_split_for_config(tree, cfg, n)
    with pytest.raises(ValueError, match="do not factor"):
        gs.wire_bytes_split_for_config(leaves, dict(slices=n + 1), n)


# ---------------------------------------------------------------------------
# 2 gloo ranks: the shard gather and the trajectories
# ---------------------------------------------------------------------------


def shard_rows():
    rng = np.random.RandomState(5)
    return (rng.randn(2, 333) * rng.rand(2, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(devices, tmp_path_factory):
    runs = {name: jax_run(devices, 2, False, cfg) for name, cfg in CASES}
    jobs = {name: port_job(runs[name], False, cfg) for name, cfg in CASES}
    jobs["codec"] = ("codec", {"ops": [
        ("shard", "quantized_shard_all_gather", [shard_rows()])]})
    return runs, run_ranks(tmp_path_factory.mktemp("fsdp"), 2, jobs)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_shard_gather_on_2_ranks_equals_jax(devices, ranks):
    want = jax_codec(devices, 2, lambda x: jgs.quantized_shard_all_gather(
        x, ("data",), fused=False), shard_rows())[0]
    outs = [r["codec"]["shard"] for r in ranks[1]]
    for rank, got in enumerate(outs):
        np.testing.assert_allclose(got["out"][0], want[rank], rtol=0,
                                   atol=CODEC_RTOL * np.abs(want).max())
        (rows, q, s), = got["k1"]
        q_ref, s_ref = jgs._quantize_int8_rows(jnp.asarray(rows),
                                               fused=False)
        np.testing.assert_array_equal(q, np.asarray(q_ref))
        np.testing.assert_array_equal(bits(s), bits(s_ref))
    np.testing.assert_array_equal(outs[0]["out"][0], outs[1]["out"][0])


@pytest.mark.parametrize("name,cfg", CASES, ids=[c[0] for c in CASES])
def test_fsdp_trajectory_matches_jax_trainer(ranks, name, cfg):
    runs, port = ranks
    run = runs[name]
    rs = [r[name] for r in port]
    check_trajectory(run, rs, HOP[cfg.get("wire_dtype", "fp32")])
    sizes = [int(np.prod(x.shape)) for _, x in
             iter_flax_leaves(run["params"])]
    for r in rs:
        # at rest: parameters and moments padded/2 a rank
        assert r["at_rest"]["params"] == [-(-s // 2) for s in sizes]
        assert sorted(r["at_rest"]["opt"]) == sorted(
            s // 2 for s in run["opt_sizes"])
    if run["ef"] is not None:
        for rank, r in enumerate(rs):
            assert list(r["ef"]["ef"]) == list(run["ef"])
            check_ef_rows(list(r["ef"]["ef"].values()),
                          [v[rank] for v in run["ef"].values()])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

GPT2 = "vocab_size=50257,hidden_dim=32,depth=2,num_heads=2,max_position=32"
DP_CLI = ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
          GPT2, "--seq-len", "32", "--synthetic", "--synthetic-size", "32",
          "--epochs", "2", "--optimizer", "adamw", "--lr", "1e-3",
          "--batch-size", "2", "--print-freq", "2", "--fsdp-explicit",
          "--wire-dtype", "int8", "--no-telemetry"]


def test_one_rank_fsdp_is_the_replicated_passthrough(tmp_path, capsys):
    state = train.main(DP_CLI + ["--epochs", "1", "--output-dir",
                                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "NOTE: fsdp_explicit requested on a single batch shard — " \
           "nothing to shard; running the replicated update" in out
    assert "FSDP" not in out
    assert state.sharding is None and state.step == 16


def test_two_ranks_preempted_resumed_and_served(tmp_path, capsys):
    """2 ranks, FSDP on the int8 wire (8 steps an epoch): rank 1 gets
    SIGTERM at step 2; both stop at step 4 with a checkpoint, and the
    resumed run ends bitwise equal to the uninterrupted one on each rank
    (the at-rest chunks, the moments and the per-group residuals). The
    checkpoint holds whole flat-padded parameters; ``serving smoke
    --fsdp-explicit`` serves them unflattened, and refuses them without
    the flag."""
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
        assert {k for k in a if k.startswith("grad_sync/ef/")} == {
            "grad_sync/ef/block0", "grad_sync/ef/block1",
            "grad_sync/ef/ln_f", "grad_sync/ef/wpe", "grad_sync/ef/wte"}
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # the ranks hold different chunks at rest
    assert not np.array_equal(whole[0]["cli"]["state"]["model/ln_f.scale"],
                              whole[1]["cli"]["state"]["model/ln_f.scale"])
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [4, 8, 16]
    meta = mgr.metadata()
    assert meta["layout"] == "fsdp"
    params = torch.load(f"{ck}/16/params.pt", weights_only=True)
    shapes = meta["param_shapes"]
    for name, p in params.items():
        size = int(np.prod(shapes[name]))
        assert p.shape == (size + size % 2,)
    mgr.close()
    capsys.readouterr()
    serve = ["smoke", "--device", "cpu", "--ckpt-dir", ck,
             "--model-overrides", GPT2, "--buckets", "8,16",
             "--prompt-len", "6", "--output-dir", str(tmp_path / "serving")]
    report = run(serve + ["--fsdp-explicit"])
    assert "serving: checkpoint label=16 step=16 verified=True" in \
        capsys.readouterr().out
    served = report.engine._served
    for name, p in params.items():
        np.testing.assert_array_equal(
            served[name].reshape(-1).numpy(),
            p[:int(np.prod(shapes[name]))].numpy(), err_msg=name)
    with pytest.raises(ValueError, match="--zero1/--fsdp-explicit"):
        run(serve)
