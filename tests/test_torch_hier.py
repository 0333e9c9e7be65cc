"""The port's two-tier ``int8_hier`` wire against the JAX package's, on
4 gloo ranks factored as 2 slices x 2 (the JAX mesh ``slice=2,data=2``):
the fast-major chunk ownership, the slow-tier residual rows on
ResNet-18's and GPT-2 124M's shapes, every scatter and gather codec (the
flat ones too, on the 4 ranks) against the same functions inside
``shard_map``, and 3-step Trainer trajectories through the bucketed
reducer and through ZeRO-1 against the JAX Trainer; ``--slices 1`` is
the flat fp32 wire bitwise.

Tolerances: ``_torch_sharded.py``'s docstring for the trajectories (the
hier codec is two hops on the reducer, the s8 scatter and the s8 update
gather under ZeRO-1). The codecs: every K1 call's codes and scales
bitwise the JAX quantizer's on the same rows, the outputs within
CODEC_RTOL = 1e-5 of their largest magnitude: the fast tier's fp32
reduce-scatter sums 2 rows (one rounding either way), the dequant-sum
and the residual's multiply-add may round in another order than the
compiled reference, and an int8 code computed from such a sum can then
sit one code step away only where it lies on a rounding boundary
(none on these inputs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import grad_sync as jgs
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import iter_flax_leaves
from distributed_pytorch_training_tpu_torch.parallel import grad_sync as gs

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401
from _torch_sharded import (HOP, check_ef_rows, check_trajectory,
                            jax_codec, jax_run, port_job)

CODEC_RTOL = 1e-5
N, SLICES = 4, 2
JSPEC = jgs.HierSpec(slice_axis="slice", fast_axes=("data",), n_slices=2,
                     n_inner=2)
CAP = 0.25
CASES = [
    ("reducer", dict(wire_dtype="int8_hier", slices=2, bucket_cap_mb=CAP)),
    ("zero1", dict(wire_dtype="int8_hier", slices=2, zero1=True)),
]
HOPS = {"reducer": 2 * HOP["int8"], "zero1": 2 * HOP["int8"]}


def test_fast_major_ownership_equals_jax(devices):
    want = jax_codec(devices, N, lambda x: x * 0 + lax.axis_index(
        JSPEC.hier_axes), np.zeros((N, 1), np.int32), slices=SLICES)[0]
    assert [gs.hier_owner(r, N, SLICES) for r in range(N)] == \
        want[:, 0].tolist() == [0, 2, 1, 3]
    assert [gs.hier_coords(r, N, SLICES) for r in range(N)] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    # the slow tier on the data axis: slices become the fast index
    assert [gs.hier_owner(r, N, SLICES, "data") for r in range(N)] == \
        [0, 1, 2, 3]
    with pytest.raises(ValueError, match=">= 2 slices"):
        gs.HierSpec("slice", n_slices=1, n_inner=4)


@pytest.mark.parametrize("n,slices", [(2, 2), (3, 3), (4, 2), (4, 4)])
@pytest.mark.parametrize("model", ["resnet18", "gpt2_124m"])
def test_hier_residual_rows_equal_jax(devices, model, n, slices):
    if model == "resnet18":
        m, x = jax_get_model("resnet18"), jnp.zeros((1, 32, 32, 3))
    else:
        m, x = jax_get_model("gpt2_124m"), jnp.zeros((1, 8), jnp.int32)
    tree = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x,
                                         train=False))["params"]
    spec = MeshSpec.parse(f"slice={slices},data={n // slices}")
    mesh = build_mesh(spec, devices=devices[:n])
    leaves = [torch.empty(leaf.shape, device="meta")
              for _, leaf in iter_flax_leaves(tree)]
    for cap in (0.0, 25.0):
        want = jax.eval_shape(lambda: jgs.ef_state_bucketed(
            tree, mesh, n, cap, "int8_hier", n_slices=slices))["ef"]
        got = gs.ef_state_bucketed(leaves, n, cap, "int8_hier",
                                   torch.device("meta"), n_slices=slices)
        assert (n,) + tuple(got["ef"].shape) == tuple(want.shape)
    with pytest.raises(ValueError, match="feasible factorization"):
        gs.ef_state_bucketed(leaves, n, 0.0, "int8_hier", n_slices=1)


# ---------------------------------------------------------------------------
# the codecs on 4 ranks
# ---------------------------------------------------------------------------

S = 1001                      # the reducer's flat gradient
PADDED = 4 * 251              # one flat-padded leaf on 4 ranks


def inputs():
    rng = np.random.RandomState(11)
    flat = (rng.randn(N, S) * rng.rand(N, 1) * 3).astype(np.float32)
    plan = jgs.build_bucket_plan({"a": np.zeros(S)}, 400 * 4 / 2 ** 20)
    hres = (rng.randn(N, jgs.padded_total_size(plan, N) // 2)
            * 0.01).astype(np.float32)
    v = (rng.randn(N, PADDED) * rng.rand(N, 1) * 3).astype(np.float32)
    vres = (rng.randn(N, PADDED) * 0.01).astype(np.float32)
    sres = (rng.randn(N, PADDED // 2) * 0.01).astype(np.float32)
    old = rng.randn(PADDED).astype(np.float32)
    olds = np.stack([old.reshape(N, -1)[gs.hier_owner(r, N, SLICES)]
                     for r in range(N)])
    new = olds + (rng.randn(N, PADDED // N) * 1e-3).astype(np.float32)
    return dict(flat=flat, plan=plan, hres=hres, v=v, vres=vres, sres=sres,
                old=np.stack([old] * N), olds=olds, new=new,
                flat_olds=old.reshape(N, -1))


def codec_ops():
    x = inputs()
    plan = gs.BucketPlan(x["plan"].total_size, x["plan"].bounds)
    return [
        ("hier-sum", "reduce_flat",
         [x["flat"], plan, N, "int8_hier", x["hres"], None, "HIER"]),
        ("hier-scatter", "hier_psum_scatter", [x["v"], "HIER", x["sres"]]),
        ("hier-delta", "hier_delta_all_gather",
         [x["new"], x["olds"], x["old"], "HIER"]),
        ("hier-shard", "hier_shard_all_gather", [x["new"], "HIER"]),
        ("scatter-fp32", "compressed_psum_scatter", [x["v"], N, "fp32"]),
        ("scatter-bf16", "compressed_psum_scatter", [x["v"], N, "bf16"]),
        ("scatter-int8", "compressed_psum_scatter",
         [x["v"], N, "int8", x["vres"]]),
        ("delta", "quantized_delta_all_gather",
         [x["new"] - x["olds"] + x["flat_olds"], x["flat_olds"],
          x["old"]]),
        ("shard", "quantized_shard_all_gather", [x["new"]]),
    ]


def jax_codecs(devices):
    x = inputs()
    axes = ("slice", "data")

    def run(fn, *args, n_out=1):
        return jax_codec(devices, N, fn, *args, n_out=n_out, slices=SLICES)

    return {
        "hier-sum": run(lambda f, r: jgs.reduce_flat(
            f, x["plan"], axes, N, "int8_hier", r, fused=False, hier=JSPEC),
            x["flat"], x["hres"], n_out=2),
        "hier-scatter": run(lambda a, r: jgs.hier_psum_scatter(
            a, JSPEC, r, fused=False), x["v"], x["sres"], n_out=2),
        "hier-delta": run(lambda a, b, c: jgs.hier_delta_all_gather(
            a, b, c, JSPEC, fused=False), x["new"], x["olds"], x["old"]),
        "hier-shard": run(lambda a: jgs.hier_shard_all_gather(
            a, JSPEC, fused=False), x["new"]),
        "scatter-fp32": run(lambda a: jgs.compressed_psum_scatter(
            a, axes, N, "fp32")[0], x["v"]),
        "scatter-bf16": run(lambda a: jgs.compressed_psum_scatter(
            a, axes, N, "bf16")[0], x["v"]),
        "scatter-int8": run(lambda a, r: jgs.compressed_psum_scatter(
            a, axes, N, "int8", r, fused=False), x["v"], x["vres"],
            n_out=2),
        "delta": run(lambda a, b, c: jgs.quantized_delta_all_gather(
            a, b, c, axes, fused=False),
            x["new"] - x["olds"] + x["flat_olds"], x["flat_olds"],
            x["old"]),
        "shard": run(lambda a: jgs.quantized_shard_all_gather(
            a, axes, fused=False), x["new"]),
    }


@pytest.fixture(scope="module")
def ranks(devices, tmp_path_factory):
    """Every 4-rank leg in one run: the JAX runs first."""
    runs = {name: jax_run(devices, N, False, cfg, slices=SLICES)
            for name, cfg in CASES}
    runs["fp32-cap"] = jax_run(devices, N, False,
                               dict(bucket_cap_mb=CAP), slices=SLICES)
    jobs = {name: port_job(runs[name], False, cfg) for name, cfg in CASES}
    jobs["fp32-cap"] = port_job(runs["fp32-cap"], False,
                                dict(bucket_cap_mb=CAP))
    jobs["slices1"] = port_job(runs["fp32-cap"], False, dict(
        bucket_cap_mb=CAP, wire_dtype="int8_hier", slices=1))
    jobs["codec"] = ("codec", {"ops": codec_ops(), "slices": SLICES})
    return runs, run_ranks(tmp_path_factory.mktemp("hier"), N, jobs)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


REPLICATED = ("hier-sum", "hier-delta", "hier-shard", "delta", "shard")


@pytest.mark.parametrize("op", [o[0] for o in codec_ops()])
def test_codecs_on_4_ranks_equal_jax(devices, ranks, op):
    want = jax_codecs(devices)[op]
    outs = [r["codec"][op] for r in ranks[1]]
    for rank, got in enumerate(outs):
        assert len(got["out"]) >= len(want)
        for ours, ref in zip(got["out"], want):
            ref = ref[rank]
            np.testing.assert_allclose(
                ours, ref, rtol=0, atol=CODEC_RTOL * np.abs(ref).max())
        for rows, q, s in got["k1"]:
            q_ref, s_ref = jgs._quantize_int8_rows(jnp.asarray(rows),
                                                   fused=False)
            np.testing.assert_array_equal(q, np.asarray(q_ref))
            np.testing.assert_array_equal(bits(s), bits(s_ref))
        assert (len(got["k1"]) > 0) == (op.startswith("hier")
                                        or op in ("scatter-int8", "delta",
                                                  "shard"))
    if op in REPLICATED:
        for got in outs[1:]:
            np.testing.assert_array_equal(got["out"][0], outs[0]["out"][0])


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,cfg", CASES, ids=[c[0] for c in CASES])
def test_hier_trajectory_matches_jax_trainer(ranks, name, cfg):
    runs, port = ranks
    run = runs[name]
    rs = [r[name] for r in port]
    check_trajectory(run, rs, HOPS[name])
    ref = run["ef"]
    if name == "reducer":
        for rank, r in enumerate(rs):
            check_ef_rows([r["ef"]["ef"]], [ref[rank]])
    else:
        leaves_ref = jax.tree_util.tree_leaves(ref)
        for rank, r in enumerate(rs):
            check_ef_rows(list(r["ef"]["ef"].values()),
                          [b[rank] for b in leaves_ref])
            # moments at rest: padded/4 of every leaf
            assert sorted(r["at_rest"]["opt"]) == sorted(
                s // N for s in run["opt_sizes"])


def test_one_slice_is_the_flat_fp32_wire_bitwise(ranks):
    for r in ranks[1]:
        a, b = r["slices1"], r["fp32-cap"]
        assert a["metrics"] == b["metrics"] and a["ef"] == {}
        for tree in ("params", "batch_stats"):
            for (pa, x), (pb, y) in zip(iter_flax_leaves(a[tree]),
                                        iter_flax_leaves(b[tree])):
                assert pa == pb
                np.testing.assert_array_equal(x, y)


def test_one_slice_logs_the_jax_note(tmp_path, capsys):
    state = train.main([
        "--device", "cpu", "--model", "resnet18", "--model-overrides",
        "num_filters=4", "--synthetic", "--synthetic-size", "16",
        "--batch-size", "8", "--epochs", "1", "--no-telemetry",
        "--wire-dtype", "int8_hier", "--output-dir", str(tmp_path)])
    assert state.step == 2
    assert "NOTE: int8_hier requested without a multi-slice mesh (axis " \
           "'slice' size 1) — running the flat fp32 wire" in \
        capsys.readouterr().out
