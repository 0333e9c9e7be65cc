"""The port's gradient-sync path against the JAX package's: the int8
dequant-sum (K2)'s plain version, the bucket plan and wire accounting on
ResNet-18's flax tree, the flat gradient layout, and ``reduce_flat`` on 2
and 3 gloo ranks against ``reduce_flat`` inside ``shard_map`` on a CPU
mesh of as many devices.

The ranks are subprocesses (``tests/_torch_dp_worker.py``, no JAX) that
meet at a ``file://`` store under the test's tmp_path; one module-scoped
run per world size serves every reducer leg.

Tolerances:
* K2's plain version against the JAX composed form
  (``_dequant_sum_rows(fused=False)``) as it runs inside a compiled step:
  bitwise. XLA turns its multiply and row sum into one chain of fused
  multiply-adds, rows 0..n-1 in order, which the port reproduces exactly
  (``fma_f32``). Op by op, outside jit, the reference rounds the products
  first, and the two differ by an ulp.
* against the Pallas kernel in interpret mode: within twice the
  reassociation bound, 2 * max(n - 1, 1) * 2**-24 * sum_i |q_i s_i| per
  column (each order of a float32 sum of n terms is within
  (n - 1) * 2**-24 * sum |terms| of the exact sum; one FMA in place of a
  product and a sum stays inside it too); the interpreted kernel orders or
  fuses the sum differently (its own bitwise pin against the composed form
  fails on this tree, ROADMAP queue 3).
* reduce_flat on 2 ranks, and on 3 (the padded multihop layout):
  bitwise, sums, codes, scales and residuals: the codec is bitwise the
  reference's compiled one, K2's FMA chain included, and gloo moves bytes
  unchanged. The bf16 wire too: on 2 ranks each element's sum is one
  rounding of a + b to bf16, which does not depend on the order, and
  gloo and XLA both add in float32 and round once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.ops.quantize import (
    dequant_sum_rows_fused,
)
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import grad_sync as jgs
from distributed_pytorch_training_tpu.parallel.collectives import shard_map
from distributed_pytorch_training_tpu_torch.convert import (
    flax_ordered,
    iter_flax_leaves,
    load_flax_params,
)
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.ops.quantize import (
    dequant_sum_rows,
    dequant_sum_rows_ref,
)
from distributed_pytorch_training_tpu_torch.parallel import grad_sync as gs

from _torch_dp_worker import run_ranks

RESNET18_PARAMS = 11_181_642
U = 2.0 ** -24


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# K2's plain version
# ---------------------------------------------------------------------------

DEQUANT_SHAPES = [(1, 1000), (2, 1001), (2, 5), (2, 1), (3, 1001),
                  (8, 777), (4, 100_000)]


jitted_dequant = jax.jit(
    lambda q, s: jgs._dequant_sum_rows(q, s, fused=False))


def codes_and_scales(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) \
        * (rng.rand(shape[0], 1).astype(np.float32) * 10 + 0.01)
    q, s = jgs._quantize_int8_rows(jnp.asarray(x), fused=False)
    return np.array(q), np.array(s)


@pytest.mark.parametrize("shape", DEQUANT_SHAPES, ids=str)
def test_dequant_plain_bitwise_equals_jax_composed(shape):
    q, s = codes_and_scales(shape)
    ours = dequant_sum_rows(torch.from_numpy(q), torch.from_numpy(s))
    assert ours.dtype == torch.float32 and ours.shape == (shape[1],)
    want = jitted_dequant(jnp.asarray(q), jnp.asarray(s))
    np.testing.assert_array_equal(bits(ours), bits(want))


@pytest.mark.parametrize("shape", DEQUANT_SHAPES, ids=str)
def test_dequant_plain_within_reassociation_of_pallas(shape):
    q, s = codes_and_scales(shape, seed=1)
    ours = dequant_sum_rows_ref(torch.from_numpy(q),
                                torch.from_numpy(s)).numpy()
    want = np.asarray(dequant_sum_rows_fused(jnp.asarray(q), jnp.asarray(s)))
    bound = 2 * max(shape[0] - 1, 1) * U * np.abs(
        q.astype(np.float64) * s[:, None]).sum(0)
    assert np.all(np.abs(ours - want) <= bound)


def test_dequant_zero_scales_and_checks():
    q = torch.tensor([[-3, 0, 5], [7, -1, 0]], dtype=torch.int8)
    zero = dequant_sum_rows(q, torch.zeros(2))
    # 0 + (-3 * 0) is +0.0, as XLA's reduction from its 0 init gives
    np.testing.assert_array_equal(bits(zero), bits(np.zeros(3)))
    want = jitted_dequant(jnp.asarray(q.numpy()), jnp.zeros(2))
    np.testing.assert_array_equal(bits(zero), bits(want))
    assert dequant_sum_rows(q[:0], torch.zeros(0)).tolist() == [0.0] * 3
    with pytest.raises(TypeError):
        dequant_sum_rows(q.float(), torch.ones(2))
    with pytest.raises(ValueError):
        dequant_sum_rows(q, torch.ones(3))
    with pytest.raises(ValueError):
        dequant_sum_rows(q.t(), torch.ones(3))


# ---------------------------------------------------------------------------
# bucket plan, wire accounting, flat layout on ResNet-18's flax tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resnet18_shapes():
    """ResNet-18 (10 classes, the ImageNet stem)'s flax params as shapes."""
    model = jax_get_model("resnet18")
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        train=False))["params"]


@pytest.mark.parametrize("cap", [0.0, 25.0, 4.0, 1e-3])
def test_bucket_plan_equals_jax_on_resnet18(resnet18_shapes, cap):
    ref = jgs.build_bucket_plan(resnet18_shapes, cap)
    ours = gs.build_bucket_plan(
        [leaf for _, leaf in iter_flax_leaves(resnet18_shapes)], cap)
    assert ours.total_size == ref.total_size == RESNET18_PARAMS
    assert ours.bounds == ref.bounds
    assert ours.total_bytes == ref.total_bytes
    # the port model's parameters in flax order make the same plan
    model = get_model("resnet18")
    params = [p for _, p in flax_ordered(model.named_parameters())]
    assert gs.build_bucket_plan(params, cap) == ours
    for n in (1, 2, 3, 8):
        assert gs.padded_bucket_bounds(ours, n) == \
            jgs.padded_bucket_bounds(ref, n)
        assert gs.padded_total_size(ours, n) == jgs.padded_total_size(ref, n)
        for wire in gs.WIRE_DTYPES:
            slices = 2 if wire == "int8_hier" and n % 2 == 0 else 1
            assert gs.wire_bytes_per_replica(ours, wire, n, slices) == \
                jgs.wire_bytes_per_replica(ref, wire, n, slices)


def test_bucket_sizes_of_the_smoke_configurations(resnet18_shapes):
    plan = gs.build_bucket_plan(
        [leaf for _, leaf in iter_flax_leaves(resnet18_shapes)], 25.0)
    assert plan.bucket_sizes() == (6_553_600, 4_628_042)
    assert gs.padded_total_size(
        gs.build_bucket_plan([np.zeros(RESNET18_PARAMS)], 0.0), 2) \
        == 2 * 5_590_821


def test_port_leaf_order_and_shapes_are_flax(resnet18_shapes):
    ours = [(name, tuple(p.shape)) for name, p in
            flax_ordered(get_model("resnet18").named_parameters())]
    ref = [(".".join(path), tuple(leaf.shape))
           for path, leaf in iter_flax_leaves(resnet18_shapes)]
    assert ours == ref
    # iter_flax_leaves walks jax's tree_leaves order
    assert [tuple(leaf.shape) for leaf in
            jax.tree_util.tree_leaves(resnet18_shapes)] == \
        [shape for _, shape in ours]


def test_flat_layout_bitwise_equals_jax_flatten_tree():
    model = jax_get_model("resnet18", num_filters=8)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)),
                           train=False)
    params = jax.device_get(variables["params"])
    ours = get_model("resnet18", num_filters=8)
    load_flax_params(ours, params, jax.device_get(variables["batch_stats"]))
    leaves = [p for _, p in flax_ordered(ours.named_parameters())]
    flat = gs.flatten_tree(leaves).detach()
    np.testing.assert_array_equal(bits(flat), bits(jgs.flatten_tree(params)))
    back = gs.unflatten_tree(flat, leaves)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))


# ---------------------------------------------------------------------------
# reduce_flat on gloo ranks against shard_map
# ---------------------------------------------------------------------------

S = 1001                       # odd: the multihop layout pads per bucket
CAP = 400 * 4 / 1024 ** 2      # 400-element buckets: 400, 400, 201
REDUCE_CASES = [("fp32", CAP), ("bf16", 0.0), ("bf16", CAP), ("int8", 0.0),
                ("int8", CAP), ("int8_multihop", 0.0), ("int8_multihop", CAP)]


def reduce_inputs(wire, cap, n, seed=0):
    plan = jgs.build_bucket_plan({"a": np.zeros(S)}, cap)
    rng = np.random.RandomState(seed)
    contribs = (rng.randn(n, S) * rng.rand(n, 1) * 3).astype(np.float32)
    residual = None
    if wire in gs.EF_WIRE_DTYPES:
        size = (jgs.padded_total_size(plan, n) if wire == "int8_multihop"
                else S)
        residual = (rng.randn(n, size) * 0.01).astype(np.float32)
    return plan, contribs, residual


def jax_reduce(plan, n, wire, contribs, residual, calls=2):
    mesh = build_mesh(MeshSpec(data=n), devices=jax.devices()[:n])
    if residual is None:
        def body(x):
            out, _ = jgs.reduce_flat(x.reshape(-1), plan, ("data",), n, wire)
            return out[None]

        fn = jax.jit(shard_map(body, mesh, in_specs=(P("data"),),
                               out_specs=P("data")))
        out = np.asarray(fn(contribs))
        return [out] * calls, [None] * calls

    def body(x, ef):
        out, new = jgs.reduce_flat(x.reshape(-1), plan, ("data",), n, wire,
                                   ef.reshape(-1), fused=False)
        return out[None], new[None]

    fn = jax.jit(shard_map(body, mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data"))))
    sums, residuals, ef = [], [], jnp.asarray(residual)
    for _ in range(calls):
        out, ef = fn(contribs, ef)
        sums.append(np.asarray(out))
        residuals.append(np.asarray(ef))
    return sums, residuals


def reduce_jobs(n):
    jobs = {}
    for wire, cap in REDUCE_CASES:
        if n == 3 and wire != "int8_multihop":
            continue
        plan, contribs, residual = reduce_inputs(wire, cap, n)
        jobs[f"{wire}-{cap}"] = ("reduce", dict(
            total=plan.total_size, bounds=plan.bounds, wire=wire,
            contribs=contribs, residual=residual, calls=2))
    jobs["scalars"] = ("scalars", {})
    return jobs


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("reduce2"), 2, reduce_jobs(2))


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("reduce3"), 3, reduce_jobs(3))


def check_k1_calls(res, wire, plan, n, contribs, residual):
    """Every quantization on the wire: its codes and scales bitwise the
    JAX quantizer's on the same rows, and the first call's hop-1 rows the
    carried contribution (bucket + residual)."""
    per_call = plan.n_buckets * (2 if wire == "int8_multihop" else 1)
    assert len(res["k1"]) == 2 * per_call
    for rows, q, s in res["k1"]:
        q_ref, s_ref = jgs._quantize_int8_rows(jnp.asarray(rows),
                                               fused=False)
        np.testing.assert_array_equal(q, np.asarray(q_ref))
        np.testing.assert_array_equal(bits(s), bits(s_ref))
    pb = (jgs.padded_bucket_bounds(plan, n) if wire == "int8_multihop"
          else plan.bounds)
    step = 2 if wire == "int8_multihop" else 1
    for k, (a, b) in enumerate(zip(plan.bounds, plan.bounds[1:])):
        rows = res["k1"][k * step][0]
        v = np.pad(contribs[a:b], (0, pb[k + 1] - pb[k] - (b - a)))
        carried = (v + residual[pb[k]:pb[k + 1]]).astype(np.float32)
        np.testing.assert_array_equal(bits(rows.reshape(-1)), bits(carried))


@pytest.mark.parametrize("wire,cap", REDUCE_CASES,
                         ids=[f"{w}-{'cap' if c else 'one-bucket'}"
                              for w, c in REDUCE_CASES])
def test_reduce_flat_2_ranks_bitwise_equals_jax(ranks2, wire, cap):
    plan, contribs, residual = reduce_inputs(wire, cap, 2)
    sums, residuals = jax_reduce(plan, 2, wire, contribs, residual)
    for rank, res in enumerate(r[f"{wire}-{cap}"] for r in ranks2):
        for call in range(2):
            np.testing.assert_array_equal(bits(res["sums"][call]),
                                          bits(sums[call][rank]))
            if residual is None:
                assert res["residuals"][call] is None
            else:
                np.testing.assert_array_equal(
                    bits(res["residuals"][call]),
                    bits(residuals[call][rank]))
        if residual is not None:
            check_k1_calls(res, wire, plan, 2, contribs[rank],
                           residual[rank])
        else:
            assert res["k1"] == []
    if wire == "bf16":
        # the wire's sum is the bf16 sum of the bf16 contributions, a
        # rounding of the float32 sum: within one bf16 step of it
        exact = contribs.sum(0)
        assert sums[0].dtype == np.float32
        assert np.all(np.abs(sums[0][0] - exact) <= 2.0 ** -7 * (
            np.abs(contribs).sum(0)))
        assert not np.array_equal(sums[0][0], exact)
    if wire == "int8":
        # error feedback: what the wire dropped is carried, not lost
        sent = contribs.sum(0) * 2 + residual.sum(0)[:S]
        got = sums[0][0] + sums[1][0] + residuals[1].sum(0)[:S]
        np.testing.assert_allclose(got, sent, atol=1e-4)


@pytest.mark.parametrize("cap", [0.0, CAP], ids=["one-bucket", "cap"])
def test_reduce_flat_3_ranks_multihop_padded_layout(ranks3, cap):
    wire, n = "int8_multihop", 3
    plan, contribs, residual = reduce_inputs(wire, cap, n)
    assert gs.padded_total_size(plan, n) > S      # padding in play
    sums, residuals = jax_reduce(plan, n, wire, contribs, residual)
    for rank, res in enumerate(r[f"{wire}-{cap}"] for r in ranks3):
        for call in range(2):
            np.testing.assert_array_equal(bits(res["residuals"][call]),
                                          bits(residuals[call][rank]))
            np.testing.assert_array_equal(bits(res["sums"][call]),
                                          bits(sums[call][rank]))
        # hop 1 is this rank's data alone: bitwise
        hop1 = res["k1"][0::2][:plan.n_buckets]
        for k, (rows, q, s) in enumerate(hop1):
            q_ref, s_ref = jgs._quantize_int8_rows(jnp.asarray(rows),
                                                   fused=False)
            np.testing.assert_array_equal(q, np.asarray(q_ref))
            np.testing.assert_array_equal(bits(s), bits(s_ref))
    assert all(np.array_equal(ranks3[0][f"{wire}-{cap}"]["sums"][1],
                              r[f"{wire}-{cap}"]["sums"][1])
               for r in ranks3)      # replicated on every rank


def test_reduce_scalar_over_gloo_ranks(ranks2, ranks3):
    for ranks, n in ((ranks2, 2), (ranks3, 3)):
        for r in ranks:
            assert r["scalars"] == {"sum": n * (n + 1) / 2, "max": n,
                                    "mean": (n + 1) / 2}


def test_reduce_flat_refuses_unported_wires():
    plan = gs.build_bucket_plan([torch.zeros(10)], 0.0)
    # int8_hier without its spec or its residual: JAX's ValueErrors
    with pytest.raises(ValueError, match="int8_hier wire needs a HierSpec"):
        gs.reduce_flat(torch.zeros(10), plan, 2, "int8_hier",
                       torch.zeros(10))
    spec = gs.HierSpec("slice", n_slices=2, n_inner=1)
    with pytest.raises(ValueError, match="slow-tier error-feedback"):
        gs.reduce_flat(torch.zeros(10), plan, 2, "int8_hier", hier=spec)
    with pytest.raises(ValueError, match="unknown wire"):
        gs.reduce_flat(torch.zeros(10), plan, 2, "fp8")
    with pytest.raises(ValueError, match="residual"):
        gs.reduce_flat(torch.zeros(10), plan, 2, "int8_multihop")


def test_single_process_reduce_is_identity_and_ef_layout():
    """One process: the collectives pass through, so fp32 returns the
    contribution and int8 its own dequantized codes."""
    x = torch.from_numpy(np.random.RandomState(2).randn(S).astype(
        np.float32))
    plan = gs.build_bucket_plan([x], CAP)
    out, _ = gs.reduce_flat(x, plan, 1, "fp32")
    assert torch.equal(out, x)
    out, new = gs.reduce_flat(x, plan, 1, "bf16")
    assert new is None and torch.equal(out, x.bfloat16().float())
    ef = gs.ef_state_bucketed([x], 1, CAP, "int8")["ef"]
    out, new = gs.reduce_flat(x, plan, 1, "int8", ef)
    # x = dequantized codes + residual, up to the residual's rounding
    torch.testing.assert_close(out + new, x, rtol=0, atol=1e-6)
    assert gs.ef_state_bucketed([x], 3, CAP, "int8_multihop")["ef"].shape \
        == (jgs.padded_total_size(jgs.build_bucket_plan(
            {"a": np.zeros(S)}, CAP), 3),)
