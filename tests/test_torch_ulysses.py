"""Ulysses attention (``ops/ulysses_attention.py``) against the JAX
package's ``ulysses_attention`` on ``MeshSpec(data=2, seq=4)`` (the
8-device CPU mesh), causal and not, forward and the gradients of
sum(out * g): at S 64 the JAX module runs its flash kernels (Pallas,
interpret mode), at S 136 (no 128-multiple) its einsum
``_local_attention``; the port runs the flash kernels (their plain
versions on the CPU) or, with ``use_kernels=False``, its own
``_local_attention``. The port runs the four shards in one process (an
``AxisLoop``); one spawned run of 4 gloo ranks holds the all-to-alls over
a real process group to that loop. The heads check and the mask refusal
raise the JAX module's messages.

Tolerances: the forward within FWD_ATOL = FWD_RTOL = 2e-5 (the JAX test's
own for fused vs reference, as the ring test holds it), the gradients
within GRAD_ATOL = GRAD_RTOL = 1e-4 (float32 sums in other orders; both
sides repeat bitwise from run to run and differ by at most 1.5e-6; a
wrong head or sequence block moves whole rows by O(1)); the 4-rank run
bitwise the loop (all-to-alls move bytes; the arithmetic is the same).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.ops.ulysses_attention import (
    make_ulysses_attention_fn as jax_make_ulysses_attention_fn,
    ulysses_attention as jax_ulysses_attention,
)
from distributed_pytorch_training_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec, build_mesh as jax_build_mesh,
)
from distributed_pytorch_training_tpu_torch.ops.ulysses_attention import (
    make_ulysses_attention_fn,
    ulysses_attention,
)
from distributed_pytorch_training_tpu_torch.parallel.collectives import (
    AxisLoop, all_to_all,
)
from distributed_pytorch_training_tpu_torch.parallel.mesh import (
    MeshSpec, build_mesh,
)

from _torch_dp_worker import run_ranks

B, H, D = 2, 4, 16
N_SEQ = 4
FWD_ATOL = FWD_RTOL = 2e-5
GRAD_ATOL = GRAD_RTOL = 1e-4


def inputs(s, seed=0, h=H):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, s, h, D).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jax_mesh(devices):
    return jax_build_mesh(JaxMeshSpec(data=2, seq=N_SEQ), devices=devices)


@pytest.fixture(scope="module")
def jax_runs(jax_mesh):
    """{(s, causal): (out, dq, dk, dv)} of the JAX Ulysses."""
    runs = {}
    for s in (64, 136):
        q, k, v, g = inputs(s)
        for causal in (False, True):
            def f(q, k, v):
                return jax_ulysses_attention(q, k, v, jax_mesh,
                                             causal=causal)

            out, vjp = jax.vjp(jax.jit(f), q, k, v)
            runs[(s, causal)] = [np.asarray(x) for x in
                                 (out, *vjp(jnp.asarray(g)))]
    return runs


def port_ulysses(s, causal, use_kernels, seed=0, dtype=torch.float32):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in inputs(s, seed))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ulysses_attention(q, k, v, {"seq": N_SEQ, "model": 1}, causal,
                            use_kernels=use_kernels)
    grads = torch.autograd.grad(out, (q, k, v), g)
    return [t.detach() for t in (out, *grads)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["flash", "local"])
@pytest.mark.parametrize("s", [64, 136], ids=["jax-pallas", "jax-einsum"])
def test_ulysses_matches_jax(jax_runs, s, use_kernels, causal):
    want = jax_runs[(s, causal)]
    got = port_ulysses(s, causal, use_kernels)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=FWD_ATOL,
                               rtol=FWD_RTOL, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_heads_not_divisible_raise_the_jax_message(jax_mesh):
    q = np.zeros((B, 64, 2, D), np.float32)
    with pytest.raises(ValueError) as ref:
        jax_ulysses_attention(q, q, q, jax_mesh, causal=True)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError) as ours:
        ulysses_attention(t, t, t, {"seq": N_SEQ, "model": 1}, True)
    assert str(ours.value) == str(ref.value)
    assert "divisible by 'seq' x 'model' axis sizes (4 x 1)" in str(
        ours.value)


def test_explicit_masks_are_refused_as_in_jax(jax_mesh):
    q = torch.zeros(1, 8, 4, 4)
    mesh = build_mesh(MeshSpec(data=-1), world=1, rank=0)
    with pytest.raises(ValueError) as ours:
        make_ulysses_attention_fn(mesh, causal=True)(q, q, q,
                                                     mask=torch.ones(1))
    with pytest.raises(ValueError) as ref:
        jax_make_ulysses_attention_fn(jax_mesh, causal=True)(
            jnp.zeros((2, 8, 4, 4)), jnp.zeros((2, 8, 4, 4)),
            jnp.zeros((2, 8, 4, 4)), mask=jnp.ones(1))
    assert str(ours.value) == str(ref.value)


def test_loop_all_to_all_is_the_tiled_all_to_all():
    """The loop's all-to-all: shard j receives chunk j of every shard's
    split axis, concatenated along the other axis in sender order."""
    xs = [torch.arange(24.0).reshape(1, 2, 12) + 100 * i for i in range(3)]
    ys = AxisLoop(3).all_to_all(xs, 2, 1)
    for j, y in enumerate(ys):
        want = torch.cat([x[:, :, 4 * j:4 * (j + 1)] for x in xs], 1)
        assert torch.equal(y, want)
    back = AxisLoop(3).all_to_all(ys, 1, 2)
    for x, y in zip(xs, back):
        assert torch.equal(x, y)
    # one process: the identity
    assert all_to_all(xs[0], None, 2, 1) is xs[0]


CASES = [("flash causal", "ulysses", True, True, "float32"),
         ("flash full", "ulysses", False, True, "float32"),
         ("local causal", "ulysses", True, False, "float32"),
         ("flash causal bf16", "ulysses", True, True, "bfloat16")]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    q, k, v, g = inputs(64, seed=5)
    return run_ranks(tmp_path_factory.mktemp("ulysses"), N_SEQ, {
        "sp": ("seq_attention", dict(q=q, k=k, v=v, g=g, cases=CASES))})


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_four_gloo_ranks_equal_the_loop(four_ranks, case):
    label, _, causal, use_kernels, dtype = case
    want = port_ulysses(64, causal, use_kernels, seed=5,
                        dtype=getattr(torch, dtype))
    for i, (name, full) in enumerate(zip(("out", "dq", "dk", "dv"), want)):
        got = np.concatenate([r["sp"][label][i] for r in four_ranks],
                             axis=1)
        np.testing.assert_array_equal(got, full.float().numpy(),
                                      err_msg=f"{label} {name}")


def test_bf16_all_to_all_over_gloo_moves_bytes(four_ranks):
    """A bf16 tensor split on axis 1 and gathered on axis 2 over 4 gloo
    ranks (gloo's all-to-all takes no 16-bit type: it travels as bytes)."""
    n = N_SEQ
    for r, res in enumerate(four_ranks):
        blocks = [np.arange(n * 4, dtype=np.float32).reshape(1, n * 2, 2)
                  + 10 * src for src in range(n)]
        want = np.concatenate([b[:, 2 * r:2 * (r + 1)] for b in blocks],
                              axis=2)
        np.testing.assert_array_equal(res["sp"]["all_to_all"], want)
