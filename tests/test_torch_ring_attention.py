"""Ring attention (K6, ``ops/ring_attention.py``) against the JAX
package's ``ring_attention`` on ``MeshSpec(data=2, seq=4)`` (the 8-device
CPU mesh): the einsum ring (``use_pallas=False``) and the fused
ring+flash (``use_pallas=True``, the Pallas kernels in interpret mode,
as ``tests/test_attention.py::TestRingFlashFused`` runs them), causal and
not, forward and the gradients of sum(out * g), against the port's kernel
ring (``_RingFlash`` over the plain K3-K5 on the CPU) and its plain ring
(``_ring_body``, q-chunked). The port runs the four shards' schedule in
one process (an ``AxisLoop``); one spawned run of 4 gloo ranks holds the
rotation over a real process group to that loop.

Tolerances: the forward within FWD_ATOL = FWD_RTOL = 2e-5 (the JAX test's
own for fused vs reference), the gradients within GRAD_ATOL = GRAD_RTOL =
1e-4: float32 sums of the same blocks in other orders (per-block
log-sum-exp merges, interpret-mode tiles), ~1e-6 measured; a wrong mask,
offset or sentinel moves whole rows by O(1). The 4-rank run within
RANKS_ATOL = 1e-6 of the loop (the same arithmetic; autograd may add the
plain ring's gradient contributions in another order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.ops.ring_attention import (
    make_ring_attention_fn as jax_make_ring_attention_fn,
    ring_attention as jax_ring_attention,
)
from distributed_pytorch_training_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec, build_mesh as jax_build_mesh,
)
from distributed_pytorch_training_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_fwd_lse,
)
from distributed_pytorch_training_tpu_torch.parallel.collectives import (
    AxisLoop,
)
from distributed_pytorch_training_tpu_torch.parallel.mesh import (
    MeshSpec, build_mesh,
)

from _torch_dp_worker import run_ranks

ra = importlib.import_module(
    "distributed_pytorch_training_tpu_torch.ops.ring_attention")

B, S, H, D = 2, 64, 4, 16
N_SEQ = 4                          # S_loc = 16
FWD_ATOL = FWD_RTOL = 2e-5
GRAD_ATOL = GRAD_RTOL = 1e-4
RANKS_ATOL = 1e-6


def inputs(seed=0, s=S, h=H):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, s, h, D).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jax_mesh(devices):
    return jax_build_mesh(JaxMeshSpec(data=2, seq=N_SEQ), devices=devices)


@pytest.fixture(scope="module")
def jax_runs(jax_mesh):
    """{(use_pallas, causal): (out, dq, dk, dv)} of the JAX ring."""
    q, k, v, g = inputs()
    runs = {}
    for use_pallas in (False, True):
        for causal in (False, True):
            def f(q, k, v):
                return jax_ring_attention(q, k, v, jax_mesh, causal=causal,
                                          use_pallas=use_pallas,
                                          block_q=16, block_k=16)

            out, vjp = jax.vjp(jax.jit(f), q, k, v)
            runs[(use_pallas, causal)] = [np.asarray(x) for x in
                                          (out, *vjp(jnp.asarray(g)))]
    return runs


def port_ring(causal, use_kernels, q_chunk=8, seed=0, n=N_SEQ,
              dtype=torch.float32):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in inputs(seed))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ra.ring_attention(q, k, v, {"seq": n}, causal,
                            q_chunk=q_chunk, use_kernels=use_kernels)
    grads = torch.autograd.grad(out, (q, k, v), g)
    return [t.detach() for t in (out, *grads)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["ring-flash", "ring-body"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jax-einsum", "jax-pallas"])
def test_ring_matches_jax(jax_runs, use_pallas, use_kernels, causal):
    want = jax_runs[(use_pallas, causal)]
    got = port_ring(causal, use_kernels)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=FWD_ATOL,
                               rtol=FWD_RTOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_lse_is_the_global_lse(causal):
    """The merged lse of the kernel ring and of the plain ring, shard by
    shard, is K3's lse on the whole sequence (what K4 and K5 read)."""
    q, k, v, _ = (torch.from_numpy(a) for a in inputs(1))
    _, lse = flash_attention_fwd_lse(q, k, v, causal)
    axis = AxisLoop(N_SEQ)
    scale = 1.0 / D ** 0.5
    blocks = [x.chunk(N_SEQ, 1) for x in (q, k, v)]
    for fn in (ra.ring_flash_fwd,
               lambda *a: ra._ring_body(*a, q_chunk=8)):
        outs, lses = fn(*blocks, axis, causal, scale)
        np.testing.assert_allclose(torch.cat(lses, -1).numpy(), lse.numpy(),
                                   atol=FWD_ATOL, rtol=FWD_RTOL)


def test_one_shard_is_the_flash_kernels_bitwise():
    q, k, v, g = (torch.from_numpy(a).requires_grad_() for a in inputs(2))
    got = port_ring(True, True, seed=2, n=1)
    out = flash_attention(q, k, v, True)
    want = [out, *torch.autograd.grad(out, (q, k, v), g)]
    for a, b in zip(got, want):
        assert torch.equal(a, b.detach())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_block_schedule_is_the_jax_modules(monkeypatch, causal):
    """Shard i runs K3, then K4 + K5, on its diagonal block (the causal
    kernel under causal) and on each past block (the full kernel);
    causal rings skip the future blocks, full rings run all n."""
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = ra.flash_attention_fwd_lse, ra.flash_attention_bwd

    def rec_fwd(q, k, v, causal_blk, scale):
        calls["fwd"].append(causal_blk)
        return fwd(q, k, v, causal_blk, scale)

    def rec_bwd(q, k, v, out, lse, g, causal_blk, scale):
        calls["bwd"].append(causal_blk)
        return bwd(q, k, v, out, lse, g, causal_blk, scale)

    monkeypatch.setattr(ra, "flash_attention_fwd_lse", rec_fwd)
    monkeypatch.setattr(ra, "flash_attention_bwd", rec_bwd)
    port_ring(causal, True)
    if causal:
        # ring step t: shard i holds block i - t; blocks of shard i: i + 1
        want = [t == 0 for t in range(N_SEQ) for i in range(t, N_SEQ)]
    else:
        want = [False] * N_SEQ * N_SEQ
    assert calls["fwd"] == want and calls["bwd"] == want


def test_chunked_plain_ring_equals_one_block():
    """``q_chunk`` below the shard length (chunks under checkpoint) gives
    the one-block plain ring's numbers."""
    one = port_ring(True, False, q_chunk=512)
    chunked = port_ring(True, False, q_chunk=8)
    for a, b in zip(one, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_bf16_ring_within_bf16_of_flash():
    """bf16 operands: the ring merges its blocks in float32 and rounds
    once, so it stays within a few bf16 steps (2**-8) of the flash
    kernels' plain versions on the whole sequence."""
    got = port_ring(True, True, seed=3, dtype=torch.bfloat16)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in inputs(3))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, True)
    want = [out, *torch.autograd.grad(out, (q, k, v), g)]
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        a, b = a.float(), b.detach().float()
        assert (a - b).abs().max() <= 1e-2 * b.abs().max()


def test_explicit_masks_are_refused_as_in_jax(jax_mesh):
    q = torch.zeros(1, 8, 2, 4)
    mesh = build_mesh(MeshSpec(data=-1), world=1, rank=0)
    with pytest.raises(ValueError) as ours:
        ra.make_ring_attention_fn(mesh, causal=True)(q, q, q,
                                                     mask=torch.ones(1))
    with pytest.raises(ValueError) as ref:
        jax_make_ring_attention_fn(jax_mesh, causal=True)(
            jnp.zeros((2, 8, 2, 4)), jnp.zeros((2, 8, 2, 4)),
            jnp.zeros((2, 8, 2, 4)), mask=jnp.ones(1))
    assert str(ours.value) == str(ref.value)


CASES = [("ring-flash causal", "ring", True, True, "float32"),
         ("ring-flash full", "ring", False, True, "float32"),
         ("ring-body causal", "ring", True, False, "float32"),
         ("ring-flash causal bf16", "ring", True, True, "bfloat16")]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    q, k, v, g = inputs(4)
    return run_ranks(tmp_path_factory.mktemp("ring"), N_SEQ, {
        "sp": ("seq_attention", dict(q=q, k=k, v=v, g=g, cases=CASES))})


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_four_gloo_ranks_equal_the_loop(four_ranks, case):
    label, _, causal, use_kernels, dtype = case
    want = port_ring(causal, use_kernels, seed=4,
                     dtype=getattr(torch, dtype))
    for name, full in zip(("out", "dq", "dk", "dv"), want):
        full = full.float().numpy()
        got = np.concatenate([r["sp"][label][("out", "dq", "dk", "dv")
                                             .index(name)]
                              for r in four_ranks], axis=1)
        np.testing.assert_allclose(got, full, atol=RANKS_ATOL, rtol=0,
                                   err_msg=f"{label} {name}")


def test_ppermute_ring_over_gloo(four_ranks):
    """Rank i's block arrives at rank i + shift, whatever the dtype; a
    bf16 block travels as its bytes beside a float32 one."""
    n = N_SEQ
    stamp = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, res in enumerate(four_ranks):
        for shift, got in res["sp"]["rotate"].items():
            np.testing.assert_array_equal(got, stamp + 10 * ((r - shift)
                                                             % n))
        a, b = res["sp"]["rotate_many"]
        np.testing.assert_array_equal(a, stamp + 10 * ((r - 1) % n))
        np.testing.assert_array_equal(b, (stamp + 10 * ((r - 1) % n))[:1])
