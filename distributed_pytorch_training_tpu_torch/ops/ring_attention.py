"""Ring attention: sequence parallelism over the mesh's ``seq`` axis (the
JAX package's ops/ring_attention.py). K6 of the kernel table: a composite
of the flash kernels K3-K5, with no kernel of its own.

The sequence is split into n shards. Each shard keeps its Q block, the K/V
blocks rotate one hop a step (``parallel/collectives.py::ppermute_ring``),
and the normalized partials merge by the float32 log-sum-exp rule. The
inner block has two forms:

* ``_RingFlash``, the kernel path: K3 (``flash_attention_fwd_lse``) on each
  ring step's block (the causal kernel on the diagonal, the full kernel on
  past blocks; future blocks are skipped), merged by ``logaddexp`` of the
  lse with the float32 minimum as the empty sentinel (``NEG_INF``; with
  -inf the merge weights would be exp(-inf - -inf) = NaN). Its backward
  rotates K/V again and runs K4 and K5 (``flash_attention_bwd``) on each
  block against the final output and the GLOBAL lse (p = exp(s - lse)
  gives each block's exact share of the softmax), with the dK/dV
  accumulators rotating beside K/V, so each shard's gradients arrive home
  after n hops. The last K/V rotation of each pass (the forward's, which
  the JAX module makes and never reads, and the backward's) is skipped:
  no value changes. On CPU tensors K3-K5 are their plain versions, as for
  every kernel wrapper of the port;
* ``_ring_body``, the plain version: einsum blocks in Q row chunks of
  ``q_chunk`` under the online-softmax merge, causal masking from global
  offsets (every block computed, future ones fully masked), each chunk
  under ``torch.utils.checkpoint`` when there are several (the JAX
  module's ``jax.checkpoint``), autograd through the rotation.

The shards live on an axis (``parallel/collectives.py``): an
``AxisGroup``, this rank's shard over the ``seq`` process group, or an
``AxisLoop``, every shard in one process, a loop standing in for the
rotation. The ring code runs the schedule of every shard it holds, step
by step, in the JAX module's order.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import AxisGroup, AxisLoop
from ..parallel.mesh import SEQ
from .flash_attention import flash_attention_bwd, flash_attention_fwd_lse

NEG_INF = float(np.finfo(np.float32).min)

Blocks = Sequence[torch.Tensor]


def _scale_of(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])


def _chunk_size(s_loc: int, q_chunk: int) -> int:
    """The largest divisor of ``s_loc`` in [q_chunk/2, q_chunk], else the
    whole shard (the JAX module's rule)."""
    c = min(q_chunk, s_loc)
    while s_loc % c and c > q_chunk // 2:
        c -= 1
    return c if s_loc % c == 0 else s_loc


def _lse_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S) -> lse's (B*H, 1, S)."""
    b, h, s = x.shape
    return x.reshape(b * h, 1, s)


def _ring_body(qs: Blocks, ks: Blocks, vs: Blocks, axis, causal: bool,
               sm_scale: float, q_chunk: int = 512
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The plain ring over the shards ``axis`` holds (``qs[a]`` is shard
    ``axis.index[a]``'s (B, S_loc, H, D) block): (outputs in q's dtype,
    lse (B*H, 1, S_loc) float32), differentiable by autograd."""
    n = axis.size
    b, s_loc, h, d = qs[0].shape
    c = _chunk_size(s_loc, q_chunk)
    nc = s_loc // c
    dev = qs[0].device

    def block_update(q_blk, k_cur, v_cur, m, l, acc, row0, my, j):
        """Online-softmax update of one (c, S_loc) score block. q_blk:
        (B, c, H, D) float32, scaled; m, l: (B, H, c); acc (B, H, c, D)."""
        s = torch.einsum("bshd,bthd->bhst", q_blk, k_cur.float())
        if causal:
            rows = my * s_loc + row0 + torch.arange(c, device=dev)[:, None]
            cols = j * s_loc + torch.arange(s_loc, device=dev)[None, :]
            valid = rows >= cols
            s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(valid, p, 0.0)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(-1)
        acc_new = (acc * alpha[..., None]
                   + torch.einsum("bhst,bthd->bhsd", p, v_cur.float()))
        return m_new, l_new, acc_new

    def update(*args):
        if nc > 1 and torch.is_grad_enabled():
            # recompute each chunk in the backward instead of keeping its p
            return checkpoint(block_update, *args, use_reentrant=False)
        return block_update(*args)

    scale = sm_scale
    qf = [q.float() * scale for q in qs]
    state = [[(torch.full((b, h, c), NEG_INF, device=dev),
               torch.zeros((b, h, c), device=dev),
               torch.zeros((b, h, c, d), device=dev)) for _ in range(nc)]
             for _ in qs]
    kv = [(k, v) for k, v in zip(ks, vs)]
    for t in range(n):
        for a, my in enumerate(axis.index):
            j = (my - t) % n
            k_cur, v_cur = kv[a]
            for i in range(nc):
                q_blk = qf[a][:, i * c:(i + 1) * c]
                state[a][i] = update(q_blk, k_cur, v_cur, *state[a][i],
                                     i * c, my, j)
        if t < n - 1:
            kv = axis.shift(kv)
    outs, lses = [], []
    for a, q in enumerate(qs):
        m = torch.cat([st[0] for st in state[a]], -1)
        l = torch.cat([st[1] for st in state[a]], -1)
        acc = torch.cat([st[2] for st in state[a]], -2)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
        lses.append(_lse_layout(m + torch.log(torch.clamp(l, min=1e-30))))
    return outs, lses


def _weight(w: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """(B*H, 1, S) -> (B, S, H, 1), a merge weight over the output."""
    return w.reshape(b, h, -1).transpose(1, 2)[..., None]


def ring_flash_fwd(qs: Blocks, ks: Blocks, vs: Blocks, axis, causal: bool,
                   sm_scale: float
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The kernel ring's forward (``_ring_flash_fwd_impl``): (outputs in
    q's dtype, global lse (B*H, 1, S_loc) float32) of every shard
    ``axis`` holds."""
    n = axis.size
    b, s_loc, h, d = qs[0].shape
    o = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
         for q in qs]
    lse = [torch.full((b * h, 1, s_loc), NEG_INF, device=q.device)
           for q in qs]
    kv = [(k, v) for k, v in zip(ks, vs)]
    for t in range(n):
        for a, my in enumerate(axis.index):
            j = (my - t) % n
            if causal and j > my:
                continue               # a future block: no weight
            o_j, lse_j = flash_attention_fwd_lse(
                qs[a], kv[a][0], kv[a][1], causal and j == my, sm_scale)
            lse_new = torch.logaddexp(lse[a], lse_j)
            o[a] = (o[a] * _weight(torch.exp(lse[a] - lse_new), b, h)
                    + o_j.float() * _weight(torch.exp(lse_j - lse_new), b, h))
            lse[a] = lse_new
        if t < n - 1:
            kv = axis.shift(kv)
    return [x.to(q.dtype) for x, q in zip(o, qs)], lse


def ring_flash_bwd(qs: Blocks, ks: Blocks, vs: Blocks, outs: Blocks,
                   lses: Blocks, gs: Blocks, axis, causal: bool,
                   sm_scale: float
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                              List[torch.Tensor]]:
    """The kernel ring's backward (``_ring_flash_vjp_bwd``): (dq, dk, dv)
    of every shard ``axis`` holds, in the dtypes of q, k, v; K4 and K5 on
    each block against the final ``outs`` and the global ``lses``."""
    n = axis.size
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    acc = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device))
           for k, v in zip(ks, vs)]
    for t in range(n):
        for a, my in enumerate(axis.index):
            j = (my - t) % n
            if causal and j > my:
                continue
            k_cur, v_cur, dk, dv = acc[a]
            dq_j, dk_j, dv_j = flash_attention_bwd(
                qs[a], k_cur, v_cur, outs[a], lses[a], gs[a],
                causal and j == my, sm_scale)
            dq[a] = dq[a] + dq_j.float()
            acc[a] = (k_cur, v_cur, dk + dk_j.float(), dv + dv_j.float())
        if t < n - 1:
            acc = axis.shift(acc)
        else:   # the accumulators' last hop home; K/V are done
            acc = [(None, None, *x)
                   for x in axis.shift([x[2:] for x in acc])]
    return ([x.to(q.dtype) for x, q in zip(dq, qs)],
            [x[2].to(k.dtype) for x, k in zip(acc, ks)],
            [x[3].to(v.dtype) for x, v in zip(acc, vs)])


class _RingFlash(torch.autograd.Function):
    """The JAX module's ``_ring_flash`` custom_vjp over the shards an axis
    holds: ``apply(axis, causal, scale, *qs, *ks, *vs)`` returns the
    outputs."""

    @staticmethod
    def forward(ctx, axis, causal, sm_scale, *qkv):
        m = len(qkv) // 3
        qs, ks, vs = qkv[:m], qkv[m:2 * m], qkv[2 * m:]
        outs, lses = ring_flash_fwd(qs, ks, vs, axis, causal, sm_scale)
        ctx.save_for_backward(*qkv, *outs, *lses)
        ctx.axis, ctx.causal, ctx.sm_scale, ctx.m = axis, causal, sm_scale, m
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        m = ctx.m
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:m], saved[m:2 * m], saved[2 * m:3 * m]
        outs, lses = saved[3 * m:4 * m], saved[4 * m:]
        gs = [torch.zeros_like(o) if g is None else g.contiguous()
              for g, o in zip(gs, outs)]
        dq, dk, dv = ring_flash_bwd(qs, ks, vs, outs, lses, gs, ctx.axis,
                                    ctx.causal, ctx.sm_scale)
        return (None, None, None, *dq, *dk, *dv)


def _ring(qs, ks, vs, axis, causal, scale, q_chunk, use_kernels):
    if use_kernels:
        return list(_RingFlash.apply(axis, causal, scale, *qs, *ks, *vs))
    return _ring_body(qs, ks, vs, axis, causal, scale, q_chunk)[0]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   causal: bool = False, sm_scale: Optional[float] = None,
                   axis_name: str = SEQ, q_chunk: int = 512,
                   use_kernels: bool = True) -> torch.Tensor:
    """Sequence-parallel attention over the (B, S, H, D) operands, S split
    into ``mesh.shape[axis_name]`` shards (``mesh``: a ``parallel/mesh.py``
    Mesh, or its shape as a dict), every shard's schedule run in this
    process (an ``AxisLoop``): the JAX ``ring_attention`` on one
    process. ``use_kernels`` picks the inner block: True (the default)
    the kernel ring ``_RingFlash`` (the port's kernels take every
    length; on CPU tensors their plain versions), False the plain
    ``_ring_body``."""
    n = dict(getattr(mesh, "shape", mesh)).get(axis_name, 1)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by "
                         f"{n} {axis_name!r} shards")
    outs = _ring(q.chunk(n, 1), k.chunk(n, 1), v.chunk(n, 1), AxisLoop(n),
                 causal, _scale_of(q, sm_scale), q_chunk, use_kernels)
    return torch.cat(outs, 1)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, axis=None, causal: bool = False,
                           sm_scale: Optional[float] = None,
                           q_chunk: int = 512,
                           use_kernels: bool = True) -> torch.Tensor:
    """``ring_attention``'s body for a caller that holds one shard: q, k,
    v are this rank's (B, S_loc, H, D) blocks, ``axis`` the ring (an
    ``AxisGroup``; None: the default group's). Same inner-block choice as
    ``ring_attention``."""
    axis = axis if axis is not None else AxisGroup()
    return _ring([q], [k], [v], axis, causal, _scale_of(q, sm_scale),
                 q_chunk, use_kernels)[0]


def make_ring_attention_fn(mesh, causal: bool, axis_name: str = SEQ):
    """Adapter matching models.layers' ``attention_fn(q, k, v, mask,
    dtype)`` over this rank's sequence shard (the model's activations are
    sequence-sharded, ``models/gpt2.py``): the kernel ring over
    ``mesh``'s ``axis_name`` line. Explicit masks are refused: causal structure is
    positional, from global offsets."""
    axis = mesh.axis(axis_name)

    def attention_fn(q, k, v, mask=None, dtype=torch.float32):
        if mask is not None:
            raise ValueError(
                "ring attention handles causal masking internally; explicit "
                "masks require the XLA attention path")
        return ring_attention_sharded(q, k, v, axis, causal).to(dtype)

    return attention_fn
