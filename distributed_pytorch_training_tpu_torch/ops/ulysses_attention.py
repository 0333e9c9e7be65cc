"""Ulysses attention: sequence parallelism by head sharding (the JAX
package's ops/ulysses_attention.py).

One tiled all-to-all re-shards the activations from sequence-sharded to
head-sharded, every shard computes full-sequence attention for its heads,
and the mirrored all-to-all restores the sequence sharding:

    (B, S/n, H, D)  --all_to_all-->  (B, S, H/n, D)
        full-sequence attention of the local heads
    (B, S, H/n, D)  --all_to_all-->  (B, S/n, H, D)

The local attention is the flash kernels (K3 forward, K4 and K5 backward;
on CPU tensors their plain versions), which take every length, or with
``use_kernels=False`` the plain ``_local_attention``. The number of heads
must divide by the axis size (times the ``model`` axis, as in the JAX
module). The all-to-alls are ``parallel/collectives.py``'s: over the
``seq`` process group (``AxisGroup``, differentiable: the backward is the
mirrored all-to-all) or, every shard in one process, a loop
(``AxisLoop``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..parallel.collectives import AxisGroup, AxisLoop
from ..parallel.mesh import MODEL, SEQ
from .flash_attention import flash_attention

NEG_INF = float(np.finfo(np.float32).min)


def _local_attention(q, k, v, q0: int, causal: bool,
                     sm_scale: float) -> torch.Tensor:
    """Plain attention over the full sequence for a local head group, in
    float32; q may be a sub-block starting at global row ``q0`` (causal
    masking)."""
    s_q, s_k = q.shape[1], k.shape[1]
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * sm_scale
    if causal:
        rows = q0 + torch.arange(s_q, device=q.device)[:, None]
        cols = torch.arange(s_k, device=q.device)[None, :]
        logits = torch.where(rows >= cols, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", weights, v.float()).to(q.dtype)


def _check_heads(heads: int, n: int, model_n: int, axis_name: str) -> None:
    if heads % (n * model_n):
        raise ValueError(
            f"ulysses attention needs num_heads ({heads}) divisible by "
            f"{axis_name!r} x 'model' axis sizes ({n} x {model_n}); use ring "
            "attention when heads are too few")


def _ulysses(qs: Sequence[torch.Tensor], ks, vs, axis, causal: bool,
             scale: float, use_kernels: bool) -> List[torch.Tensor]:
    """The Ulysses body over the shards ``axis`` holds."""
    # seq-sharded -> head-sharded: split heads (axis 2), gather seq (axis 1)
    qh, kh, vh = (axis.all_to_all(xs, 2, 1) for xs in (qs, ks, vs))
    outs = []
    for q, k, v in zip(qh, kh, vh):
        if use_kernels:
            outs.append(flash_attention(q, k, v, causal, scale).to(q.dtype))
        else:
            outs.append(_local_attention(q, k, v, 0, causal, scale))
    # head-sharded -> seq-sharded: split seq (axis 1), gather heads (axis 2)
    return axis.all_to_all(outs, 1, 2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      axis_name: str = SEQ,
                      use_kernels: bool = True) -> torch.Tensor:
    """Head-sharded sequence-parallel attention over the (B, S, H, D)
    operands, S split into ``mesh.shape[axis_name]`` shards (``mesh``: a
    ``parallel/mesh.py`` Mesh, or its shape as a dict), every shard in
    this process (an ``AxisLoop``): the JAX ``ulysses_attention`` on one
    process."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    shape = dict(getattr(mesh, "shape", mesh))
    n = shape[axis_name]
    _check_heads(q.shape[2], n, shape.get(MODEL, 1), axis_name)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by "
                         f"{n} {axis_name!r} shards")
    outs = _ulysses(q.chunk(n, 1), k.chunk(n, 1), v.chunk(n, 1),
                    AxisLoop(n), causal, scale, use_kernels)
    return torch.cat(outs, 1)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, axis=None,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              axis_name: str = SEQ,
                              use_kernels: bool = True,
                              model_n: int = 1) -> torch.Tensor:
    """``ulysses_attention`` for a caller that holds one shard: this
    rank's (B, S_loc, H, D) blocks over ``axis`` (an ``AxisGroup``; None:
    the default group's). Under tensor parallelism (``model_n`` > 1) the
    blocks hold this model rank's H/M heads, and the heads' check is
    JAX's on the global count."""
    axis = axis if axis is not None else AxisGroup()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    _check_heads(q.shape[2] * model_n, axis.size, model_n, axis_name)
    return _ulysses([q], [k], [v], axis, causal, scale, use_kernels)[0]


def make_ulysses_attention_fn(mesh, causal: bool, axis_name: str = SEQ):
    """Adapter matching models.layers' ``attention_fn(q, k, v, mask,
    dtype)`` over this rank's sequence shard, on ``mesh``'s
    ``axis_name`` line (at this rank's model index: its local heads on a
    model mesh), the local attention the flash kernels."""
    axis = mesh.axis(axis_name)
    model_n = mesh.shape[MODEL]

    def attention_fn(q, k, v, mask=None, dtype=torch.float32):
        if mask is not None:
            raise ValueError(
                "ulysses attention handles causal masking internally; "
                "explicit masks require the XLA attention path")
        return ulysses_attention_sharded(
            q, k, v, axis, causal, axis_name=axis_name,
            model_n=model_n).to(dtype)

    return attention_fn
