"""Collectives over ``torch.distributed`` (the JAX package's
parallel/collectives.py): the same tiled semantics, on the process group
instead of mesh axis names.

Every function is the identity in one process (no process group, or a
group of one), the reference's single-process passthrough. They use the
list form of ``all_gather`` and ``all_to_all_single``, which gloo also
runs on CUDA tensors (its list-form ``all_to_all`` refuses them), and
never modify their input. ``all_sum`` is the one differentiable
collective: the sum over ranks that XLA inserts when a jitted step reads
a data-sharded batch (global-batch BatchNorm).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def world_size(group: Group = None) -> int:
    """Ranks in ``group`` (the default group when None); 1 without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def psum(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """SUM all-reduce; a new tensor."""
    if world_size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllSum(torch.autograd.Function):
    """SUM all-reduce whose backward all-reduces the incoming gradient:
    every rank's output is the same sum, so the gradient of a rank's
    input is the sum of every rank's gradient of that output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_sum(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Differentiable SUM over ranks (the psum of a jitted step over a
    data-sharded batch); the identity on one rank, with no collective."""
    if world_size(group) == 1:
        return x
    return _AllSum.apply(x, group)


def all_gather(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Concatenate every rank's ``x`` along axis 0, in rank order (the
    tiled ``lax.all_gather``)."""
    n = world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def all_to_all(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Tiled all-to-all along axis 0: chunk j of every rank goes to rank j,
    which concatenates what it receives in sender order. The leading
    dimension must divide by the world size."""
    n = world_size(group)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} not "
                         f"divisible by {n} ranks")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def psum_scatter(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Tiled SUM reduce-scatter along axis 0 (``lax.psum_scatter(...,
    tiled=True)``): rank j gets the sum over ranks of every rank's chunk
    j. Built from one `all_to_all` and a sum of the received chunks in
    rank order, so the result does not depend on the backend's reduction
    order (on 2 ranks it is bitwise the JAX package's); gloo runs it on
    CUDA tensors. bf16 chunks travel as their bytes (gloo's all-to-all
    takes no 16-bit type) and are summed in float32, rounded to bf16 once,
    as XLA's CPU reduce-scatter sums them (bitwise on 4 ranks too)."""
    n = world_size(group)
    if n == 1:
        return x
    bf16 = x.dtype == torch.bfloat16
    wire = x.contiguous().view(torch.int8) if bf16 else x
    recv = all_to_all(wire, group).view(x.dtype).reshape(n, -1)
    out = recv[0].float() if bf16 else recv[0]
    for i in range(1, n):
        out = out + recv[i]
    return out.to(x.dtype)


def reduce_scalar(x: Union[float, int, torch.Tensor], op: str = "sum",
                  group: Group = None) -> float:
    """Host-level scalar reduction across ranks (the reference's
    ``reduce_tensor``): the identity in one process."""
    val = float(x)
    n = world_size(group)
    if n == 1:
        return val
    # NCCL moves CUDA tensors only
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    gathered = all_gather(torch.tensor([val], dtype=torch.float64,
                                       device=dev), group)
    if op == "sum":
        return float(gathered.sum())
    if op == "max":
        return float(gathered.max())
    if op == "mean":
        return float(gathered.mean())
    raise ValueError(f"unknown op {op!r}")
