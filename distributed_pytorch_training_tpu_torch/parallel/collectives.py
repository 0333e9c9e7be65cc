"""Collectives over ``torch.distributed`` (the JAX package's
parallel/collectives.py): the same tiled semantics, on the process group
instead of mesh axis names.

Every function is the identity in one process (no process group, or a
group of one), the reference's single-process passthrough. They use the
list form of ``all_gather`` and ``all_to_all_single``, which gloo also
runs on CUDA tensors (its list-form ``all_to_all`` refuses them), and
never modify their input. ``all_sum`` is differentiable: the sum over
ranks that XLA inserts when a jitted step reads a data-sharded batch
(global-batch BatchNorm).

Sequence parallelism moves blocks along one mesh axis: ``ppermute_ring``
(ring attention's rotation) and the tiled ``all_to_all`` (Ulysses). An
axis is an ``AxisGroup`` (this rank holds one shard; the collectives run
over its process group, differentiably: the backward of a rotation is
the reverse rotation, of an all-to-all the mirrored one) or an
``AxisLoop`` (one process holds every shard, and a loop stands in for
the collectives: the tests run a whole ring in one process that way).

Tensor parallelism (megatron, over the mesh's ``model`` axis) has its
region operators here: ``copy_to_tp`` (identity forward, SUM backward)
and ``reduce_from_tp`` (SUM forward, identity backward), each an autograd
Function over a `TpAxis`, and the parallel-vocab
cross-entropy (``TpShardedLogits``, ``tp_parallel_cross_entropy``).
``gather_on_use`` is the ``fsdp`` axis's (and the MoE layer's sequence
gather's) autograd form: an all-gather along one dim in the forward, a
reduce-scatter back along it in the backward (each rank keeps the sum
over the group of its own slice); ``FsdpShard`` marks a parameter held
as its slice, which ``gathered`` reads whole.
``SOLO`` is the group of one rank: every collective over it is the
identity, as over a mesh line of one rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


class _Solo:
    """The group of this rank alone (a mesh line of one rank, beside other
    ranks): ``world_size`` is 1, so every collective here is the
    identity over it."""

    def __repr__(self) -> str:
        return "SOLO"


SOLO = _Solo()


def world_size(group: Group = None) -> int:
    """Ranks in ``group`` (the default group when None); 1 without one."""
    if group is SOLO or not (dist.is_available() and dist.is_initialized()):
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


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat int8 tensor (gloo's
    all-to-all takes no 16-bit type; bytes travel for every dtype)."""
    return x.contiguous().view(-1).view(torch.int8)


def all_to_all(x: torch.Tensor, group: Group = None, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``): ``x`` splits
    into n chunks along ``split_axis``, chunk j goes to rank j, which
    concatenates what it receives along ``concat_axis`` in sender order.
    ``split_axis`` must divide by the world size. 16-bit chunks travel as
    their bytes."""
    n = world_size(group)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{x.shape[split_axis]} not divisible by {n} ranks")
    send = torch.stack(x.chunk(n, split_axis)) if split_axis else x
    if send.element_size() == 2:
        wire = _as_bytes(send)
        recv = torch.empty_like(wire)
        dist.all_to_all_single(recv, wire, group=group)
        recv = recv.view(x.dtype).view(send.shape)
    else:
        recv = torch.empty_like(send, memory_format=torch.contiguous_format)
        dist.all_to_all_single(recv, send.contiguous(), group=group)
    if split_axis == 0 and concat_axis == 0:
        return recv
    if split_axis == 0:
        recv = recv.reshape(n, -1, *x.shape[1:])
    return torch.cat(recv.unbind(0), dim=concat_axis)


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


# ---------------------------------------------------------------------------
# sequence parallelism: the ring rotation and the differentiable forms
# ---------------------------------------------------------------------------


def ppermute_ring(x: torch.Tensor, group: Group = None,
                  shift: int = 1) -> torch.Tensor:
    """Rotate ``x`` around the ring of ``group``: rank i's ``x`` goes to
    rank (i + shift) % n, and the result is what rank (i - shift) % n
    sent. One ``all_to_all_single`` on every backend, as `all_to_all`:
    its splits send the whole block, as bytes, to one rank and nothing to
    the others (gloo's send and receive take no CUDA tensors)."""
    n = world_size(group)
    if n == 1 or shift % n == 0:
        return x
    me = dist.get_rank(group)
    dst, src = (me + shift) % n, (me - shift) % n
    x = x.contiguous()
    wire = _as_bytes(x)
    recv = torch.empty_like(wire)
    send_sizes, recv_sizes = [0] * n, [0] * n
    send_sizes[dst] = recv_sizes[src] = wire.numel()
    dist.all_to_all_single(recv, wire, recv_sizes, send_sizes, group=group)
    return recv.view(x.dtype).view(x.shape)


def ppermute_ring_many(xs: Sequence[torch.Tensor], group: Group = None,
                       shift: int = 1) -> List[torch.Tensor]:
    """`ppermute_ring` of several tensors (any dtypes) as one message:
    their bytes packed into one buffer."""
    if world_size(group) == 1 or len(xs) == 1:
        return [ppermute_ring(x, group, shift) for x in xs]
    parts = [_as_bytes(x) for x in xs]
    recv = ppermute_ring(torch.cat(parts), group, shift)
    out = []
    for x, part in zip(xs, recv.split([p.numel() for p in parts])):
        out.append(part.view(x.dtype).view(x.shape))
    return out


class _Rotate(torch.autograd.Function):
    """`ppermute_ring_many` whose backward rotates the gradients back."""

    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(ppermute_ring_many(xs, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        return (None, None,
                *ppermute_ring_many(grads, ctx.group, -ctx.shift))


class _AllToAll(torch.autograd.Function):
    """The tiled `all_to_all`; its backward is the mirrored all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return all_to_all(g, ctx.group, concat_axis, split_axis), None, \
            None, None


class AxisGroup:
    """A mesh axis over the ranks of ``group`` (the default group when
    None), this rank holding one shard: ``index`` is that shard, as a
    tuple of one. The collectives are differentiable."""

    def __init__(self, group: Group = None):
        self.group = group
        self.size = world_size(group)
        self.index = (dist.get_rank(group) if self.size > 1 else 0,)

    def shift(self, blocks: Sequence[Sequence[torch.Tensor]],
              shift: int = 1) -> List[Tuple[torch.Tensor, ...]]:
        """``blocks[a]``, the tensors of held shard a, to shard
        index + shift; returns what arrives, in the same structure. A
        shard's tensors travel as one message (`ppermute_ring_many`)."""
        if self.size == 1:
            return [tuple(b) for b in blocks]
        (mine,) = blocks
        return [tuple(_Rotate.apply(self.group, shift, *mine))]

    def all_to_all(self, xs: Sequence[torch.Tensor], split_axis: int,
                   concat_axis: int) -> List[torch.Tensor]:
        """The tiled `all_to_all` of each held shard's ``xs[a]``."""
        return [_AllToAll.apply(x, self.group, split_axis, concat_axis)
                if self.size > 1 else x for x in xs]


class AxisLoop:
    """Every shard of an ``n``-way mesh axis in this process: a list holds
    one block per shard, and a loop stands in for the collectives."""

    def __init__(self, n: int):
        self.group = None
        self.size = n
        self.index = tuple(range(n))

    def shift(self, blocks: Sequence[Sequence[torch.Tensor]],
              shift: int = 1) -> List[Tuple[torch.Tensor, ...]]:
        return [tuple(blocks[(i - shift) % self.size])
                for i in range(self.size)]

    def all_to_all(self, xs: Sequence[torch.Tensor], split_axis: int,
                   concat_axis: int) -> List[torch.Tensor]:
        n = self.size
        if xs[0].shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of size "
                             f"{xs[0].shape[split_axis]} not divisible by "
                             f"{n} ranks")
        parts = [x.chunk(n, split_axis) for x in xs]
        return [torch.cat([parts[src][dst] for src in range(n)], concat_axis)
                for dst in range(n)]


# ---------------------------------------------------------------------------
# tensor parallelism: megatron's region operators and the parallel-vocab
# cross-entropy (the JAX package's custom_vjp forms)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpAxis:
    """One mesh axis as this rank sees it: ``size`` shards, this rank's
    ``index`` among them, the ranks' process ``group``. Named for the
    ``model`` axis, its first use; the ``pipe`` axis (the pipeline's
    stages) and the ``expert`` axis (the MoE layers' experts) use it too
    (``Mesh.axis_shard``)."""

    size: int
    index: int = 0
    group: Group = None


def _sum_over(x: torch.Tensor, group: Group) -> torch.Tensor:
    """SUM all-reduce into a new tensor. 16-bit values are summed in
    float32 and rounded once (on 2 ranks bitwise a 16-bit add; gloo on
    CUDA tensors takes no 16-bit sum), so every rank gets the same
    bits."""
    if x.dtype in (torch.bfloat16, torch.float16):
        out = x.float()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out.to(x.dtype)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: TpAxis) -> torch.Tensor:
    """Megatron's ``f``, at each parallel region's input (the qkv and fc1
    projections' input, the tied head's): the identity forward, the SUM
    over the model axis in the backward, so every upstream consumer gets
    the whole cotangent instead of this shard's partial."""
    if tp.size == 1:
        return x
    return _CopyToTp.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TpAxis) -> torch.Tensor:
    """Megatron's ``g``: the SUM of the row-parallel partials over the
    model axis in the forward (the one all-reduce of a residual join),
    the identity in the backward."""
    if tp.size == 1:
        return x
    return _ReduceFromTp.apply(x, tp.group)


@dataclasses.dataclass
class TpShardedLogits:
    """This shard's logit COLUMNS, ``local`` = full[..., lo:lo + rows)
    with ``lo = tp.index * vocab_rows``: what the vocab-parallel tied head
    returns in place of the whole logits (``models/gpt2.py``). The task
    branches on the type and takes `tp_parallel_cross_entropy`."""

    local: torch.Tensor
    tp: TpAxis
    vocab_rows: int
    vocab_size: int

    def map_local(self, fn) -> "TpShardedLogits":
        """The same shards, ``fn`` applied to the local columns (the
        task's next-token shift)."""
        return TpShardedLogits(fn(self.local), self.tp, self.vocab_rows,
                               self.vocab_size)


def tp_parallel_cross_entropy(logits: TpShardedLogits,
                              targets: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-position CE, predicted-correct) from vocab-sharded logit
    columns, equal to softmax CE over the gathered logits at float32
    reassociation. Two model-axis collectives, both (targets.shape, 2)
    float32: a MAX of the detached local max (the shift carries no
    gradient), and one `reduce_from_tp` of [sum exp(l - m), the target
    logit's partial], so the backward is softmax - onehot on the local
    columns with no further collective. ``correct`` is target logit ==
    global max (argmax up to ties)."""
    local = logits.local.float()
    tp, rows = logits.tp, logits.vocab_rows
    local_max = local.detach().amax(dim=-1)
    m = torch.stack([local_max, local_max], dim=-1)
    if tp.size > 1:
        m = m.contiguous()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    m = m[..., 0]
    sumexp = torch.exp(local - m[..., None]).sum(dim=-1)
    local_ids = targets.long() - tp.index * rows
    valid = (local_ids >= 0) & (local_ids < rows)
    picked = local.gather(-1, local_ids.clamp(0, rows - 1)[..., None])[..., 0]
    tgt_partial = torch.where(valid, picked, torch.zeros_like(picked))
    stats = reduce_from_tp(torch.stack([sumexp, tgt_partial], dim=-1), tp)
    total, tgt_logit = stats[..., 0], stats[..., 1]
    ce = torch.log(total) + m - tgt_logit
    return ce, tgt_logit >= m


# ---------------------------------------------------------------------------
# gather on use: the fsdp axis's parameters, the MoE layer's whole rows
# ---------------------------------------------------------------------------


def _gather_dim(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _scatter_sum_dim(g: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The tiled reduce-scatter along ``dim``: this rank's slice of the
    SUM over ``group`` (`psum_scatter`, summed in rank order)."""
    moved = g.movedim(dim, 0).contiguous()
    n = world_size(group)
    out = psum_scatter(moved, group)
    return out.reshape(moved.shape[0] // n, *moved.shape[1:]).movedim(0, dim)


class _GatherOnUse(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters the
    cotangent back along it."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum_dim(g, ctx.dim, ctx.group), None, None


def gather_on_use(x: torch.Tensor, dim: int, axis: "TpAxis") -> torch.Tensor:
    """``x``, this rank's slice along ``dim`` of an ``axis``-split tensor,
    made whole: the slices of ``axis``'s ranks concatenated in their
    order. Differentiable: each rank's gradient is the SUM over the axis
    of the whole tensor's gradients, cut to its own slice (the fsdp
    axis's reduce-scatter of a parameter's gradient; the MoE layer's
    gathered row over ``seq``). The identity on an axis of one rank."""
    if axis.size == 1:
        return x
    return _GatherOnUse.apply(x, dim, axis.group)


@dataclasses.dataclass(frozen=True)
class FsdpShard:
    """A parameter held as its slice along ``dim`` over ``axis`` (the
    mesh's ``fsdp`` axis): set as the parameter's ``fsdp`` attribute,
    read by `gathered`."""

    dim: int
    axis: TpAxis


def gathered(p: torch.Tensor) -> torch.Tensor:
    """A parameter as the forward uses it: whole (`gather_on_use` over
    its ``fsdp`` axis) when it is held as an `FsdpShard` slice, else
    itself."""
    shard = getattr(p, "fsdp", None)
    if shard is None:
        return p
    return gather_on_use(p, shard.dim, shard.axis)
