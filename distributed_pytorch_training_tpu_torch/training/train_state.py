"""TrainState: the model, its optimizer, the update count, the BatchNorm
running statistics and the gradient-sync state (the JAX package's
training/train_state.py, where it is an immutable pytree).

``batch_stats`` are the model's buffers (the BatchNorm means and
variances; none for GPT-2), read and written through the state so the
Trainer decides when they change. ``grad_sync`` holds this rank's
error-feedback residual of an int8 gradient wire: ``{"ef": tensor}`` on
the bucketed reducer, ``{"ef": {leaf or layer group: tensor}}`` under
ZeRO-1 or explicit FSDP, ``{}`` on every other wire.

``sharding`` describes the sharded update's flat-padded layout on this
rank (`FlatSharding`; None when the update is replicated). Under ZeRO-1
the optimizer updates ``sharding.shards``, this rank's chunk of every
leaf; under explicit FSDP the model's parameters themselves hold their
chunks between steps (the Trainer gathers them for each step).

``tp`` describes a model split over a mesh axis on this rank
(`TpLayout`; None without one): tensor parallelism on ``model``, the
pipeline's stages on ``pipe``, the experts on ``expert``. The model is
local, each split leaf a slice of the global one.

``fsdp`` describes the mesh's ``fsdp`` axis on this rank (`FsdpLayout`;
None without one): the leaves held as their 1/F slice along a dim, which
the modules gather on use. ``clip`` (`ClipSpec`) is set with either
layout: the global-norm clip's weights and group over every axis the
parameters or the update are split on (the split axis, fsdp, and the
batch line under a sharded update).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..convert import flax_ordered
from ..parallel.collectives import Group, TpAxis
from .optim import GradientTransformation


@dataclasses.dataclass
class TpLayout:
    """A model split over one mesh axis on this rank (tensor parallelism
    on ``model``, and in the same form the pipeline's stages on ``pipe``
    and the experts on ``expert``): the ``axis``, and for every parameter
    (flax order: ``names``) its split dim (None: replicated over the
    axis's ranks) and its global shape."""

    axis: TpAxis
    names: Tuple[str, ...]
    split_dims: Tuple[Optional[int], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    # ranks[m][b]: the rank at model index m and batch index b (the
    # checkpoint's model-major order)
    ranks: Tuple[Tuple[int, ...], ...] = ()
    # the mesh axis the split leaves split over: ``model`` (tensor
    # parallelism), ``pipe`` (the stages' stacked blocks) or ``expert``
    # (the MoE layers' experts)
    axis_name: str = "model"


@dataclasses.dataclass
class FsdpLayout:
    """The ``fsdp`` axis on this rank: for every parameter (flax order,
    ``names``) the dim it is sliced on over ``axis`` (None: whole on
    every fsdp rank) and its shape before the cut (the TP-local one
    under tensor parallelism)."""

    axis: TpAxis
    names: Tuple[str, ...]
    dims: Tuple[Optional[int], ...]
    shapes: Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass
class ClipSpec:
    """The global-norm clip's squared-sum weights, one a leaf in flax
    order (of ``targets``, the tensors the optimizer updates, when they
    are not the model's parameters), summed over ``group``."""

    weights: Tuple[float, ...]
    group: Group = None
    targets: Optional[List[torch.Tensor]] = None


@dataclasses.dataclass
class FlatSharding:
    """The sharded update's layout on this rank: ``mode`` is ``zero1`` or
    ``fsdp``; every leaf (``names`` and model ``shapes``, flax order) is
    flat-padded to a multiple of ``n_shards`` and this rank holds chunk
    ``owners[rank]`` of it. ``shards`` are ZeRO-1's chunk tensors, which
    the optimizer updates."""

    mode: str
    n_shards: int
    rank: int
    owners: Tuple[int, ...]
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    shards: Optional[List[torch.Tensor]] = None
    # the ranks the chunks are spread over (ZeRO-1 on a model mesh: the
    # batch line of this model index; None: the default group)
    group: Group = None

    @property
    def owner(self) -> int:
        return self.owners[self.rank]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: GradientTransformation
    grad_sync: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    sharding: Optional[FlatSharding] = None
    tp: Optional[TpLayout] = None
    fsdp: Optional[FsdpLayout] = None
    clip: Optional[ClipSpec] = None

    @classmethod
    def create(cls, model: nn.Module,
               tx: GradientTransformation) -> "TrainState":
        return cls(step=0, model=model,
                   optimizer=tx.init(model.parameters()), tx=tx)

    @property
    def params(self) -> List[nn.Parameter]:
        """The parameters in flax ``tree_leaves`` order (the flat gradient
        layout of the bucketed reducer); under explicit FSDP, this rank's
        chunks between steps."""
        return [p for _, p in flax_ordered(self.model.named_parameters())]

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """{buffer name: running statistic}, in flax order."""
        return dict(flax_ordered(self.model.named_buffers()))

    @torch.no_grad()
    def set_batch_stats(self, new: Dict[str, torch.Tensor]) -> None:
        """Write new running statistics (every buffer named in ``new``)."""
        own = self.batch_stats
        for name, value in new.items():
            own[name].copy_(value)

    def apply_gradients(self, group=None) -> None:
        """optimizer.step() from the parameters' ``.grad``, with the lr the
        schedule gives at the current count; then the count advances.
        ``group``: the ranks a sharded update's chunks are spread over
        (a split model's clip has its own group)."""
        clip = self.clip
        if clip is not None:
            # the clip's weights are in flax order; the optimizer holds
            # its parameters in its own
            targets = clip.targets if clip.targets is not None \
                else self.params
            weight = dict(zip(map(id, targets), clip.weights))
            self.tx.apply(self.optimizer, self.step, clip.group,
                          sharded=True, clip_weights=[
                              weight[id(p)]
                              for g in self.optimizer.param_groups
                              for p in g["params"]])
        else:
            self.tx.apply(self.optimizer, self.step, group,
                          sharded=self.sharding is not None)
        self.step += 1

    def param_count(self) -> int:
        """The model's parameter count (model-shaped, not padded; the
        global model's under tensor parallelism)."""
        if self.tp is not None:
            return sum(math.prod(s) for s in self.tp.shapes)
        if self.fsdp is not None:
            return sum(math.prod(s) for s in self.fsdp.shapes)
        if self.sharding is not None:
            return sum(math.prod(s) for s in self.sharding.shapes)
        return sum(p.numel() for p in self.model.parameters())
