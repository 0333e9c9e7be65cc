"""TrainState: the model, its optimizer, the update count, the BatchNorm
running statistics and the gradient-sync state (the JAX package's
training/train_state.py, where it is an immutable pytree).

``batch_stats`` are the model's buffers (the BatchNorm means and
variances; none for GPT-2), read and written through the state so the
Trainer decides when they change. ``grad_sync`` holds this rank's
error-feedback residual of an int8 gradient wire (``{"ef": tensor}``),
``{}`` on every other wire.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

from ..convert import flax_ordered
from .optim import GradientTransformation


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: GradientTransformation
    grad_sync: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def create(cls, model: nn.Module,
               tx: GradientTransformation) -> "TrainState":
        return cls(step=0, model=model,
                   optimizer=tx.init(model.parameters()), tx=tx)

    @property
    def params(self) -> List[nn.Parameter]:
        """The parameters in flax ``tree_leaves`` order (the flat gradient
        layout of the bucketed reducer)."""
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

    def apply_gradients(self) -> None:
        """optimizer.step() from the parameters' ``.grad``, with the lr the
        schedule gives at the current count; then the count advances."""
        self.tx.apply(self.optimizer, self.step)
        self.step += 1

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())
