"""TrainState: the model, its optimizer and the update count (the JAX
package's training/train_state.py, where it is an immutable pytree)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .optim import GradientTransformation


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: GradientTransformation

    @classmethod
    def create(cls, model: nn.Module,
               tx: GradientTransformation) -> "TrainState":
        return cls(step=0, model=model,
                   optimizer=tx.init(model.parameters()), tx=tx)

    def apply_gradients(self) -> None:
        """optimizer.step() from the parameters' ``.grad``, with the lr the
        schedule gives at the current count; then the count advances."""
        self.tx.apply(self.optimizer, self.step)
        self.step += 1

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())
