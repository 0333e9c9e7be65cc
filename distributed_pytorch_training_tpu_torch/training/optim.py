"""Optimizers and learning-rate schedules (the JAX package's
training/optim.py) on ``torch.optim.SGD`` and ``torch.optim.AdamW``.

The JAX package builds optax chains before the parameters exist; here
``sgd``/``adamw`` return a `GradientTransformation` whose ``init(params)``
makes the torch optimizer and whose ``apply`` takes one step. The
trajectories match optax's (tests/test_training.py pins torch's SGD and
AdamW against the optax chains; tests/test_torch_training.py pins the
port's Trainer against the JAX Trainer):

* SGD: weight decay is added to the gradient before the momentum buffer;
* AdamW: decoupled weight decay; optional optax-style global-norm clip;
* the schedule is read at the update count BEFORE it increments, as
  optax's ``scale_by_schedule`` reads it, so ``linear_warmup`` gives
  lr 0 at the first step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence, Union

import torch

from ..parallel.collectives import Group, psum

Schedule = Callable[[int], float]


def make_schedule(name: str, base_lr: float,
                  total_steps: Optional[int] = None, warmup_steps: int = 0,
                  final_lr_ratio: float = 0.0) -> Schedule:
    """update count -> lr: constant, cosine (linear warmup then cosine
    decay to ``final_lr_ratio * base_lr``) or linear_warmup, with optax's
    formulas."""
    def linear(count: int, steps: int) -> float:
        frac = min(max(count, 0), steps) / steps
        return base_lr * frac

    if name == "constant":
        return lambda count: base_lr
    if name == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule needs total_steps")
        warm = max(warmup_steps, 1)
        decay = max(total_steps - warmup_steps, 1)

        def cosine(count: int) -> float:
            if count < warmup_steps:
                return linear(count, warm)
            t = min(count - warmup_steps, decay) / decay
            cos = 0.5 * (1 + math.cos(math.pi * t))
            return base_lr * ((1 - final_lr_ratio) * cos + final_lr_ratio)

        return cosine
    if name == "linear_warmup":
        warm = max(warmup_steps, 1)
        return lambda count: (linear(count, warm) if count < warmup_steps
                              else base_lr)
    raise ValueError(f"unknown schedule {name!r} (constant, cosine, "
                     "linear_warmup)")


def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float, group: Group = None,
                         sharded: bool = False,
                         weights: Optional[Sequence[float]] = None) -> None:
    """optax's ``clip_by_global_norm`` in place: when the global norm is
    not below ``max_norm``, every gradient becomes g / norm * max_norm.
    ``sharded`` (the sharded update, whose gradients are this rank's
    chunks, or tensor parallelism, whose gradients are this rank's
    slices): the squared norm is summed over the ranks of ``group``
    first, the JAX package's ``clip_by_global_norm_dp``; the chunks' zero
    padding adds nothing. ``weights`` (a split model,
    ``parallel.sharding.mesh_clip_weights``, one a gradient) multiply
    each gradient's squared sum: 1/M for a leaf every one of M ranks
    holds whole, 1 for a split one."""
    grads = [g for g in grads if g is not None]
    if weights is None:
        sq = sum(torch.sum(torch.square(g)) for g in grads)
    else:
        if len(weights) != len(grads):
            raise ValueError(f"{len(weights)} clip weights for "
                             f"{len(grads)} gradients")
        sq = sum(w * torch.sum(torch.square(g))
                 for w, g in zip(weights, grads))
    norm = torch.sqrt(psum(sq, group) if sharded else sq)
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    """An optimizer described before its parameters exist (optax's role
    in the JAX package)."""

    make: Callable[[list], torch.optim.Optimizer]
    schedule: Schedule
    grad_clip_norm: Optional[float] = None

    def init(self, params: Iterable[torch.nn.Parameter]
             ) -> torch.optim.Optimizer:
        return self.make(list(params))

    def apply(self, optimizer: torch.optim.Optimizer, count: int,
              sharded_over: Optional[Group] = None,
              sharded: bool = False,
              clip_weights: Optional[Sequence[float]] = None) -> None:
        """One update from the parameters' ``.grad``; ``count`` is the
        number of updates taken before this one. ``sharded``: the
        parameters are this rank's chunks (or tensor-parallel slices)
        over the ranks of ``sharded_over`` (the clip's norm sums over
        them, each squared sum times its ``clip_weights`` entry)."""
        if self.grad_clip_norm:
            clip_by_global_norm_((p.grad for group in optimizer.param_groups
                                  for p in group["params"]),
                                 self.grad_clip_norm, sharded_over, sharded,
                                 clip_weights)
        lr = float(self.schedule(count))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()


def _schedule_of(learning_rate: Union[float, Schedule]) -> Schedule:
    if callable(learning_rate):
        return learning_rate
    return lambda count: float(learning_rate)


def sgd(learning_rate: Union[float, Schedule], momentum: float = 0.9,
        weight_decay: float = 5e-4,
        nesterov: bool = False) -> GradientTransformation:
    """torch.optim.SGD: g += wd * p, then momentum, then the -lr step."""
    schedule = _schedule_of(learning_rate)
    return GradientTransformation(
        lambda params: torch.optim.SGD(
            params, lr=float(schedule(0)), momentum=momentum,
            weight_decay=weight_decay, nesterov=nesterov),
        schedule)


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
          grad_clip_norm: Optional[float] = 1.0) -> GradientTransformation:
    """AdamW with decoupled weight decay and optional global-norm
    clipping."""
    schedule = _schedule_of(learning_rate)
    return GradientTransformation(
        lambda params: torch.optim.AdamW(
            params, lr=float(schedule(0)), betas=(b1, b2), eps=eps,
            weight_decay=weight_decay),
        schedule, grad_clip_norm)


def make_optimizer(name: str, learning_rate: Union[float, Schedule],
                   momentum: float = 0.9, weight_decay: float = 5e-4,
                   grad_clip_norm: Optional[float] = None
                   ) -> GradientTransformation:
    """Optimizer factory keyed by CLI name."""
    if name == "sgd":
        return sgd(learning_rate, momentum=momentum,
                   weight_decay=weight_decay)
    if name == "adamw":
        return adamw(learning_rate, weight_decay=weight_decay,
                     grad_clip_norm=grad_clip_norm)
    raise ValueError(f"unknown optimizer {name!r} (sgd, adamw)")
