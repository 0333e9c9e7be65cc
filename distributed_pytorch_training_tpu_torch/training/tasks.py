"""Tasks: what a batch means and how loss and metrics are computed (the
JAX package's training/tasks.py; the causal LM task is ported).

``loss_and_metrics`` returns ``(loss, metrics)`` where the metrics are
weighted SUMS, 0-d tensors that stay on the device until a print boundary:
  - "loss_sum": sum(per-token loss * weight)
  - "correct":  sum(is_correct * weight)
  - "weight":   sum(weight)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import not_ported

Metrics = Dict[str, torch.Tensor]


class Task:
    """Interface; see the module docstring for the metrics contract."""

    def loss_and_metrics(self, model: nn.Module,
                         batch: Dict[str, torch.Tensor],
                         train: bool) -> Tuple[torch.Tensor, Metrics]:
        raise NotImplementedError


@dataclasses.dataclass
class LanguageModelingTask(Task):
    """Causal next-token prediction. Batch: {"input_ids": (B, S) int,
    "weight": (B,)}. Loss = cross-entropy of token t+1 from the logits at
    t, in float32, averaged over the weighted positions (the row weight
    broadcasts over tokens); "correct" is next-token top-1."""

    compute_dtype: torch.dtype = torch.float32
    aux_loss_weight: float = 0.0

    def __post_init__(self):
        if self.compute_dtype != torch.float32:
            raise not_ported(f"{self.compute_dtype} compute",
                             "the bf16 (--amp) slice")
        if self.aux_loss_weight:
            raise not_ported("auxiliary (MoE) losses", "a later slice")

    def loss_and_metrics(self, model, batch, train):
        ids = batch["input_ids"].long()
        logits = model(ids)
        lg = logits[:, :-1].float()
        tgt = ids[:, 1:]
        per_tok = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                  tgt.reshape(-1), reduction="none"
                                  ).reshape(tgt.shape)
        predicted = lg.argmax(-1) == tgt
        w = batch["weight"][:, None] * torch.ones_like(per_tok)
        wsum = w.sum()
        loss_sum = (per_tok * w).sum()
        loss = loss_sum / torch.clamp(wsum, min=1.0)
        metrics = {"loss_sum": loss_sum.detach(),
                   "correct": (predicted * w).sum(),
                   "weight": wsum}
        return loss, metrics


def zero_metrics(device=None) -> Metrics:
    return {name: torch.zeros((), device=device)
            for name in ("loss_sum", "correct", "weight")}


def add_metrics(a: Metrics, b: Metrics) -> Metrics:
    return {name: a[name] + b[name] for name in a}


def summarize(metrics: Metrics) -> Tuple[float, float]:
    """(mean loss, accuracy %) from the weighted sums: a host fetch."""
    total = float(metrics["weight"])
    if total == 0:
        return float("nan"), float("nan")
    return (float(metrics["loss_sum"]) / total,
            100.0 * float(metrics["correct"]) / total)
