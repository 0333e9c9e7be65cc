"""Tasks: what a batch means and how loss and metrics are computed (the
JAX package's training/tasks.py; the image classification and causal LM
tasks are ported).

``loss_and_metrics`` returns ``(loss, metrics, new_stats)``. The metrics
are weighted SUMS, 0-d tensors that stay on the device until a print
boundary:
  - "loss_sum": sum(per-sample loss * weight)
  - "correct":  sum(is_correct * weight)
  - "weight":   sum(weight)
``new_stats`` are the model's updated BatchNorm statistics by buffer name
in train mode ({} for a model without them, and in eval mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.augment import draw_crop_flip, normalize_images, random_crop_flip
from ..runtime import not_ported

Metrics = Dict[str, torch.Tensor]
Stats = Dict[str, torch.Tensor]


class Task:
    """Interface; see the module docstring for the contract. ``generator``
    draws the step's random numbers (augmentation); tasks without any
    ignore it."""

    def loss_and_metrics(self, model: nn.Module,
                         batch: Dict[str, torch.Tensor], train: bool,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, Metrics, Stats]:
        raise NotImplementedError


def _weighted(per_sample: torch.Tensor, predicted: torch.Tensor,
              w: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    """(weighted-mean loss, the weighted-sum metrics)."""
    wsum = w.sum()
    loss_sum = (per_sample * w).sum()
    loss = loss_sum / torch.clamp(wsum, min=1.0)
    return loss, {"loss_sum": loss_sum.detach(),
                  "correct": (predicted * w).sum(), "weight": wsum}


@dataclasses.dataclass
class ImageClassificationTask(Task):
    """CIFAR/ImageNet classification. Batch: {"image": uint8 (B, H, W, C),
    "label": int (B,), "weight": (B,)}. In training, RandomCrop(padding) +
    flip (drawn from ``generator``) then normalization into
    ``compute_dtype``; in eval, normalization only. Cross-entropy in
    float32; "correct" is top-1."""

    mean: Sequence[float]
    std: Sequence[float]
    augment: bool = True
    crop_padding: int = 4
    compute_dtype: torch.dtype = torch.float32

    def loss_and_metrics(self, model, batch, train, generator=None):
        images = batch["image"]
        if train and self.augment:
            if generator is None:
                raise ValueError("augmentation needs a generator")
            draws = draw_crop_flip(images.shape[0], generator,
                                   self.crop_padding)
            images = random_crop_flip(images, *draws,
                                      padding=self.crop_padding)
        x = normalize_images(images, self.mean, self.std,
                             self.compute_dtype)
        if train:
            logits, new_stats = model(x, train=True)
        else:
            logits, new_stats = model(x), {}
        labels = batch["label"].long()
        logits = logits.float()
        per_sample = F.cross_entropy(logits, labels, reduction="none")
        loss, metrics = _weighted(per_sample, logits.argmax(-1) == labels,
                                  batch["weight"])
        return loss, metrics, new_stats


@dataclasses.dataclass
class LanguageModelingTask(Task):
    """Causal next-token prediction. Batch: {"input_ids": (B, S) int,
    "weight": (B,)}. Loss = cross-entropy of token t+1 from the logits at
    t, in float32, averaged over the weighted positions (the row weight
    broadcasts over tokens); "correct" is next-token top-1. The model
    computes in its own dtype and the logits are cast to float32 here, as
    in the JAX task, whose ``compute_dtype`` field this keeps."""

    compute_dtype: torch.dtype = torch.float32
    aux_loss_weight: float = 0.0

    def __post_init__(self):
        if self.aux_loss_weight:
            raise not_ported("auxiliary (MoE) losses", "a later slice")

    def loss_and_metrics(self, model, batch, train, generator=None):
        ids = batch["input_ids"].long()
        logits = model(ids)
        lg = logits[:, :-1].float()
        tgt = ids[:, 1:]
        per_tok = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                  tgt.reshape(-1), reduction="none"
                                  ).reshape(tgt.shape)
        w = batch["weight"][:, None] * torch.ones_like(per_tok)
        loss, metrics = _weighted(per_tok, lg.argmax(-1) == tgt, w)
        return loss, metrics, {}


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
