"""Tasks: what a batch means and how loss and metrics are computed (the
JAX package's training/tasks.py; the image classification, causal LM,
MoE causal LM and masked LM tasks are ported).

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
from ..parallel.collectives import TpShardedLogits, tp_parallel_cross_entropy
from ..utils import prng

Metrics = Dict[str, torch.Tensor]
Stats = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepKey:
    """The JAX package's step key (a ``utils/prng.py`` key (2,)) and the
    first of this rank's rows in the draw the JAX step makes with it (on
    the replicated path the JAX step draws over the global batch; the
    explicit paths draw over each rank's own rows, from row 0)."""

    key: torch.Tensor
    first_row: int = 0


class Task:
    """Interface; see the module docstring for the contract. ``generator``
    draws the step's augmentation; ``key`` is the JAX step key for tasks
    whose draws must be jax.random's (``needs_key``). Tasks without
    random numbers ignore both."""

    needs_key = False

    def loss_and_metrics(self, model: nn.Module,
                         batch: Dict[str, torch.Tensor], train: bool,
                         generator: Optional[torch.Generator] = None,
                         key: Optional[StepKey] = None
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

    def loss_and_metrics(self, model, batch, train, generator=None,
                         key=None):
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
    broadcasts over tokens), plus ``aux_loss_weight`` x the mean of the
    auxiliary losses the model left in its ``aux_losses`` (an MoE
    model's; none for a dense one); "correct" is next-token top-1. The model
    computes in its own dtype and the logits are cast to float32 here, as
    in the JAX task, whose ``compute_dtype`` field this keeps.

    Sequence parallelism (``seq_shards`` > 1): every rank of a ``seq`` line
    holds the same full rows, and rank ``seq_index`` runs the model on its
    own S/N positions (``pos_offset``). The label of its last position is
    the first token of the next shard, taken from the full row; the row's
    final position has none. The loss and the three sums count this
    rank's positions only, so their sums over the data x seq ranks count
    each token once."""

    compute_dtype: torch.dtype = torch.float32
    aux_loss_weight: float = 0.0
    seq_index: int = 0
    seq_shards: int = 1

    def loss_and_metrics(self, model, batch, train, generator=None,
                         key=None):
        ids = batch["input_ids"].long()
        if self.seq_shards > 1:
            s = ids.shape[1]
            if s % self.seq_shards:
                raise ValueError(f"sequence length {s} not divisible by "
                                 f"{self.seq_shards} 'seq' shards")
            width = s // self.seq_shards
            lo = self.seq_index * width
            logits = model(ids[:, lo:lo + width], pos_offset=lo)
        else:
            lo, logits = 0, model(ids)
        # predict ids[:, t + 1] from the logits at t
        sharded = isinstance(logits, TpShardedLogits)
        width = (logits.local if sharded else logits).shape[1]
        tgt = ids[:, lo + 1:lo + 1 + width]
        if sharded:
            per_tok, predicted = tp_parallel_cross_entropy(
                logits.map_local(lambda x: x[:, :tgt.shape[1]]), tgt)
        else:
            lg = logits[:, :tgt.shape[1]].float()
            per_tok = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                      tgt.reshape(-1), reduction="none"
                                      ).reshape(tgt.shape)
            predicted = lg.argmax(-1) == tgt
        w = batch["weight"][:, None] * torch.ones_like(per_tok)
        loss, metrics = _weighted(per_tok, predicted, w)
        aux = getattr(model, "aux_losses", None)
        if self.aux_loss_weight and aux:
            # the mean of the MoE layers' losses (each one scalar, its own
            # mean), as the JAX task averages the sown leaves
            loss = loss + self.aux_loss_weight * (
                sum(a.mean() for a in aux) / len(aux))
        return loss, metrics, {}


@dataclasses.dataclass
class MoeLanguageModelingTask(LanguageModelingTask):
    """Causal LM over an MoE model (``models/moe.py``): the cross-entropy
    plus ``aux_loss_weight`` x the mean of the router load-balancing
    losses the forward leaves in the model's ``aux_losses``. The metrics
    are the cross-entropy's, as in the JAX task."""

    aux_loss_weight: float = 0.01


@dataclasses.dataclass
class MaskedLMTask(Task):
    """BERT masked LM. Batch: {"input_ids": (B, S) int, "weight": (B,)}.
    15% of the positions are selected; of those 80% become ``[MASK]``, 10%
    a random id below ``vocab_size`` and 10% stay. The loss is the float32
    cross-entropy on the selected positions only, weighted by the row
    weight; "correct" is masked-token top-1. The three draws are the JAX
    task's (``split(key, 3)``: bernoulli, uniform, randint), bitwise
    (``utils/prng.py``), over the rows ``key`` says this rank holds: the
    model ranks of a batch coordinate hold the same rows and key, so they
    draw the same masks. A tensor-parallel BERT's vocab-split logits
    (``TpShardedLogits``) take the parallel-vocab cross-entropy."""

    mask_token_id: int = 103   # BERT-base [MASK]
    vocab_size: int = 30522
    mask_prob: float = 0.15
    compute_dtype: torch.dtype = torch.float32
    needs_key = True

    def mask(self, ids: torch.Tensor, key: StepKey
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(selected (B, S) bool, the model's input ids) for this rank's
        rows ``ids`` of the JAX draw."""
        b, s = ids.shape
        n, offset = b * s, key.first_row * s
        k_sel, k_act, k_rand = prng.split(key.key.to(ids.device), 3)
        selected = prng.bernoulli(k_sel, self.mask_prob, n, offset)
        action = prng.uniform(k_act, n, offset=offset)
        rand = prng.randint(k_rand, n, 0, self.vocab_size, offset)
        flat = ids.reshape(-1)
        # a Python float compares in the tensor's float32, as in JAX
        masked = torch.where(action < 0.8, self.mask_token_id,
                             torch.where(action < 0.9, rand, flat))
        return (selected.reshape(b, s),
                torch.where(selected, masked, flat).reshape(b, s))

    def loss_and_metrics(self, model, batch, train, generator=None,
                         key=None):
        if key is None:
            raise ValueError("the masked LM task draws its masks from the "
                             "JAX step key: pass key")
        ids = batch["input_ids"].long()
        selected, inputs = self.mask(ids, key)
        logits = model(inputs)
        if isinstance(logits, TpShardedLogits):
            per_tok, predicted = tp_parallel_cross_entropy(logits, ids)
        else:
            logits = logits.float()
            per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                      ids.reshape(-1), reduction="none"
                                      ).reshape(ids.shape)
            predicted = logits.argmax(-1) == ids
        w = selected.float() * batch["weight"][:, None]
        loss, metrics = _weighted(per_tok, predicted, w)
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
