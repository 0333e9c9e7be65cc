"""Trainer: train and eval steps and the epoch loops (the JAX package's
training/loop.py), single device.

Only the JAX Trainer's replicated single-shard path is ported: the plain
step, gradient accumulation, ``train_epoch`` and ``evaluate``. Every other
update mode (ZeRO-1, FSDP, the explicit bucketed reducer and its wires,
bf16) raises, naming the slice that brings it. As in the JAX package, the
metrics are weighted sums that stay on the device; the host fetches them
only at print boundaries and at the end of an epoch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from ..runtime import DeviceLike, not_ported, resolve_device
from ..utils.logging import log_main
from ..utils.metrics import ThroughputMeter
from .tasks import Metrics, Task, add_metrics, summarize, zero_metrics
from .train_state import TrainState
from .optim import GradientTransformation


@dataclasses.dataclass
class TrainConfig:
    """Loop knobs, the JAX package's fields and defaults. The port takes
    the single-shard values only; the others raise in `Trainer`."""

    per_device_batch: int = 128
    print_freq: int = 50
    seed: int = 42
    bf16: bool = False
    donate_state: bool = True
    grad_accum: int = 1
    zero1: bool = False
    bucket_cap_mb: float = 0.0
    wire_dtype: str = "fp32"
    slice_axis: str = "slice"
    fsdp_explicit: bool = False
    overlap_grad_sync: bool = True
    fused_quantize: Optional[bool] = None


def split_microbatches(batch: Dict[str, torch.Tensor], accum: int,
                       scope: str = "global batch"
                       ) -> Dict[str, torch.Tensor]:
    """Interleaved microbatch split: leading dim B -> (accum, B/accum, ...),
    microbatch i = rows i::accum (the JAX package's interleaving, which
    keeps microbatches spread over the batch shards). Scalars broadcast to
    (accum,)."""

    def split(x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 0:
            return x.expand(accum)
        if x.shape[0] % accum:
            raise ValueError(f"{scope} {x.shape[0]} not divisible by "
                             f"grad_accum={accum}")
        return x.reshape(x.shape[0] // accum, accum,
                         *x.shape[1:]).transpose(0, 1)

    return {name: split(x) for name, x in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Owns the train and eval steps for one task on one device."""

    def __init__(self, task: Task, config: TrainConfig,
                 device: DeviceLike = None):
        if config.bf16:
            raise not_ported("bf16 compute (--amp)", "the bf16 (--amp) slice")
        if config.zero1 or config.fsdp_explicit:
            raise not_ported("ZeRO-1 / explicit FSDP",
                             "the data-parallel slice")
        if config.bucket_cap_mb > 0 or config.wire_dtype != "fp32":
            raise not_ported("the explicit gradient reducer and its wires",
                             "the data-parallel slice")
        if config.fused_quantize:
            raise not_ported("the fused int8 wire codec",
                             "the data-parallel slice")
        if config.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{config.grad_accum}")
        self.task = task
        self.config = config
        self.device = resolve_device(device)

    def init_state(self, model: torch.nn.Module,
                   tx: GradientTransformation) -> TrainState:
        """Move ``model`` (initialized by the caller) to the device and
        build its optimizer."""
        return TrainState.create(model.to(self.device), tx)

    # -- steps --------------------------------------------------------------

    def train_step(self, state: TrainState,
                   batch: Dict[str, torch.Tensor]) -> Metrics:
        """One optimizer step on ``batch``; returns its weighted-sum
        metrics (on the device)."""
        model = state.model
        model.train()
        params = list(model.parameters())
        accum = self.config.grad_accum
        if accum <= 1:
            for p in params:
                p.grad = None
            loss, metrics = self.task.loss_and_metrics(model, batch,
                                                       train=True)
            loss.backward()
            state.apply_gradients()
            return metrics

        # The task loss is the weighted MEAN over its microbatch, so the
        # global-batch gradient is sum_i (w_i / W) d(mean_i): accumulate
        # w_i-scaled microbatch gradients and divide by W once.
        micro = split_microbatches(batch, accum)
        g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        metrics = zero_metrics(self.device)
        for i in range(accum):
            mb = {name: x[i] for name, x in micro.items()}
            loss, m = self.task.loss_and_metrics(model, mb, train=True)
            grads = torch.autograd.grad(loss, params)
            w = m["weight"]
            for acc, g in zip(g_sum, grads):
                acc.add_(w * g.float())
            metrics = add_metrics(metrics, m)
        total_w = torch.clamp(metrics["weight"], min=1.0)
        for p, acc in zip(params, g_sum):
            p.grad = (acc / total_w).to(p.dtype)
        state.apply_gradients()
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState,
                  batch: Dict[str, torch.Tensor]) -> Metrics:
        state.model.eval()
        _, metrics = self.task.loss_and_metrics(state.model, batch,
                                                train=False)
        return metrics

    # -- epoch loops ----------------------------------------------------------

    def train_epoch(self, state: TrainState, batches: Iterable,
                    epoch: int, steps_per_epoch: int,
                    samples_per_step: Optional[Sequence[int]] = None
                    ) -> Tuple[TrainState, float, float, float, int]:
        """One epoch. Returns (state, mean loss, top-1 %, epoch wall
        seconds, steps executed). Prints the running loss, accuracy and
        samples/s every ``print_freq`` steps, the only host fetches inside
        the epoch."""
        cfg = self.config
        epoch_metrics = zero_metrics(self.device)
        t_epoch = time.perf_counter()
        meter = ThroughputMeter()
        steps_done = 0
        for i, batch in enumerate(batches):
            metrics = self.train_step(state, batch)
            epoch_metrics = add_metrics(epoch_metrics, metrics)
            steps_done = i + 1
            if samples_per_step is not None:
                meter.update(samples_per_step[min(i, len(samples_per_step)
                                                  - 1)])
            if (i + 1) % cfg.print_freq == 0:
                avg_loss, avg_acc = summarize(epoch_metrics)
                log_main(
                    f"Epoch [{epoch + 1}] "
                    f"Step [{i + 1}/{steps_per_epoch}] "
                    f"Loss: {avg_loss:.4f}  "
                    f"Acc: {avg_acc:.2f}%  "
                    f"Throughput: {meter.rate():.2f} samples/s (global)"
                )
                meter.reset()
        _sync(self.device)
        epoch_time = time.perf_counter() - t_epoch
        loss, acc = summarize(epoch_metrics)
        return state, loss, acc, epoch_time, steps_done

    def evaluate(self, state: TrainState,
                 batches: Iterable) -> Tuple[float, float]:
        """Validation: (mean loss, top-1 %)."""
        totals = zero_metrics(self.device)
        for batch in batches:
            totals = add_metrics(totals, self.eval_step(state, batch))
        return summarize(totals)
