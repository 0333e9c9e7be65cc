"""Trainer: train and eval steps and the epoch loops (the JAX package's
training/loop.py).

Three update paths are ported:

* ``_implicit_step``, the replicated step with and without gradient
  accumulation, on one rank or several: what the JAX package's jit does
  with a data-sharded global batch. BatchNorm's running statistics update
  once per step (under accumulation, the weight-averaged per-microbatch
  EMAs, which is ONE EMA update from the weighted-mean batch statistics;
  a fully padded batch keeps the old statistics). Over ranks, BatchNorm
  normalizes by the global batch (its statistics are all-reduced inside
  the forward, SyncBN semantics, ``models/resnet.py``), each rank
  differentiates its share of the global mean loss, and the gradient is
  summed over ranks in float32 in one bucket. Not DDP: it weights ranks
  equally, where a padded last batch weights them by their rows;
* ``_grad_sync_step``, the explicit bucketed reducer over the ranks of a
  ``torch.distributed`` group (``parallel/grad_sync.py``): each rank
  computes its local weight-scaled gradient sum, flattens it in the JAX
  package's layout and reduces it bucket by bucket at the wire dtype; the
  global weight comes from one 3-scalar all-reduce and every rank applies
  the same mean gradient. BatchNorm statistics become
  ``all_reduce(w * stats) / W``. Each rank normalizes by its own batch
  (torch DDP's per-GPU BN, as the JAX reducer does per shard).

The engagement rules are the JAX Trainer's: the reducer runs when
``bucket_cap_mb > 0`` or the wire is not fp32, on more than one rank; on
one rank such a request is an identity passthrough (logged). ZeRO-1,
explicit FSDP and the ``int8_hier`` wire raise, naming their slices.
``bf16`` (``--amp``) is the model's compute dtype, chosen where the model
is built; the step is the same. As in the JAX package, the metrics are
weighted sums that stay on the device; the host fetches them only at
print boundaries and at the end of an epoch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.collectives import Group, psum, world_size
from ..parallel.grad_sync import (
    EF_WIRE_DTYPES, WIRE_DTYPES, BucketPlan, build_bucket_plan,
    ef_state_bucketed, flatten_tree, padded_total_size, reduce_flat,
    refuse_unported_wire, unflatten_tree,
)
from ..runtime import DeviceLike, not_ported, resolve_device
from ..utils.logging import log_main
from ..utils.metrics import ThroughputMeter
from .tasks import Metrics, Task, add_metrics, summarize, zero_metrics
from .train_state import TrainState
from .optim import GradientTransformation

METRIC_NAMES = ("loss_sum", "correct", "weight")


@dataclasses.dataclass
class TrainConfig:
    """Loop knobs, the JAX package's fields and defaults."""

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
    # the int8 codec kernels: None (auto) and True run them on CUDA (the
    # plain versions on the CPU); False, the composed codec, exists only
    # on the CPU here and raises on CUDA
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


def _psum_metrics(m: Metrics, group: Group) -> Metrics:
    """The three weighted sums summed over ranks: one all-reduce."""
    summed = psum(torch.stack([m[k] for k in METRIC_NAMES]), group)
    return dict(zip(METRIC_NAMES, summed.unbind(0)))


class Trainer:
    """Owns the train and eval steps for one task on this rank's device;
    ``group`` is the data-parallel process group (the default group when
    None; one process without one)."""

    def __init__(self, task: Task, config: TrainConfig,
                 device: DeviceLike = None, group: Group = None):
        if config.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype {config.wire_dtype!r} is not one "
                             f"of {WIRE_DTYPES}")
        if config.bucket_cap_mb < 0:
            raise ValueError(f"bucket_cap_mb must be >= 0, got "
                             f"{config.bucket_cap_mb}")
        if config.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{config.grad_accum}")
        if config.zero1 or config.fsdp_explicit:
            raise not_ported("ZeRO-1 / explicit FSDP",
                             "the sharded-update (ZeRO-1/FSDP) slice")
        self.task = task
        self.config = config
        self.device = resolve_device(device)
        self.group = group
        self.n_shards = world_size(group)
        self.rank = (torch.distributed.get_rank(group)
                     if self.n_shards > 1 else 0)
        explicit_sync = (config.bucket_cap_mb > 0
                         or config.wire_dtype != "fp32")
        if explicit_sync:
            refuse_unported_wire(config.wire_dtype)
        if config.fused_quantize is False and self.device.type == "cuda":
            raise ValueError(
                "--fused-quantize off selects the composed int8 codec, "
                "which the port has only as the plain versions on the CPU; "
                "on CUDA the codec is the kernels (auto or on)")
        self._grad_sync = explicit_sync and self.n_shards > 1
        self._implicit_dp = not explicit_sync and self.n_shards > 1
        self._wire = config.wire_dtype
        self._plan: Optional[BucketPlan] = None
        if explicit_sync and not self._grad_sync:
            log_main("NOTE: explicit gradient sync requested on a single "
                     "batch shard — nothing to synchronize; running the "
                     "implicit path (identity passthrough, like "
                     "single-process DDP)")

    def init_state(self, model: torch.nn.Module,
                   tx: GradientTransformation) -> TrainState:
        """Move ``model`` (initialized by the caller, the same on every
        rank) to the device, build its optimizer and, for an int8 wire,
        this rank's zero error-feedback residual. On the implicit path over
        several ranks, the model's BatchNorms normalize by the global
        batch."""
        state = TrainState.create(model.to(self.device), tx)
        if self._implicit_dp:
            self._plan = build_bucket_plan(state.params, 0.0)
            set_stats_group = getattr(model, "set_stats_group", None)
            if set_stats_group is not None:
                set_stats_group(self.group if self.group is not None
                                else dist.group.WORLD)
        if self._grad_sync:
            self._plan = build_bucket_plan(state.params,
                                           self.config.bucket_cap_mb)
            if self._wire in EF_WIRE_DTYPES:
                state.grad_sync = ef_state_bucketed(
                    state.params, self.n_shards, self.config.bucket_cap_mb,
                    self._wire, self.device)
        return state

    def _generator(self, step: int, micro: int) -> torch.Generator:
        """The step's CPU generator for augmentation draws, seeded by
        (seed, step, rank, microbatch)."""
        seed = np.random.SeedSequence(
            [self.config.seed, step, self.rank, micro]).generate_state(1)[0]
        return torch.Generator().manual_seed(int(seed))

    # -- steps --------------------------------------------------------------

    def train_step(self, state: TrainState,
                   batch: Dict[str, torch.Tensor]) -> Metrics:
        """One optimizer step on ``batch`` (this rank's rows); returns its
        weighted-sum metrics, summed over ranks (on the device)."""
        state.model.train()
        if self._grad_sync:
            return self._grad_sync_step(state, batch)
        return self._implicit_step(state, batch)

    @staticmethod
    def _write_stats(state: TrainState, s_sum: Dict[str, torch.Tensor],
                     weight: torch.Tensor, total_w: torch.Tensor) -> None:
        """New running statistics ``s_sum / W``; a fully padded batch
        (W = 0) keeps the old ones."""
        old = state.batch_stats
        state.set_batch_stats({
            name: torch.where(weight > 0, s / total_w, old[name])
            for name, s in s_sum.items()})

    def _implicit_step(self, state: TrainState,
                       batch: Dict[str, torch.Tensor]) -> Metrics:
        """The replicated step, on one rank or several (JAX: the jitted
        step on a data-sharded global batch). The task loss is the
        weighted MEAN over its (micro)batch, so the global gradient is
        sum_i (W_i / W) d(mean_i), W_i microbatch i's global weight: each
        microbatch's three metric sums are summed over ranks right after
        its forward (one small all-reduce), and each rank differentiates
        its loss x w / W_i, its part of the global mean. The scale comes
        before the backward, since global-batch BatchNorm's all-reduced
        statistics carry every rank's loss gradient to every rank's
        activations. On one rank w / W_i is exactly 1 (or 0 for a fully
        padded batch). Under accumulation the rank's batch splits
        interleaved; as the global batch is rank-major and each rank's
        rows divide by ``grad_accum``, microbatch i is rows i::accum of
        the GLOBAL batch, as JAX splits it, and its BatchNorm is global.
        The flat float32 gradient is summed over ranks in one bucket. The
        statistics, the same on every rank, are written directly: under
        accumulation the W_i-weighted mean of the microbatches' EMAs,
        which is ONE EMA update from the weighted-mean batch statistics
        (a fully padded batch keeps the old statistics)."""
        accum, group = self.config.grad_accum, self.group
        model, params = state.model, state.params
        if accum <= 1:
            micro = [batch]
        else:
            split = split_microbatches(batch, accum, scope="per-rank batch")
            micro = [{k: x[i].contiguous() for k, x in split.items()}
                     for i in range(accum)]
        g_sum: Optional[list] = None
        s_sum: Dict[str, torch.Tensor] = {}
        metrics = zero_metrics(self.device)
        for i, mb in enumerate(micro):
            loss, m, stats = self.task.loss_and_metrics(
                model, mb, True, self._generator(state.step, i))
            m_global = _psum_metrics(m, group)
            w = m_global["weight"]
            grads = torch.autograd.grad(
                loss * (m["weight"] / torch.clamp(w, min=1.0)), params)
            if accum <= 1:
                g_sum, s_sum = list(grads), stats
            else:
                if g_sum is None:
                    g_sum = [torch.zeros_like(p, dtype=torch.float32)
                             for p in params]
                for acc, g in zip(g_sum, grads):
                    acc.add_(w * g.float())
                for name, s in stats.items():
                    s_sum[name] = s_sum.get(name, 0.0) + w * s
            metrics = add_metrics(metrics, m_global)
        if self.n_shards > 1:
            flat, _ = reduce_flat(flatten_tree(g_sum), self._plan,
                                  self.n_shards, "fp32", group=group)
            g_sum = unflatten_tree(flat, params)
        total_w = torch.clamp(metrics["weight"], min=1.0)
        for p, g in zip(params, g_sum):
            p.grad = g if accum <= 1 else (g / total_w).to(p.dtype)
        state.apply_gradients()
        if accum <= 1:
            state.set_batch_stats(s_sum)
        else:
            self._write_stats(state, s_sum, metrics["weight"], total_w)
        return metrics

    def _grad_sync_step(self, state: TrainState,
                        batch: Dict[str, torch.Tensor]) -> Metrics:
        """The explicit bucketed reducer (JAX ``_grad_sync_step``). With
        grad accumulation the local batch splits interleaved; overlap on
        reduces each microbatch's buckets as soon as they exist, off
        reduces the accumulated sum once (here both run in sequence: real
        overlap with the backward is later work)."""
        cfg, n, group = self.config, self.n_shards, self.group
        wire, plan = self._wire, self._plan
        model, params = state.model, state.params
        use_ef = wire in EF_WIRE_DTYPES
        ef = state.grad_sync.get("ef") if use_ef else None
        if use_ef:
            if ef is None:
                raise ValueError(
                    f"wire_dtype={wire!r} needs error-feedback buffers — "
                    "build the state via Trainer.init_state")
            expect = (padded_total_size(plan, n) if wire == "int8_multihop"
                      else plan.total_size)
            if ef.shape[-1] != expect:
                raise ValueError(
                    f"error-feedback residual length {ef.shape[-1]} does "
                    f"not match the {wire!r} wire's layout for "
                    f"bucket_cap_mb={cfg.bucket_cap_mb} ({expect} "
                    "elements)")

        def local_flat(mb, micro_index):
            loss, m, stats = self.task.loss_and_metrics(
                model, mb, True, self._generator(state.step, micro_index))
            grads = torch.autograd.grad(loss, params)
            w = m["weight"]
            return flatten_tree([w * g.float() for g in grads]), m, \
                {name: w * s for name, s in stats.items()}

        if cfg.grad_accum <= 1:
            flat, m_local, s_sum = local_flat(batch, 0)
            flat, ef = reduce_flat(flat, plan, n, wire, ef, group)
        else:
            micro = split_microbatches(batch, cfg.grad_accum,
                                       scope="per-shard batch")
            flat = torch.zeros(plan.total_size, dtype=torch.float32,
                               device=self.device)
            s_sum: Dict[str, torch.Tensor] = {}
            m_local = zero_metrics(self.device)
            for i in range(cfg.grad_accum):
                f_i, m, s = local_flat(
                    {k: x[i].contiguous() for k, x in micro.items()}, i)
                if cfg.overlap_grad_sync:
                    f_i, ef = reduce_flat(f_i, plan, n, wire, ef, group)
                flat = flat + f_i
                for name, v in s.items():
                    s_sum[name] = s_sum.get(name, 0.0) + v
                m_local = add_metrics(m_local, m)
            if not cfg.overlap_grad_sync:
                flat, ef = reduce_flat(flat, plan, n, wire, ef, group)

        metrics = _psum_metrics(m_local, group)
        total_w = torch.clamp(metrics["weight"], min=1.0)
        for p, g in zip(params, unflatten_tree(flat / total_w, params)):
            p.grad = g
        state.apply_gradients()
        if s_sum:
            names = list(s_sum)
            summed = psum(torch.cat([s_sum[k].reshape(-1) for k in names]),
                          group)
            sizes = [s_sum[k].numel() for k in names]
            self._write_stats(state, dict(zip(names, summed.split(sizes))),
                              metrics["weight"], total_w)
        if use_ef:
            state.grad_sync = {"ef": ef}
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState,
                  batch: Dict[str, torch.Tensor]) -> Metrics:
        """This rank's weighted-sum metrics of ``batch`` (not summed over
        ranks: `evaluate` sums the totals once)."""
        state.model.eval()
        _, metrics, _ = self.task.loss_and_metrics(state.model, batch,
                                                   train=False)
        return metrics

    # -- epoch loops ----------------------------------------------------------

    def train_epoch(self, state: TrainState, batches: Iterable,
                    epoch: int, steps_per_epoch: int,
                    samples_per_step: Optional[Sequence[int]] = None,
                    start_step: int = 0,
                    stop_fn: Optional[Callable[[], bool]] = None,
                    fault_hook: Optional[Callable[[int], None]] = None
                    ) -> Tuple[TrainState, float, float, float, int]:
        """One epoch. Returns (state, mean loss, top-1 %, epoch wall
        seconds, steps executed). Prints the running loss, accuracy and
        samples/s every ``print_freq`` steps, the only host fetches inside
        the epoch. The metrics are global: every step sums them over
        ranks. ``start_step`` labels a mid-epoch resume (the caller hands
        an iterator that starts there; the augmentation draws follow
        ``state.step``, so the resumed trajectory is the same).
        ``fault_hook(i)`` runs before step ``i`` of this call executes
        (the supervisor's step fence: a raise there means the optimizer
        never applied the step); ``stop_fn()`` runs after every step, and
        True ends the epoch there."""
        cfg = self.config
        epoch_metrics = zero_metrics(self.device)
        t_epoch = time.perf_counter()
        meter = ThroughputMeter()
        steps_done = 0
        for i, batch in enumerate(batches):
            if fault_hook is not None:
                fault_hook(i)
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
                    f"Step [{start_step + i + 1}/{steps_per_epoch}] "
                    f"Loss: {avg_loss:.4f}  "
                    f"Acc: {avg_acc:.2f}%  "
                    f"Throughput: {meter.rate():.2f} samples/s (global)"
                )
                meter.reset()
            if stop_fn is not None and stop_fn():
                break
        _sync(self.device)
        epoch_time = time.perf_counter() - t_epoch
        loss, acc = summarize(epoch_metrics)
        return state, loss, acc, epoch_time, steps_done

    def evaluate(self, state: TrainState,
                 batches: Iterable) -> Tuple[float, float]:
        """Sharded validation: each rank its rows, the totals summed over
        ranks once. (mean loss, top-1 %)."""
        totals = zero_metrics(self.device)
        for batch in batches:
            totals = add_metrics(totals, self.eval_step(state, batch))
        return summarize(_psum_metrics(totals, self.group))
