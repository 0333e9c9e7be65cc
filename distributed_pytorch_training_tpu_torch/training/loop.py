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

* ``_sharded_step``, the sharded update (JAX ``_zero1_step`` and
  ``_fsdp_step``): each rank's weight-scaled gradient is reduce-scattered
  at the wire dtype straight into this rank's chunk of the flat-padded
  layout (``parallel/sharding.py``), per leaf under ZeRO-1 and per layer
  group under explicit FSDP, and the optimizer updates only that chunk.
  ZeRO-1 keeps the parameters replicated and gathers them back after the
  update; FSDP keeps parameters and moments 1/N at rest and gathers each
  layer group's row before the step. BatchNorm as on the explicit
  reducer (each rank's own batch, statistics ``psum(w * s) / W``).

On a mesh with a ``seq`` axis (``parallel/mesh.py``; sequence
parallelism, ``--attention ring|ulysses``) each rank runs its own
positions of its batch shard's rows, so its gradient and its three sums
are partial over its tokens: the implicit step sums them over the data x
seq ranks (``group``), and the explicit reducer and the sharded update
are refused with the JAX Trainer's message (their collectives run over
the batch axes only).

Tensor parallelism (a mesh with a ``model`` axis of size M > 1; GPT-2):
the Trainer builds the TP-local model once from the caller's global one
(``clone(tp=...)``, its parameters the global init's slices, so the
leaves every model rank holds whole start equal), ``group`` spans the
batch (and seq) axes only, and the model's forward and backward run the
megatron all-reduces over the ``model`` group. Each model rank computes
the same loss, so the metrics and the gradient sums run over ``group``
only, never over ``model``; the replicated leaves' gradients come out
whole through ``copy_to_tp``. The global-norm clip weighs a replicated
leaf's squared sum 1/M and sums over the model ranks (the implicit step)
or the model x batch ranks (explicit FSDP, whose at-rest layout is the
TP-local leaves' chunks: JAX's model-major flat layout;
``parallel/sharding.py``). ``int8_hier`` does not compose with it (the
JAX Trainer's refusal). ZeRO-1 on a model mesh is JAX's
``_zero1_gspmd_apply``: the implicit step's gradient, fully summed, then
each TP-local leaf's update sharded elementwise over the batch ranks (its
gradient, parameters and moments flat-padded, this rank's chunk updated,
the moments born as chunks), the new chunks gathered back; the clip is
the global norm over the model axis and the ranks the chunks are spread
over (a replicated leaf weighs 1/M); a wire other than fp32 is refused
with JAX's message. Every clip of a split model is one ``ClipSpec``
(``Trainer._clip``), built with the layout.

The ``fsdp`` mesh axis (GSPMD's d_model sharding, alone or with
``model``): the batch is split over (data, fsdp) jointly, and every leaf
the rules place on ``fsdp`` (``sharding.fsdp_split_dims``; a TP-local
leaf is cut again) is held as its 1/F slice at rest, moments too, and
gathered whole on use (``collectives.gathered``), whose backward
reduce-scatters its gradient over the fsdp ranks. The implicit step sums
those gradients over the rest of the batch line (data x seq) and every
other leaf's over the whole line; the clip weighs a leaf replicated over
fsdp 1/F and sums over model x fsdp. ZeRO-1, ``fsdp_explicit`` and the
explicit reducer refuse a mesh whose rules shard parameters over a batch
axis, with the JAX Trainer's messages; with rules that never use
``fsdp`` (ResNet) the axis is plain data parallelism.

The pipeline (a ``pipe`` axis, ``models/gpt2_pipe.py``) and expert
parallelism (an ``expert`` axis, ``models/moe.py``) split the model the
same way, over their own axis: ``init_state`` cuts the caller's global
model (one draw) into this rank's stage or experts (``_split_model``,
``clone(pipe=...)`` or ``clone(expert=...)`` and the carrier), ``group``
is the batch (and seq) axes' line, and the loss, computed alike on every
rank of the split axis, is summed over ``group`` only. The replicated
leaves come out whole and equal on every rank without a sum after the
step: the pipeline sums its input's gradient over ``pipe`` inside its
backward (``parallel/pipeline.py``), the expert region its inputs' over
``expert`` (``copy_to_tp``). The clip weighs a replicated leaf 1/P (1/E)
and sums over the split axis, as under TP. Eval runs the same split
forward; nothing is gathered (the checkpoint joins the global arrays).
The explicit reducer and the sharded update refuse these axes with the
JAX Trainer's message.

The engagement rules are the JAX Trainer's: the reducer runs when
``bucket_cap_mb > 0`` or the wire is not fp32, on more than one rank, the
sharded update under ``zero1`` or ``fsdp_explicit`` on more than one rank;
on one rank either request is an identity passthrough (logged). The
``int8_hier`` wire needs ``slices`` > 1 (with one slice it is the flat
fp32 wire, logged). ``bf16`` (``--amp``) is the model's compute dtype,
chosen where the model is built; the step is the same. As in the JAX
package, the metrics are weighted sums that stay on the device; the host
fetches them only at print boundaries and at the end of an epoch, where
the step line also reports MFU once `Trainer.set_mfu_reference` is set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..convert import flax_ordered, load_tp_params
from .. import telemetry
from ..parallel.collectives import (FsdpShard, Group, TpAxis, all_gather,
                                    psum, world_size)
from ..parallel.grad_sync import (
    EF_WIRE_DTYPES, WIRE_DTYPES, BucketPlan, HierSpec,
    LayerPlan, axis_sizes, build_bucket_plan, build_hier_spec,
    build_layer_plan, compressed_psum_scatter, ef_state_bucketed, ef_state_fsdp,
    ef_state_zero1, flatten_tree, hier_delta_all_gather, hier_owner,
    hier_psum_scatter, hier_shard_all_gather, padded_total_size,
    quantized_delta_all_gather, quantized_shard_all_gather, reduce_flat,
    unflatten_tree,
)
from ..parallel.mesh import (AXIS_ORDER, BATCH_AXES, EXPERT, FSDP, MODEL,
                             PIPE, SEQ, SPLIT_AXES, Mesh)
from ..parallel.sharding import (PartitionRules, chunk_of, flatten_pad,
                                 fsdp_flat_params, fsdp_slice,
                                 fsdp_split_dims, mesh_clip_weights,
                                 tp_split_dims, unflatten_padded)
from ..runtime import DeviceLike, not_ported, resolve_device
from ..utils import prng
from ..utils.logging import log_main
from ..utils.metrics import ThroughputMeter
from .tasks import (Metrics, StepKey, Task, add_metrics, summarize,
                    zero_metrics)
from .train_state import ClipSpec, FlatSharding, FsdpLayout, TpLayout, \
    TrainState
from .optim import GradientTransformation

METRIC_NAMES = ("loss_sum", "correct", "weight")
# the model field that makes a model local to a split axis
# (``clone(**{field: axis})``)
SPLIT_FIELDS = {MODEL: "tp", PIPE: "pipe", EXPERT: "expert"}
# what the fsdp axis does not compose with yet -> the slice that brings it
FSDP_LATER = "a later slice of the fsdp axis (fsdp with seq, pipe or expert)"
EXPERT_TP = ("the expert x model slice (a Trainer that splits the model "
             "over two axes)")


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
    # the slice factor of the ranks (the JAX mesh's ``slice`` axis,
    # outermost): rank r is in slice r // (world / slices)
    slices: int = 1
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


def _rows(batch: Dict[str, torch.Tensor]) -> int:
    """This rank's rows in ``batch``."""
    return int(batch["weight"].shape[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _psum_metrics(m: Metrics, group: Group) -> Metrics:
    """The three weighted sums summed over ranks: one all-reduce."""
    summed = psum(torch.stack([m[k] for k in METRIC_NAMES]), group)
    return dict(zip(METRIC_NAMES, summed.unbind(0)))


class Trainer:
    """Owns the train and eval steps for one task on this rank's device;
    ``group`` is the process group the gradient and the metrics are summed
    over (the default group when None; one process without one).
    ``mesh`` (``parallel/mesh.py``) lays the ranks out: on a mesh with an
    axis outside the batch axes (``seq``), ``group`` spans the data x seq
    ranks, only the implicit step runs (one fp32 sum of the gradient, as
    the JAX Trainer), and the rows a rank holds are those of its batch
    coordinate."""

    def __init__(self, task: Task, config: TrainConfig,
                 device: DeviceLike = None, group: Group = None,
                 mesh: Optional[Mesh] = None,
                 rules: Optional[PartitionRules] = None):
        if config.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype {config.wire_dtype!r} is not one "
                             f"of {WIRE_DTYPES}")
        if config.bucket_cap_mb < 0:
            raise ValueError(f"bucket_cap_mb must be >= 0, got "
                             f"{config.bucket_cap_mb}")
        if config.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{config.grad_accum}")
        if config.zero1 and config.bucket_cap_mb > 0:
            raise ValueError(
                "bucket_cap_mb is the bucketed reducer of the replicated "
                "update path; zero1's per-leaf flat-shard layout IS its "
                "optimizer-state (and checkpoint) format — use zero1 with "
                "wire_dtype compression, or the bucketed reducer without "
                "zero1, not both")
        if config.fsdp_explicit and config.zero1:
            raise ValueError(
                "fsdp_explicit IS zero1 plus flat-sharded parameters (the "
                "sharded update with per-layer just-in-time gathers) — "
                "pick one update mode, not both")
        if config.fsdp_explicit and config.bucket_cap_mb > 0:
            raise ValueError(
                "bucket_cap_mb cuts the replicated reducer's flat "
                "gradient; fsdp_explicit's wire layout is the per-layer "
                "cut of the parameter tree (grad_sync.build_layer_plan) — "
                "use fsdp_explicit with wire_dtype compression instead")
        self.task = task
        self.config = config
        self.device = resolve_device(device)
        # tensor parallelism (model), the pipeline (pipe) or the experts
        # (expert): the one axis whose ranks hold parts of the model and
        # compute the same loss; the gradient and metric sums run over
        # the other axes' line
        self.tp = TpAxis(1)
        self.split_axis: Optional[str] = None
        if mesh is not None:
            split = [a for a in SPLIT_AXES if mesh.shape[a] > 1]
            if set(split) == {MODEL, EXPERT}:
                raise not_ported(f"mesh axes {split} > 1 together",
                                 EXPERT_TP)
            if len(split) > 1:
                raise ValueError(
                    f"mesh axes {split} > 1 together: the Trainer splits "
                    "the model over one of model, pipe and expert")
            if split:
                self.split_axis = split[0]
                if group is None:
                    group = mesh.group(tuple(a for a in AXIS_ORDER
                                             if a not in SPLIT_AXES))
        if self.split_axis == MODEL:
            self.tp = mesh.tp()
        # the fsdp axis's ranks (its leaves are laid out by init_state)
        self.fsdp = (mesh.axis_shard(FSDP) if mesh is not None
                     and mesh.shape[FSDP] > 1 else TpAxis(1))
        self.rules = rules
        self.group = group
        self.n_shards = world_size(group)
        self.rank = (torch.distributed.get_rank(group)
                     if self.n_shards > 1 else 0)
        # the MFU reference (set_mfu_reference): the step line reports MFU
        # when both are set
        self._flops_per_sample: Optional[float] = None
        self._peak_flops_total: Optional[float] = None
        # the anomaly watchdog (telemetry/watchdog.py), fed by train_epoch
        # when the entry point sets one
        self.watchdog = None
        # the epoch of the JAX step key (set by train_epoch)
        self.epoch = 0
        explicit_sync = (config.bucket_cap_mb > 0
                         or config.wire_dtype != "fp32")
        self.mesh = mesh
        if mesh is not None and (config.zero1 or config.fsdp_explicit
                                 or explicit_sync):
            # the JAX Trainer's rule and message: these modes sync over
            # the batch axes alone
            mode = ("fsdp_explicit" if config.fsdp_explicit
                    else "zero1" if config.zero1
                    else "grad_sync (bucket_cap_mb/wire_dtype)")
            allowed = ({MODEL} if (config.zero1 or config.fsdp_explicit)
                       else set())
            bad = sorted(a for a, size in mesh.shape.items()
                         if size > 1 and a not in BATCH_AXES
                         and a not in allowed)
            if bad:
                raise ValueError(
                    f"{mode} runs gradient sync over the data-parallel "
                    f"axes {BATCH_AXES}; mesh axes {bad} > 1 need the "
                    "implicit path (SP/PP/EP collectives are per-layer, "
                    "not per-update; only zero1 and fsdp_explicit compose "
                    "with a model axis — zero1 via the per-leaf GSPMD "
                    "update, fsdp_explicit via explicit megatron TP)")
        if config.fused_quantize is False and self.device.type == "cuda":
            raise ValueError(
                "--fused-quantize off selects the composed int8 codec, "
                "which the port has only as the plain versions on the CPU; "
                "on CUDA the codec is the kernels (auto or on)")
        multi = self.n_shards > 1
        self._fsdp = bool(config.fsdp_explicit) and (
            multi or self.tp.size > 1)
        # ZeRO-1 on a model mesh: JAX's per-leaf GSPMD update
        self._zero1_tp = bool(config.zero1) and multi and self.tp.size > 1
        if self._zero1_tp and config.wire_dtype != "fp32":
            raise ValueError(
                "zero1 on a model-axis mesh runs the GSPMD sharded "
                "update, where the scatter/gather are layout "
                "constraints, not explicit collectives the codecs "
                "could wrap — a compressed wire on a model-axis mesh "
                "is --fsdp-explicit's job (explicit TP x FSDP owns "
                "its wire layout end to end; PARITY.md records this "
                "path as subsumed); use wire_dtype='fp32' here")
        self._zero1 = bool(config.zero1) and multi and not self._zero1_tp
        self._grad_sync = (explicit_sync and not config.zero1
                           and not config.fsdp_explicit and multi)
        self._implicit_dp = multi and not (
            explicit_sync or self._zero1 or self._fsdp)
        self._wire = config.wire_dtype
        self._hier: Optional[HierSpec] = None
        if config.wire_dtype == "int8_hier":
            self._resolve_hier()
        self._plan: Optional[BucketPlan] = None
        # the sharded update's scatter units: one per leaf (zero1), one
        # per layer group (fsdp); built by init_state
        self._layers: Optional[LayerPlan] = None
        self._materialized = False
        # the fsdp axis's layout (init_state): the leaves split over it,
        # and the group their gradients are summed over after the
        # reduce-scatter (the batch line without fsdp)
        self._fsdp_dims: Optional[Tuple[Optional[int], ...]] = None
        self._fsdp_rest: Group = None
        if rules is not None:
            self._refuse_param_rules(rules)
        if config.zero1 and not multi:
            log_main("NOTE: zero1 requested on a single batch shard — "
                     "running the replicated update (identity "
                     "passthrough, like single-process DDP)")
        if config.fsdp_explicit and not self._fsdp:
            log_main("NOTE: fsdp_explicit requested on a single batch "
                     "shard — nothing to shard; running the "
                     "replicated update (identity passthrough)")
        if (not config.zero1 and not config.fsdp_explicit
                and explicit_sync and not self._grad_sync):
            log_main("NOTE: explicit gradient sync requested on a single "
                     "batch shard — nothing to synchronize; running the "
                     "implicit path (identity passthrough, like "
                     "single-process DDP)")

    def _refuse_param_rules(self, rules: PartitionRules) -> None:
        """The JAX Trainer's refusal of ZeRO-1, ``fsdp_explicit`` and the
        explicit reducer when ``rules`` shard parameters over a batch
        axis of the mesh (the ``fsdp`` axis): those modes assume
        replicated parameters, same messages."""
        cfg = self.config
        explicit_sync = cfg.bucket_cap_mb > 0 or cfg.wire_dtype != "fp32"
        if self.mesh is None or not (cfg.zero1 or cfg.fsdp_explicit
                                     or explicit_sync):
            return
        conflict = sorted(rules.axes_used()
                          & {a for a in BATCH_AXES if self.mesh.shape[a] > 1})
        if not conflict:
            return
        if cfg.fsdp_explicit:
            raise ValueError(
                "fsdp_explicit owns the parameter layout "
                "(flat-sharded 1/N over the batch axes) and would "
                f"silently drop the partition rules sharding "
                f"params over {conflict} — use GSPMD rules with "
                "the implicit path, or fsdp_explicit without "
                "param-sharding rules, not both")
        mode = "zero1" if cfg.zero1 else \
            "grad_sync (bucket_cap_mb/wire_dtype)"
        raise ValueError(
            f"{mode} assumes replicated parameters, but the "
            f"partition rules shard params over {conflict} — "
            "explicitly sharded params + explicit sync is "
            "fsdp_explicit's job (TrainConfig.fsdp_explicit / "
            "--fsdp-explicit); GSPMD fsdp rules need the "
            "implicit path")

    def _resolve_hier(self) -> None:
        """The ``int8_hier`` wire's slice factorization (JAX: read off the
        mesh): with more than one slice, the HierSpec and its process
        groups; with one, the flat fp32 wire, bitwise (logged)."""
        cfg, n = self.config, self.n_shards
        if self._fsdp and self.tp.size > 1:
            raise ValueError(
                "int8_hier does not compose with explicit TP: the model "
                "axis runs megatron psums with their own wire accounting, "
                "and the hier codec's fast-tier reduce-scatter would have "
                "to thread through them — use int8_multihop under "
                "fsdp_explicit x TP, or int8_hier on a model-free mesh")
        if cfg.slice_axis not in BATCH_AXES:
            raise ValueError(
                f"int8_hier syncs over the batch axes {BATCH_AXES}; "
                f"slice_axis={cfg.slice_axis!r} is not one of them — the "
                "slow tier must be a data-parallel mesh axis "
                "(mesh.SLICE by default, populated by --slices)")
        if cfg.slices < 1 or n % cfg.slices:
            raise ValueError(
                f"int8_hier: {n} batch shards do not factor into "
                f"{cfg.slices} slices (world % slices != 0)")
        n_slices = axis_sizes(n, cfg.slices)[cfg.slice_axis]
        if n_slices > 1:
            self._hier = build_hier_spec(n, self.rank, cfg.slices,
                                         cfg.slice_axis)
        else:
            self._wire = "fp32"
            log_main("NOTE: int8_hier requested without a multi-slice "
                     f"mesh (axis {cfg.slice_axis!r} size {n_slices}) — "
                     "running the flat fp32 wire (bit-identical "
                     "passthrough)")

    @property
    def batch_index(self) -> int:
        """The shard of the global batch this rank holds: its position on
        the mesh's batch axes (its rank on a data-only mesh)."""
        return self.mesh.batch_index if self.mesh is not None else self.rank

    @property
    def sharded(self) -> bool:
        """True when the update is sharded (ZeRO-1 or explicit FSDP over
        several ranks)."""
        return self._zero1 or self._fsdp

    def wire_accounting_inputs(self, state: TrainState, base_cfg: dict,
                               seq_len: int = 0) -> Tuple[List, dict]:
        """(leaves, cfg) for `grad_sync.emit_wire_accounting`: the
        model-shaped parameters (under FSDP, meta tensors of the at-rest
        chunks' model shapes; under tensor parallelism the TP-local ones,
        each model shard gathering and scattering its slice only) and
        ``base_cfg`` with the resolved slice count (an ``int8_hier``
        passthrough records the flat fp32 wire it runs) and, under tensor
        parallelism, the model axis's bytes of a step of ``seq_len``
        tokens a row."""
        cfg = dict(base_cfg)
        leaves = list(state.params)
        if self._fsdp:
            leaves = [torch.empty(shape, device="meta")
                      for shape in state.sharding.shapes]
        if self.tp.size > 1:
            cfg["model_shards"] = self.tp.size
            cfg["tp_psum_bytes"] = self.tp_wire_bytes(
                state, self.config.per_device_batch, seq_len)
        if self._hier is not None:
            cfg["slices"] = self._hier.n_slices
        elif cfg.get("wire_dtype") == "int8_hier":
            cfg["wire_dtype"] = self._wire
        return leaves, cfg

    def tp_wire_bytes(self, state: TrainState, local_batch: int,
                      seq_len: int) -> int:
        """This rank's model-axis bytes of one step
        (`grad_sync.tp_psum_bytes_per_step` of the TP model)."""
        from ..parallel.grad_sync import tp_psum_bytes_per_step

        m = state.model
        if self.tp.size <= 1 or getattr(m, "depth", None) is None:
            return 0
        return tp_psum_bytes_per_step(m.hidden_dim, m.depth, local_batch,
                                      seq_len, self.tp.size,
                                      tp_vocab=m.tp_vocab)

    def set_mfu_reference(self, flops_per_sample: float,
                          peak_flops_total: float) -> None:
        """Enable MFU in the step line: ``flops_per_sample`` is one
        sample's train-step cost (3x the forward's matmul FLOPs,
        ``experiments/flops.py``), ``peak_flops_total`` the summed peak
        FLOP/s of the devices."""
        self._flops_per_sample = flops_per_sample
        self._peak_flops_total = peak_flops_total

    def init_state(self, model: torch.nn.Module,
                   tx: GradientTransformation) -> TrainState:
        """Move ``model`` (initialized by the caller, the same on every
        rank) to the device, build its optimizer and, for an int8 wire,
        this rank's zero error-feedback residual. On the implicit path over
        several ranks, the model's BatchNorms normalize by the global
        batch. Under the sharded update the optimizer is born on this
        rank's chunks (ZeRO-1), and under explicit FSDP the parameters
        become their chunks too."""
        rules = self.rules
        if rules is None and hasattr(type(model), "partition_rules"):
            rules = type(model).partition_rules()
        # the fsdp axis's dims, read off the global shapes (JAX's
        # feasible_spec)
        fsdp_dims = None
        if self.fsdp.size > 1 and rules is not None:
            self._refuse_param_rules(rules)
            template = [(n, tuple(p.shape))
                        for n, p in flax_ordered(model.named_parameters())]
            dims = fsdp_split_dims(template, rules, self.fsdp.size,
                                   self.tp.size)
            if any(d is not None for d in dims.values()):
                fsdp_dims = dims
        layout = None
        if self.split_axis is not None:
            model, layout = self._split_model(model)
        model = model.to(self.device)
        fsdp = (self._fsdp_split(model, fsdp_dims)
                if fsdp_dims is not None else None)
        if self.sharded:
            state = self._init_sharded(model, tx, layout)
            state.tp = layout
            if layout is not None:
                state.clip = self._clip(layout, None, sharded=True)
            return state
        if self._zero1_tp:
            return self._init_zero1_tp(model, tx, layout)
        state = TrainState.create(model, tx)
        state.tp, state.fsdp = layout, fsdp
        if layout is not None or fsdp is not None:
            state.clip = self._clip(layout, fsdp)
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
                hier = self._hier
                state.grad_sync = ef_state_bucketed(
                    state.params, self.n_shards, self.config.bucket_cap_mb,
                    self._wire, self.device,
                    n_slices=hier.n_slices if hier is not None else 1)
        return state

    def _fsdp_split(self, model: torch.nn.Module,
                    dims: Dict[str, Optional[int]]) -> FsdpLayout:
        """Cut every leaf ``dims`` places on the fsdp axis to this rank's
        1/F slice (of its TP-local leaf under tensor parallelism), marked
        for gathering on use; the layout. Refuses the axes the fsdp axis
        does not compose with yet."""
        for axis in (SEQ, PIPE, EXPERT):
            if self.mesh.shape[axis] > 1:
                raise not_ported(f"the fsdp axis with {axis}="
                                 f"{self.mesh.shape[axis]}", FSDP_LATER)
        ax = self.fsdp
        named = flax_ordered(model.named_parameters())
        shapes = tuple(tuple(p.shape) for _, p in named)
        with torch.no_grad():
            for name, p in named:
                d = dims[name]
                if d is not None:
                    p.data = fsdp_slice(p.data, d, ax.size, ax.index).clone()
                    p.fsdp = FsdpShard(d, ax)
        self._fsdp_dims = tuple(dims[n] for n, _ in named)
        self._fsdp_rest = self.mesh.group(tuple(
            a for a in AXIS_ORDER if a not in SPLIT_AXES and a != FSDP))
        return FsdpLayout(axis=ax, names=tuple(n for n, _ in named),
                          dims=self._fsdp_dims, shapes=shapes)

    def _clip(self, layout: Optional[TpLayout],
              fsdp: Optional[FsdpLayout], sharded: bool = False,
              targets: Optional[List[torch.Tensor]] = None) -> ClipSpec:
        """The global-norm clip of a model split over a mesh axis and/or
        the fsdp axis: the squared sums are summed over the ranks of
        every axis the parameters are split on and, when the update is
        sharded (``sharded``: each rank of the batch line updates its
        own chunk of every leaf), of the batch line's axes too; a leaf
        weighs 1/n for each split axis of n ranks that holds copies of
        it."""
        parts = []
        if layout is not None:
            parts.append((self.split_axis, layout.split_dims,
                          layout.axis.size))
        if fsdp is not None:
            parts.append((FSDP, fsdp.dims, fsdp.axis.size))
        axes = tuple(a for a, _, _ in parts)
        if sharded:
            axes += tuple(a for a in AXIS_ORDER
                          if a not in SPLIT_AXES and a not in axes)
        return ClipSpec(mesh_clip_weights([d for _, d, _ in parts],
                                          [n for _, _, n in parts]),
                        self.mesh.group(axes), targets=targets)

    def _init_zero1_tp(self, model: torch.nn.Module,
                       tx: GradientTransformation,
                       layout: TpLayout) -> TrainState:
        """ZeRO-1 on a model mesh (JAX ``_zero1_gspmd_apply``): the
        TP-local parameters stay whole; the optimizer is born on this
        rank's chunk of every leaf's flat-padded vector over the batch
        ranks, its moments 1/N; the clip sums over the model axis and
        the ranks the chunks are spread over, a model-replicated leaf
        weighing 1/M."""
        n = self.n_shards
        named = flax_ordered(model.named_parameters())
        sharding = FlatSharding(
            mode="zero1", n_shards=n, rank=self.rank,
            owners=tuple(range(n)), names=tuple(n_ for n_, _ in named),
            shapes=tuple(tuple(p.shape) for _, p in named),
            group=self.group)
        sharding.shards = [chunk_of(p.detach(), n, self.rank
                                    ).requires_grad_() for _, p in named]
        state = TrainState(step=0, model=model,
                           optimizer=tx.init(sharding.shards), tx=tx,
                           sharding=sharding, tp=layout)
        state.clip = self._clip(layout, None, sharded=True,
                                targets=sharding.shards)
        self._plan = build_bucket_plan(state.params, 0.0)
        return state

    def _zero1_tp_apply(self, state: TrainState,
                        grads: List[torch.Tensor]) -> None:
        """The sharded update of ZeRO-1 on a model mesh: this rank's
        chunk of each summed gradient updates its chunk of the
        parameters and moments, and the batch ranks' new chunks are
        gathered back into the TP-local leaves."""
        sh, group = state.sharding, self.group
        n, own = sh.n_shards, sh.owner
        for t, g in zip(sh.shards, grads):
            t.grad = flatten_pad(g.float(), n).reshape(n, -1)[own].clone()
        state.apply_gradients()
        with torch.no_grad():
            for p, t in zip(state.params, sh.shards):
                p.copy_(unflatten_padded(all_gather(t.detach(), group),
                                         p.shape))

    def _sum_grads(self, grads: List[torch.Tensor],
                   params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The implicit step's gradient sum over the ranks: one fp32
        bucket over ``group``; under the fsdp axis the leaves split over
        it (reduce-scattered in their backward already) are summed over
        the rest of the batch line apart."""
        if self._fsdp_dims is None:
            flat, _ = reduce_flat(flatten_tree(grads), self._plan,
                                  self.n_shards, "fp32", group=self.group)
            return unflatten_tree(flat, params)
        split = [i for i, d in enumerate(self._fsdp_dims) if d is not None]
        rest = [i for i, d in enumerate(self._fsdp_dims) if d is None]
        out = list(grads)
        for idx, group in ((split, self._fsdp_rest), (rest, self.group)):
            if not idx or world_size(group) == 1:
                continue
            like = [params[i] for i in idx]
            flat = psum(flatten_tree([grads[i] for i in idx]), group)
            for i, g in zip(idx, unflatten_tree(flat, like)):
                out[i] = g
        return out

    def _split_model(self, model: torch.nn.Module
                     ) -> Tuple[torch.nn.Module, TpLayout]:
        """(the local clone of the global ``model`` on ``split_axis``,
        with this rank's slices of its parameters; the layout): TP's
        column/row shards on ``model``, one stage of the stacked blocks
        on ``pipe``, E/ep experts of every MoE layer on ``expert``. One
        draw, sliced, so the leaves every rank holds whole start equal.
        The refusals on ``model`` are the JAX Trainer's."""
        axis_name = self.split_axis
        axis = self.mesh.axis_shard(axis_name)
        tp_form = (hasattr(model, "clone") and hasattr(model, "tp")
                   and hasattr(type(model), "partition_rules"))
        if axis_name == MODEL and not (
                tp_form and (not self._fsdp
                             or getattr(model, "fsdp_explicit_tp", False))):
            # fsdp_explicit takes GPT-2 only: the JAX Trainer refuses
            # every model without its tp_size/tp_axis fields there
            mode = ("fsdp_explicit" if self.config.fsdp_explicit
                    else "the implicit path")
            raise ValueError(
                f"mesh has model={axis.size} under {mode}, but "
                f"{type(model).__name__} has no explicit-TP form "
                "(tp_size/tp_axis fields) — gpt2_* models support "
                "explicit TP; others need a 1-D mesh or the implicit "
                "GSPMD path")
        if not (hasattr(model, "clone")
                and hasattr(model, SPLIT_FIELDS[axis_name])):
            raise ValueError(f"mesh has {axis_name}={axis.size}, but "
                             f"{type(model).__name__} does not split over "
                             f"the {axis_name} axis")
        heads = getattr(model, "num_heads", None)
        if axis_name == MODEL and heads is not None and heads % axis.size:
            raise ValueError(
                f"num_heads={heads} not divisible by the mesh's "
                f"model={axis.size} — explicit TP splits attention by whole "
                "heads")
        named = flax_ordered(model.named_parameters())
        template = [(n, tuple(p.shape)) for n, p in named]
        split = tp_split_dims(template, type(model).partition_rules(),
                              axis.size, axis_name)
        local = model.clone(**{SPLIT_FIELDS[axis_name]: axis},
                            device="cpu")
        load_tp_params(local, {n: p for n, p in named}, split, axis)
        layout = TpLayout(
            axis=axis, names=tuple(n for n, _ in named),
            split_dims=tuple(split[n] for n, _ in named),
            shapes=tuple(s for _, s in template),
            ranks=tuple(tuple(self.mesh.line(BATCH_AXES, r))
                        for r in self.mesh.line(axis_name)),
            axis_name=axis_name)
        return local, layout

    def _init_sharded(self, model: torch.nn.Module,
                      tx: GradientTransformation,
                      layout: Optional[TpLayout] = None) -> TrainState:
        n = self.n_shards
        named = flax_ordered(model.named_parameters())
        # tensor parallelism: the replicated leaves' own layer groups
        replicated = (None if layout is None else
                      {name for name, d in zip(layout.names,
                                               layout.split_dims)
                       if d is None})
        # the chunk each rank holds: itself, or the fast-major index of
        # the int8_hier wire
        owners = tuple(r if self._hier is None else hier_owner(
            r, n, self.config.slices, self.config.slice_axis)
            for r in range(n))
        own = owners[self.rank]
        # the rank that holds each chunk, in chunk order
        self._chunk_ranks = sorted(range(n), key=owners.__getitem__)
        sharding = FlatSharding(
            mode="fsdp" if self._fsdp else "zero1", n_shards=n,
            rank=self.rank, owners=owners,
            names=tuple(name for name, _ in named),
            shapes=tuple(tuple(p.shape) for _, p in named))
        self._layers = build_layer_plan(named, n, per_leaf=self._zero1,
                                        replicated=replicated)
        with torch.no_grad():
            if self._fsdp:
                opt_params = [p for _, p in named]
                for p, c in zip(opt_params,
                                fsdp_flat_params(opt_params, n, own)):
                    p.data = c
            else:
                sharding.shards = [chunk_of(p, n, own).requires_grad_()
                                   for _, p in named]
                opt_params = sharding.shards
        state = TrainState(step=0, model=model,
                           optimizer=tx.init(opt_params), tx=tx,
                           sharding=sharding)
        if self._wire in EF_WIRE_DTYPES:
            n_inner = self._hier.n_inner if self._hier is not None else 1
            metas = [(name, torch.empty(s, device="meta"))
                     for name, s in zip(sharding.names, sharding.shapes)]
            state.grad_sync = (
                ef_state_fsdp(metas, n, n_inner, self.device, replicated)
                if self._fsdp else
                ef_state_zero1(metas, n, n_inner, self.device))
        return state

    def _generator(self, step: int, micro: int) -> torch.Generator:
        """The step's CPU generator for augmentation draws, seeded by
        (seed, step, rank, microbatch)."""
        seed = np.random.SeedSequence(
            [self.config.seed, step, self.rank, micro]).generate_state(1)[0]
        return torch.Generator().manual_seed(int(seed))

    def _step_keys(self, step: int, rows: int, replica: bool
                   ) -> List[Optional[StepKey]]:
        """The JAX step's key for each microbatch of this rank's ``rows``
        (None for a task that draws none): ``fold_in(fold_in(PRNGKey(seed),
        epoch), step)``, split once per microbatch under accumulation. The
        replicated step draws over the global (micro)batch, of which this
        rank holds one block of rows; the explicit reducer and the sharded
        update draw over each rank's own rows after ``fold_in(key,
        rank)``, as the JAX package's per-replica bodies do."""
        accum = max(self.config.grad_accum, 1)
        if not self.task.needs_key:
            return [None] * accum
        rng = prng.fold_in(prng.fold_in(prng.prng_key(self.config.seed),
                                        self.epoch), step)
        keys = [rng] if accum == 1 else list(prng.split(rng, accum))
        if replica:
            return [StepKey(prng.fold_in(k, self.batch_index))
                    for k in keys]
        return [StepKey(k, rows // accum * self.batch_index) for k in keys]

    # -- steps --------------------------------------------------------------

    def train_step(self, state: TrainState,
                   batch: Dict[str, torch.Tensor]) -> Metrics:
        """One optimizer step on ``batch`` (this rank's rows); returns its
        weighted-sum metrics, summed over ranks (on the device)."""
        state.model.train()
        if self.sharded:
            return self._sharded_step(state, batch)
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
        keys = self._step_keys(state.step, _rows(batch), replica=False)
        for i, mb in enumerate(micro):
            loss, m, stats = self.task.loss_and_metrics(
                model, mb, True, self._generator(state.step, i), keys[i])
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
            g_sum = self._sum_grads(g_sum, params)
        total_w = torch.clamp(metrics["weight"], min=1.0)
        if accum > 1:
            g_sum = [(g / total_w).to(p.dtype) for p, g in zip(params, g_sum)]
        if self._zero1_tp:
            self._zero1_tp_apply(state, g_sum)
        else:
            for p, g in zip(params, g_sum):
                p.grad = g
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
                      else padded_total_size(plan, n) // self._hier.n_inner
                      if wire == "int8_hier" else plan.total_size)
            if ef.shape[-1] != expect:
                raise ValueError(
                    f"error-feedback residual length {ef.shape[-1]} does "
                    f"not match the {wire!r} wire's layout for "
                    f"bucket_cap_mb={cfg.bucket_cap_mb} ({expect} "
                    "elements)")

        keys = self._step_keys(state.step, _rows(batch), replica=True)

        def local_flat(mb, micro_index):
            loss, m, stats = self.task.loss_and_metrics(
                model, mb, True, self._generator(state.step, micro_index),
                keys[micro_index])
            grads = torch.autograd.grad(loss, params)
            w = m["weight"]
            return flatten_tree([w * g.float() for g in grads]), m, \
                {name: w * s for name, s in stats.items()}

        if cfg.grad_accum <= 1:
            flat, m_local, s_sum = local_flat(batch, 0)
            flat, ef = reduce_flat(flat, plan, n, wire, ef, group,
                                   self._hier)
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
                    f_i, ef = reduce_flat(f_i, plan, n, wire, ef, group,
                                          self._hier)
                flat = flat + f_i
                for name, v in s.items():
                    s_sum[name] = s_sum.get(name, 0.0) + v
                m_local = add_metrics(m_local, m)
            if not cfg.overlap_grad_sync:
                flat, ef = reduce_flat(flat, plan, n, wire, ef, group,
                                       self._hier)

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

    def _sharded_step(self, state: TrainState,
                      batch: Dict[str, torch.Tensor]) -> Metrics:
        """The sharded update (JAX ``_zero1_step``, ``_fsdp_step``). Each
        rank differentiates its local batch against the full parameters
        (FSDP: gathered first, one collective per layer group at the
        wire's gather: exact, s8 under ``int8_multihop``, two-tier under
        ``int8_hier``), reduce-scatters each leaf (zero1) or layer group's
        destination-major row stack (FSDP) of its weight-scaled gradient
        at the wire dtype into this rank's chunk, and updates only that
        chunk of the parameters and moments (the clip's norm summed over
        the ranks). ZeRO-1 then gathers the new parameters: exactly, or
        as s8 update codes (``int8_multihop``, ``int8_hier``); FSDP keeps
        the new chunks. ``int8_multihop`` scatters with the ``int8``
        codec. Under accumulation each microbatch is scattered as soon as
        its gradient exists and the chunks accumulate."""
        cfg, n, group = self.config, self.n_shards, self.group
        wire, hier = self._wire, self._hier
        sh, plan = state.sharding, self._layers
        if sh is None or plan is None:
            raise ValueError(
                "fsdp_explicit needs the per-layer plan and unflatten "
                "template — build the state via Trainer.init_state")
        scatter_wire = "int8" if wire == "int8_multihop" else wire
        use_ef = wire in EF_WIRE_DTYPES
        ef = dict(state.grad_sync.get("ef") or {}) if use_ef else None
        if use_ef:
            if not ef:
                raise ValueError(
                    f"wire_dtype={wire!r} needs error-feedback buffers — "
                    "build the state via Trainer.init_state")
            n_inner = hier.n_inner if hier is not None else 1
            for g in plan.groups:
                got, expect = ef[g.name].numel(), n * g.row_size // n_inner
                if got != expect:
                    raise ValueError(
                        f"error-feedback residual for "
                        f"{'layer group' if self._fsdp else 'leaf'} "
                        f"{g.name!r} has {got} elements, expected {expect} "
                        "— the state was built for a different model/mesh; "
                        "rebuild via Trainer.init_state")
        model, params = state.model, state.params
        if self._fsdp:
            full = self._fsdp_gather(params, sh, self._fsdp_row_gather)
            rest = [p.data for p in params]
            for p, f in zip(params, full):
                p.data = f

        def scatter(grads, w, into):
            for g in plan.groups:
                parts = [flatten_pad((w * grads[s]).float(), n).reshape(n, -1)
                         for s in g.leaf_slots]
                v = (torch.cat(parts, dim=1) if len(parts) > 1
                     else parts[0]).reshape(-1)
                r = ef[g.name] if use_ef else None
                if hier is not None:
                    out, new_r = hier_psum_scatter(v, hier, r)
                else:
                    out, new_r = compressed_psum_scatter(v, n, scatter_wire,
                                                         r, group)
                for s, chunk in zip(g.leaf_slots,
                                    out.split(list(g.chunk_sizes))):
                    into[s] = chunk if into[s] is None else into[s] + chunk
                if use_ef:
                    ef[g.name] = new_r

        micro = [batch]
        if cfg.grad_accum > 1:
            split = split_microbatches(batch, cfg.grad_accum,
                                       scope="per-shard batch")
            micro = [{k: x[i].contiguous() for k, x in split.items()}
                     for i in range(cfg.grad_accum)]
        g_sum: list = [None] * len(params)
        s_sum: Dict[str, torch.Tensor] = {}
        m_local = zero_metrics(self.device)
        keys = self._step_keys(state.step, _rows(batch), replica=True)
        try:
            for i, mb in enumerate(micro):
                loss, m, stats = self.task.loss_and_metrics(
                    model, mb, True, self._generator(state.step, i),
                    keys[i])
                grads = torch.autograd.grad(loss, params)
                w = m["weight"]
                scatter(grads, w, g_sum)
                for name, v in stats.items():
                    s_sum[name] = s_sum.get(name, 0.0) + w * v
                m_local = add_metrics(m_local, m)
                del loss, grads
        finally:
            if self._fsdp:
                for p, r in zip(params, rest):
                    p.data = r
        metrics = _psum_metrics(m_local, group)
        total_w = torch.clamp(metrics["weight"], min=1.0)
        own = sh.owner
        if self._fsdp:
            targets = params
        else:
            targets = sh.shards
            with torch.no_grad():
                for t, p in zip(targets, params):
                    t.copy_(flatten_pad(p.detach(), n).reshape(n, -1)[own])
            old = [t.detach().clone() for t in targets]
        for t, g in zip(targets, g_sum):
            t.grad = (g / total_w).to(t.dtype)
        state.apply_gradients(group)
        if self._zero1:
            with torch.no_grad():
                for p, t, o in zip(params, targets, old):
                    if wire == "int8_multihop":
                        flat = quantized_delta_all_gather(
                            t, o, flatten_pad(p, n), group)
                    elif hier is not None:
                        flat = hier_delta_all_gather(t, o,
                                                     flatten_pad(p, n), hier)
                    else:
                        flat = all_gather(t.detach(), group)
                    p.copy_(unflatten_padded(flat, p.shape))
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

    def _fsdp_row_gather(self, row: torch.Tensor) -> torch.Tensor:
        """One layer group's gather at the wire (the step's prologue)."""
        if self._wire == "int8_multihop":
            return quantized_shard_all_gather(row, self.group)
        if self._hier is not None:
            return hier_shard_all_gather(row, self._hier)
        return all_gather(row, self.group)

    def _exact_row_gather(self, row: torch.Tensor) -> torch.Tensor:
        """One layer group's exact gather, rows in chunk order (eval)."""
        rows = all_gather(row, self.group).reshape(self.n_shards, -1)
        return rows[self._chunk_ranks].reshape(-1)

    @torch.no_grad()
    def _fsdp_gather(self, chunks, sh: FlatSharding, gather
                     ) -> List[torch.Tensor]:
        """The model-shaped parameters from the at-rest chunks (flax
        order), one ``gather`` of each layer group's row."""
        n = self.n_shards
        full: List[Optional[torch.Tensor]] = [None] * len(chunks)
        for g in self._layers.groups:
            row = torch.cat([chunks[s].float() for s in g.leaf_slots])
            mat = gather(row).reshape(n, g.row_size)
            for s, block in zip(g.leaf_slots,
                                mat.split(list(g.chunk_sizes), dim=1)):
                full[s] = unflatten_padded(block.reshape(-1),
                                           sh.shapes[s]).to(chunks[s].dtype)
        return full

    @contextlib.contextmanager
    def materialized(self, state: TrainState):
        """Under explicit FSDP, the model holds its full parameters inside
        this context (an exact gather, as the JAX package unflattens for
        eval), its chunks again after; elsewhere a no-op (a model split
        over ``model``, ``pipe`` or ``expert`` evaluates through its
        split forward)."""
        if not self._fsdp or self._materialized:
            yield
            return
        params = state.params
        rest = [p.data for p in params]
        full = self._fsdp_gather(params, state.sharding,
                                 self._exact_row_gather)
        for p, f in zip(params, full):
            p.data = f
        self._materialized = True
        try:
            yield
        finally:
            self._materialized = False
            for p, r in zip(params, rest):
                p.data = r

    @torch.no_grad()
    def eval_step(self, state: TrainState,
                  batch: Dict[str, torch.Tensor]) -> Metrics:
        """This rank's weighted-sum metrics of ``batch`` (not summed over
        ranks: `evaluate` sums the totals once)."""
        state.model.eval()
        key = None
        if self.task.needs_key:
            # the JAX eval step's PRNGKey(0), every batch, over the global
            # batch: eval masks repeat from batch to batch
            key = StepKey(prng.prng_key(0), _rows(batch) * self.batch_index)
        with self.materialized(state):
            _, metrics, _ = self.task.loss_and_metrics(state.model, batch,
                                                       train=False, key=key)
        return metrics

    # -- epoch loops ----------------------------------------------------------

    def train_epoch(self, state: TrainState, batches: Iterable,
                    epoch: int, steps_per_epoch: int,
                    samples_per_step: Optional[Sequence[int]] = None,
                    step_hook: Optional[Callable[[int], None]] = None,
                    start_step: int = 0,
                    stop_fn: Optional[Callable[[], bool]] = None,
                    fault_hook: Optional[Callable[[int], None]] = None
                    ) -> Tuple[TrainState, float, float, float, int]:
        """One epoch. Returns (state, mean loss, top-1 %, epoch wall
        seconds, steps executed). Prints the running loss, accuracy and
        samples/s every ``print_freq`` steps, the only host fetches inside
        the epoch. The metrics are global: every step sums them over
        ranks. ``start_step`` labels a mid-epoch resume (the caller hands
        an iterator that starts there; the augmentation draws and the JAX
        step key (of ``epoch``, held in ``self.epoch``) follow
        ``state.step``, so the resumed trajectory is the same).
        ``fault_hook(i)`` runs before step ``i`` of this call executes
        (the supervisor's step fence: a raise there means the optimizer
        never applied the step); ``step_hook(start_step + i)`` runs after
        it, before the step (the profiler's windows); ``stop_fn()`` runs
        after every step, and True ends the epoch there.

        Telemetry (host clocks only; it adds no synchronization): per step
        a ``data_wait`` span (blocked on the loader iterator) and a
        ``step_dispatch`` span (the eager step's host time: on the card,
        its launches plus every host wait the step already has — gloo's
        collectives, the int8 codec's scale reads), a ``device_sync`` span
        around the epoch's one synchronization, and the epoch counters
        (``epoch_time_s``, ``steps``, ``samples``). ``self.watchdog`` (an
        AnomalyWatchdog) is fed the same timings plus the print-boundary
        losses; with its abort hook on, a detection raises AnomalyAbort —
        under the Supervisor, a restartable step failure like any
        other."""
        cfg = self.config
        self.epoch = epoch
        epoch_metrics = zero_metrics(self.device)
        t_epoch = time.perf_counter()
        meter = ThroughputMeter()
        steps_done = 0
        epoch_samples = 0
        watchdog = self.watchdog
        it = iter(batches)
        i = 0
        while True:
            t_wait = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            data_wait_s = time.perf_counter() - t_wait
            telemetry.span_event("data_wait", data_wait_s,
                                 step=start_step + i, epoch=epoch)
            if fault_hook is not None:
                fault_hook(i)
            if step_hook is not None:
                step_hook(start_step + i)
            t_disp = time.perf_counter()
            metrics = self.train_step(state, batch)
            dispatch_s = time.perf_counter() - t_disp
            telemetry.span_event("step_dispatch", dispatch_s,
                                 step=start_step + i, epoch=epoch)
            if watchdog is not None:
                watchdog.observe_step(start_step + i,
                                      data_wait_s + dispatch_s,
                                      data_wait_s=data_wait_s)
            epoch_metrics = add_metrics(epoch_metrics, metrics)
            steps_done = i + 1
            if samples_per_step is not None:
                n = samples_per_step[min(i, len(samples_per_step) - 1)]
                meter.update(n)
                epoch_samples += n
            if (i + 1) % cfg.print_freq == 0:
                avg_loss, avg_acc = summarize(epoch_metrics)
                if watchdog is not None:
                    watchdog.observe_loss(start_step + i, avg_loss)
                rate = meter.rate()
                mfu = ""
                if self._flops_per_sample and self._peak_flops_total:
                    mfu_pct = (100.0 * rate * self._flops_per_sample
                               / self._peak_flops_total)
                    mfu = f"  MFU: {mfu_pct:.1f}%"
                log_main(
                    f"Epoch [{epoch + 1}] "
                    f"Step [{start_step + i + 1}/{steps_per_epoch}] "
                    f"Loss: {avg_loss:.4f}  "
                    f"Acc: {avg_acc:.2f}%  "
                    f"Throughput: {rate:.2f} samples/s (global)" + mfu
                )
                meter.reset()
            if stop_fn is not None and stop_fn():
                break
            i += 1
        with telemetry.span("device_sync", epoch=epoch):
            _sync(self.device)
        epoch_time = time.perf_counter() - t_epoch
        telemetry.counter("epoch_time_s", epoch_time, epoch=epoch)
        telemetry.counter("steps", steps_done, epoch=epoch)
        if epoch_samples:
            telemetry.counter("samples", epoch_samples, epoch=epoch)
        loss, acc = summarize(epoch_metrics)
        return state, loss, acc, epoch_time, steps_done

    def evaluate(self, state: TrainState,
                 batches: Iterable) -> Tuple[float, float]:
        """Sharded validation: each rank its rows, the totals summed over
        ranks once. (mean loss, top-1 %)."""
        with telemetry.span("eval"):
            totals = zero_metrics(self.device)
            with self.materialized(state):
                for batch in batches:
                    totals = add_metrics(totals,
                                         self.eval_step(state, batch))
            return summarize(_psum_metrics(totals, self.group))
