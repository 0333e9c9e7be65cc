"""Training entry point of the PyTorch port: the LM path (GPT-2 causal LM,
BERT masked LM) and the image-classification path (ResNet, ViT) of the
JAX package's ``train.py``.

    python -m distributed_pytorch_training_tpu_torch.train --model resnet18 \\
        --synthetic --batch-size 128 --epochs 2

    python -m distributed_pytorch_training_tpu_torch.train --model bert_base \\
        --synthetic --batch-size 8 [--amp] [--remat]

    python -m distributed_pytorch_training_tpu_torch.train --model vit_b16 \\
        --dataset imagenet --synthetic --batch-size 64 --amp

    torchrun --standalone --nproc-per-node 2 \\
        -m distributed_pytorch_training_tpu_torch.train --model resnet18 \\
        --synthetic [--amp]

    torchrun --standalone --nproc-per-node 2 \\
        -m distributed_pytorch_training_tpu_torch.train --model resnet18 \\
        --synthetic --wire-dtype int8 --bucket-cap-mb 25

    torchrun --standalone --nproc-per-node 2 \\
        -m distributed_pytorch_training_tpu_torch.train --model resnet18 \\
        --synthetic --zero1 --wire-dtype int8       # or --fsdp-explicit

    torchrun --standalone --nproc-per-node 4 \\
        -m distributed_pytorch_training_tpu_torch.train --model resnet18 \\
        --synthetic --slices 2 --wire-dtype int8_hier --bucket-cap-mb 25

    torchrun --standalone --nproc-per-node 2 \\
        -m distributed_pytorch_training_tpu_torch.train --model gpt2_124m \\
        --synthetic --mesh data=1,seq=2 --attention ring   # or ulysses

    torchrun --standalone --nproc-per-node 4 \\
        -m distributed_pytorch_training_tpu_torch.train --model gpt2_124m \\
        --synthetic --mesh data=2,model=2 [--fsdp-explicit --wire-dtype int8]

    torchrun --standalone --nproc-per-node 2 \\
        -m distributed_pytorch_training_tpu_torch.train --model gpt2_124m \\
        --synthetic --mesh data=1,pipe=2 --microbatches 4

    torchrun --standalone --nproc-per-node 4 \\
        -m distributed_pytorch_training_tpu_torch.train --model gpt2_124m \\
        --synthetic --mesh data=2,fsdp=2      # or fsdp=2,model=2

    torchrun --standalone --nproc-per-node 4 \\
        -m distributed_pytorch_training_tpu_torch.train --model gpt2_124m \\
        --synthetic --mesh data=2,model=2 --zero1

    torchrun --standalone --nproc-per-node 4 \\
        -m distributed_pytorch_training_tpu_torch.train --model gpt2_124m \\
        --synthetic --mesh seq=2,model=2 --attention ring   # or ulysses

    torchrun --standalone --nproc-per-node 2 \\
        -m distributed_pytorch_training_tpu_torch.train --model gpt2_moe \\
        --synthetic --mesh data=1,expert=2 [--amp]

Same flags, stdout lines and ``metrics_rank0.csv`` (rank 0) as the JAX
entry. Under torchrun every rank trains its shard of each global batch of
``--batch-size x`` (the batch axes' ranks) rows, ResNet and GPT-2 alike;
``--mesh`` lays the ranks out on the mesh's axes (``parallel/mesh.py``;
``--slices`` folds into ``slice``). On an ``fsdp`` axis the batch is
split over (data, fsdp) jointly and every leaf the model's rules place
on ``fsdp`` is held as its 1/F slice, gathered on use (GSPMD's d_model
sharding; with ``model`` too, each TP slice cut again; a ResNet, whose
rules never use the axis, runs it as data parallelism, with JAX's
warning). ``--zero1`` on a ``model`` mesh shards each TP-local leaf's
update over the batch ranks (JAX's per-leaf GSPMD update, fp32 wire
only); ``seq`` and ``model`` compose (ring and Ulysses on each model
rank's heads), and ``gpt2_moe`` trains on ``model`` (the experts whole
on every model rank) and on ``seq`` (each MoE layer routing whole rows).
On a ``seq`` axis GPT-2 trains sequence-parallel under ``--attention
ring`` or ``ulysses``: the ranks of a seq line hold the same rows and
each runs its share of the positions (``models/gpt2.py``), on the
implicit path. On a ``model`` axis GPT-2, BERT-base and ViT-B/16 train
tensor-parallel (megatron column/row-split blocks; the LMs' vocab-parallel
embedding and cross-entropy, the vocab padded to lcm(128, M); BERT's
heads under ``--attention flash`` run K3-K5 bidirectional, ViT's the
einsum): the ranks of a model
line hold the same rows, on the implicit path or, under
``--fsdp-explicit``, the sharded update over the data ranks of each
shard's slice (TP x FSDP; GPT-2 only, as in the JAX Trainer). On a ``pipe`` axis GPT-2 trains as a GPipe
pipeline (``models/gpt2_pipe.py``: the blocks stage-stacked, one stage a
rank, ``--microbatches`` a step, the einsum attention inside the
stages), and on an ``expert`` axis ``gpt2_moe`` holds E/ep experts of
every MoE layer a rank (``models/moe.py``; its router loss, weight 0.01,
joins the task's); the ranks of a pipe or expert line hold the same
rows, on the implicit path. With
the defaults (``--wire-dtype fp32 --bucket-cap-mb 0``) on the implicit path
(global-batch BatchNorm, one fp32 all-reduce of the gradient, as the JAX
package's data-sharded jit), otherwise through the explicit bucketed
reducer (``--bucket-cap-mb``, ``--wire-dtype fp32|bf16|int8|
int8_multihop|int8_hier``, per-rank BatchNorm), or through the sharded
update (``--zero1``, ``--fsdp-explicit``; per-rank BatchNorm).
``--slices S`` factors the ranks into S slices for ``int8_hier``.
``--amp`` computes in bf16 beside float32 parameters and optimizer state
(flax's ``dtype``, no loss scaling). ``--remat`` recomputes each
transformer block in the backward (flax's ``nn.remat``). BERT's sequences
default to 512 tokens, its attention is bidirectional (the flash kernels
with ``causal=False`` on CUDA), and its masks are jax.random's draws from
the JAX step key, bitwise. The process group's backend follows ``runtime/dist.py``'s rule
and is printed in the banner. Checkpoints (``--checkpoint-dir``,
``--resume``, ``--checkpoint-every``), the restart supervisor
(``--max-restarts``) and fault injection (``--chaos``) follow the JAX
entry; under torchrun a SIGTERM on any rank stops every rank at the next
``--print-freq`` boundary, with a checkpoint. Telemetry follows the JAX
entry too: rank 0 writes ``telemetry_rank0.jsonl`` into ``--output-dir``
unless ``--no-telemetry`` (every rank under ``--telemetry-all-ranks``),
an abnormal exit leaves a ``flight_*.json``, ``--metrics-port`` serves
``/metrics``, ``/healthz`` and ``POST /profile?steps=K``, and
``--profile-dir`` with ``--profile-steps a,b`` traces steps a..b-1 with
``torch.profiler`` (the card's kernels when on CUDA) into a
``device_profile`` event. Every flag value this port
does not implement raises ``NotImplementedError`` naming the slice that
brings it. ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU and is for tests;
without it the run needs a CUDA device. The initial weights are drawn from
a ``torch.Generator`` seeded by ``--seed``, the same on every rank (not
jax.random's numbers; ``convert.py`` carries weights between the
packages).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import math
import os
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from . import telemetry
from .data.datasets import IMAGE_STATS, get_dataset
from .data.loader import ShardedLoader
from .data.text import TokenLoader, get_token_dataset
from .models import GPT2PipeLMHead, get_model
from .ops.flash_attention import (
    flash_backend_supported,
    flash_supports_length,
    make_flash_attention_fn,
)
from .ops.ring_attention import make_ring_attention_fn
from .ops.ulysses_attention import make_ulysses_attention_fn
from .experiments import flops as flops_mod
from .parallel.grad_sync import check_wire, emit_wire_accounting
from .parallel.mesh import (BATCH_AXES, EXPERT, MODEL, PIPE, SEQ,
                            MeshSpec, batch_shard_count, build_mesh,
                            validate_mesh_usage)
from .resilience.faults import ELASTIC_KINDS, FaultInjector, FaultPlan
from .resilience.supervisor import RetryPolicy, Supervisor
from .runtime import (
    barrier,
    cleanup_distributed,
    not_ported,
    resolve_device,
    set_seed,
    setup_distributed,
)
from .training import TrainConfig, Trainer, TrainState, make_optimizer, \
    make_schedule
from .training.checkpoint import LAYOUT_HINT, CheckpointManager, \
    CheckpointWorldSizeMismatch
from .training.loop import EXPERT_TP, FSDP_LATER
from .training.preemption import PreemptionGuard, RankAgreedStop
from .training.tasks import (ImageClassificationTask, LanguageModelingTask,
                             MaskedLMTask, MoeLanguageModelingTask)
from .telemetry import device as tele_device
from .telemetry.watchdog import kwargs_from_env
from .utils import MetricsCSV, log_main, parse_args
from .utils.config import parse_model_overrides
from .utils.profiling import StepProfiler

LM_MODELS = ("gpt2_124m", "gpt2_355m", "gpt2_moe", "bert_base")
IMAGE_MODELS = ("resnet18", "resnet50", "vit_b16")
ELASTIC = "the elastic slice"

# flag -> (is the value unsupported?, the slice that brings it)
_UNPORTED = {
    "--autopilot": (lambda a: a.autopilot or a.autopilot_tune,
                    "the autopilot slice"),
    "--download": (lambda a: a.download,
                   "no slice: the port fetches nothing; put the CIFAR-10 "
                   "python pickles under --data-dir"),
}

TP_MODELS = ("gpt2_124m", "gpt2_355m", "bert_base", "vit_b16")


def mesh_spec(args: argparse.Namespace) -> MeshSpec:
    """``--mesh`` with ``--slices`` folded into its slice axis (the JAX
    entry's rule and message)."""
    spec = MeshSpec.parse(args.mesh)
    if args.slices > 1:
        if spec.slice not in (1, args.slices):
            raise ValueError(
                f"--slices {args.slices} conflicts with --mesh "
                f"{args.mesh!r} (slice={spec.slice}); set the slice "
                "factor in one place")
        spec = dataclasses.replace(spec, slice=args.slices)
    return spec


def refuse_unported(args: argparse.Namespace, spec: MeshSpec) -> None:
    """Raise ``NotImplementedError`` for the first flag value this port
    does not implement (``spec``: the run's `mesh_spec`)."""
    if args.model not in LM_MODELS + IMAGE_MODELS:
        raise not_ported(f"--model {args.model}", "a later slice")
    if spec.fsdp != 1:
        for axis in (SEQ, PIPE, EXPERT):
            if getattr(spec, axis) != 1:
                raise not_ported(f"--mesh {args.mesh} (fsdp and {axis} "
                                 "axes together)", FSDP_LATER)
    if spec.model != 1 and spec.expert != 1:
        raise not_ported(f"--mesh {args.mesh} (expert and model axes "
                         "together)", EXPERT_TP)
    for flag, (unsupported, where) in _UNPORTED.items():
        if unsupported(args):
            raise not_ported(flag, where)
    check_wire(args.wire_dtype)
    for fault in FaultPlan.parse(args.chaos).faults:
        if fault.kind in ELASTIC_KINDS:
            raise not_ported(f"--chaos {fault.kind}", ELASTIC)


def check_flags(args: argparse.Namespace, spec: MeshSpec,
                world: int = 1) -> None:
    """The JAX entry's checks of the checkpoint flags and of ``--slices``
    (the mesh's slice axis over the ranks), same messages (``spec``: the
    run's `mesh_spec`)."""
    if args.slices < 1:
        raise ValueError(f"axis sizes must be >= 1 (or -1 for 'all "
                         f"remaining'), got {{'slice': {args.slices}}}")
    if world % args.slices:
        raise ValueError(f"{world} devices not divisible by fixed axes "
                         f"product {args.slices}")
    if args.resume and not args.checkpoint_dir:
        raise ValueError("--resume requires --checkpoint-dir")
    if args.max_restarts > 0 and not args.checkpoint_dir:
        raise ValueError("--max-restarts requires --checkpoint-dir (the "
                         "supervisor restarts FROM checkpoints)")
    if args.max_restarts < 0:
        raise ValueError(f"--max-restarts must be >= 0, got "
                         f"{args.max_restarts}")
    if args.remat and args.model.startswith("resnet"):
        raise ValueError("--remat applies to transformer models "
                         "(vit/bert/gpt2); ResNets are activation-light")
    if args.model.startswith("bert") and args.attention in ("ring",
                                                            "ulysses"):
        raise ValueError("--attention ring/ulysses is causal-only; "
                         "bert_base uses the XLA or flash path")
    if (spec.pipe != 1
            and args.model.startswith("gpt2")
            and args.attention not in ("auto", "xla")):
        raise ValueError("--mesh pipe>1 uses the XLA attention path "
                         "inside pipeline stages; drop --attention")


def resolve_attention(requested: str, device_type: str,
                      seq_len: int, n_pipe: int = 1) -> str:
    """``auto`` is the flash kernels on CUDA and the einsum on the CPU
    and inside pipeline stages (``n_pipe`` > 1: attention is a per-stage
    concern, as in the JAX entry); every other choice (``ring`` and
    ``ulysses`` run the flash kernels on CUDA and their plain versions on
    the CPU) stands."""
    if requested != "auto":
        return requested
    return ("flash" if flash_backend_supported(device_type)
            and n_pipe == 1 and flash_supports_length(seq_len) else "xla")


def samples_per_step_list(n: int, global_batch: int, steps: int,
                          drop_last: bool) -> List[int]:
    """Host-known global sample count per step (the throughput meter)."""
    counts = [global_batch] * steps
    if not drop_last and steps and n % global_batch:
        counts[-1] = n % global_batch
    return counts


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """Train as the command line says; returns the final state."""
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    spec = mesh_spec(args)      # --mesh parses and agrees with --slices
    check_flags(args, spec, world)
    refuse_unported(args, spec)
    spec.resolved(world)        # the JAX mesh's size checks
    # the guard first: a SIGTERM during data loading or the kernels' build
    # also stops gracefully
    guard = PreemptionGuard.install()
    try:
        return _run(args, spec, guard)
    except BaseException as e:
        # the flight recorder's exit path: any abnormal exit (an unhandled
        # exception, a sys.exit with a code) leaves flight_<ts>.json with
        # the last events and the cause, written here, before the finally
        # below tears telemetry down. A clean SystemExit(0) is not abnormal
        if not (isinstance(e, SystemExit) and e.code in (0, None)):
            telemetry.flush_flight(
                cause=f"{type(e).__name__}: {e}",
                detail="train.py abnormal exit",
                rc=e.code if isinstance(e, SystemExit) else 1)
        raise
    finally:
        # the hard-exit deadline must not outlive this call (an embedder
        # that catches a failure would be killed up to the grace later)
        guard.disarm()
        # the endpoint down before the stream closes; a run without
        # --metrics-port never imported metrics_http
        if f"{telemetry.__name__}.metrics_http" in sys.modules:
            telemetry.stop_metrics_server()
        telemetry.reset()  # close the JSONL (fsync) and drop the global


def _log_save_blocked(ckpt: CheckpointManager) -> None:
    """How long the loop stalled on checkpoints, and what rank 0 wrote."""
    if not ckpt.saves_started:
        return
    log_main(f"Checkpointing: blocked {ckpt.save_blocked_ms:.1f}ms total "
             f"(snapshot {ckpt.snapshot_ms:.1f}ms) across "
             f"{ckpt.saves_started} save(s); wrote {ckpt.bytes_written} "
             f"bytes, sha256 {ckpt.hash_ms:.1f}ms on the writer")


def _run(args: argparse.Namespace, spec: MeshSpec,
         guard: PreemptionGuard) -> TrainState:
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # float32 means float32: cuDNN convolutions default to TF32 (under
        # --amp the products are bf16 by the model's casts, not by TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    # fault injection, armed only under --chaos (every hook is None
    # otherwise)
    chaos = None
    if args.chaos:
        chaos = FaultInjector(FaultPlan.parse(args.chaos), log=log_main)
        log_main(f"CHAOS: fault plan armed: {args.chaos}")
    ctx = setup_distributed(dev)
    dev = ctx.device
    # the run's event stream: rank 0 always (telemetry_rank0.jsonl), the
    # other ranks only under --telemetry-all-ranks / DPT_TELEMETRY_ALL_RANKS
    tele_rank = telemetry.rank_identity(ctx.process_index)
    if not args.no_telemetry and telemetry.should_stream(
            tele_rank, args.telemetry_all_ranks):
        telemetry.configure(
            str(Path(args.output_dir) / telemetry.stream_filename(tele_rank)),
            rank=tele_rank, gen=telemetry.generation_identity(),
            meta={"entry": "train.py", "model": args.model,
                  "mesh": args.mesh, "chaos": args.chaos or ""})
    # the live endpoint: a background HTTP thread serving /metrics and
    # /healthz, fed by an observer on the recorder; off starts no thread
    metrics_port = telemetry.resolve_metrics_port(args.metrics_port,
                                                  tele_rank)
    if metrics_port and telemetry.is_configured():
        # a bind failure returns None (noted on stderr): the live surface
        # must never take the training run down
        if telemetry.start_metrics_server(metrics_port, telemetry.get(),
                                          backend=dev.type) is not None:
            log_main(f"Telemetry: serving /metrics + /healthz on "
                     f":{metrics_port}")
    set_seed(args.seed, ctx.process_index)
    n = ctx.process_count
    # the ranks on the mesh's axes (row-major, slice outermost); the batch
    # is sharded over the batch axes, the sequence over seq
    mesh = build_mesh(spec, n, ctx.process_index)
    n_batch = batch_shard_count(mesh)
    global_batch = args.batch_size * n_batch
    log_main(f"Using device: {dev} (mesh {mesh.active()}), "
             f"world_size={n}, amp={args.amp}"
             + (f", backend={ctx.backend}" if ctx.backend else ""))
    telemetry.gauge("world_size", n)

    compute_dtype = torch.bfloat16 if args.amp else torch.float32
    is_lm = args.model in LM_MODELS
    family = "bert" if args.model.startswith("bert") else "gpt2"
    seq_len = args.seq_len or (512 if family == "bert" else 1024)
    attention = (resolve_attention(args.attention, dev.type, seq_len,
                                   mesh.shape[PIPE]) if is_lm else "xla")
    # GPipe over the pipe axis: GPT-2's dense models (the JAX entry's
    # rule); gpt2_moe and BERT there are refused below
    pipelined = (mesh.shape[PIPE] > 1 and family == "gpt2"
                 and "moe" not in args.model)
    # refuse axes the model and attention would not use (the JAX entry's
    # check and message)
    model_n = mesh.shape[MODEL]
    rules = (GPT2PipeLMHead.partition_rules() if pipelined
             else get_model(args.model, device="meta").partition_rules()
             if args.model in TP_MODELS + ("gpt2_moe",) else None)
    validate_mesh_usage(mesh, rules=rules, attention=attention,
                        is_moe="moe" in args.model, pipelined=pipelined)
    if mesh.shape[SEQ] > 1:
        log_main(f"Sequence parallel: {attention} attention over "
                 f"seq={mesh.shape[SEQ]}, {seq_len // mesh.shape[SEQ]} "
                 "positions a rank")
    if is_lm:
        def load_datasets():
            return (get_token_dataset(family, seq_len, args.data_dir,
                                      train=True,
                                      synthetic_size=args.synthetic_size,
                                      seed=args.seed),
                    get_token_dataset(family, seq_len, args.data_dir,
                                      train=False,
                                      synthetic_size=(args.synthetic_size
                                                      or 0) // 5 or None,
                                      seed=args.seed))
    else:
        def load_datasets():
            train_ds = get_dataset(args.dataset, args.data_dir, train=True,
                                   synthetic=args.synthetic,
                                   synthetic_size=args.synthetic_size,
                                   seed=args.seed)
            val_ds = get_dataset(args.dataset, args.data_dir, train=False,
                                 synthetic=args.synthetic
                                 or train_ds.synthetic,
                                 synthetic_size=(args.synthetic_size or 0)
                                 // 5 or None, seed=args.seed)
            return train_ds, val_ds

    # rank 0 reads first (it may extract an archive), the others after it
    if ctx.is_main:
        train_ds, val_ds = load_datasets()
        barrier("data_ready")
    else:
        barrier("data_ready")
        train_ds, val_ds = load_datasets()
    if train_ds.synthetic:
        log_main(f"NOTE: using synthetic data ({train_ds.name}, "
                 f"n={len(train_ds)})")

    overrides = parse_model_overrides(args.model_overrides)
    # a rank's rows are those of its batch coordinate: the ranks of a seq
    # line hold the same rows
    loader_kw = dict(process_index=mesh.batch_index, process_count=n_batch,
                     device=dev)
    stall = chaos.on_loader_batch if chaos else None
    if is_lm:
        make_model, task = _lm_model_and_task(
            args, family, overrides, seq_len, train_ds, val_ds,
            compute_dtype, mesh, attention, pipelined)

        def make_flops_model():
            # the global model with the padded head (not one rank's
            # TP-local share), the plain attention: FlopCounterMode does
            # not see the flash kernels' ctypes calls. Pipelined, the
            # sequential GPT-2 of the same configuration
            # (experiments/flops.py says what JAX's count holds)
            pad = ({"pad_vocab_to_multiple_of": math.lcm(128, model_n)}
                   if model_n > 1 else {})
            return get_model(args.model, device="meta", dtype=compute_dtype,
                             **{**pad, **overrides})

        flops_input = torch.zeros((1, seq_len), dtype=torch.long,
                                  device="meta")
        train_loader = TokenLoader(train_ds, args.batch_size, shuffle=True,
                                   seed=args.seed, drop_last=args.drop_last,
                                   fault_hook=stall, **loader_kw)
        val_loader = TokenLoader(val_ds, args.batch_size, shuffle=False,
                                 seed=args.seed, **loader_kw)
    else:
        train_loader = ShardedLoader(train_ds, args.batch_size, shuffle=True,
                                     seed=args.seed, drop_last=args.drop_last,
                                     fault_hook=stall, **loader_kw)
        val_loader = ShardedLoader(val_ds, args.batch_size, shuffle=False,
                                   seed=args.seed, **loader_kw)
        model_kwargs = dict(num_classes=train_ds.num_classes,
                            dtype=compute_dtype)
        if args.model.startswith("vit"):
            # flax sizes the position embeddings from the first input
            model_kwargs.update(image_size=train_ds.images.shape[1:3],
                                remat=args.remat)
        model_kwargs.update(overrides)
        if args.model.startswith("resnet"):
            # an explicit --model-overrides wins over the dedicated flag
            model_kwargs.setdefault("cifar_stem", args.cifar_stem)

        def make_model():
            return get_model(args.model, **model_kwargs)

        def make_flops_model():
            with torch.device("meta"):
                return make_model()

        flops_input = torch.zeros((1, *train_ds.images.shape[1:]),
                                  device="meta")
        mean, std = IMAGE_STATS[args.dataset.lower()]
        task = ImageClassificationTask(mean=mean, std=std,
                                       augment=not args.no_augment,
                                       compute_dtype=compute_dtype)

    steps_per_epoch = len(train_loader)
    schedule = make_schedule(args.schedule, args.lr,
                             total_steps=steps_per_epoch * args.epochs,
                             warmup_steps=args.warmup_steps)
    tx = make_optimizer(args.optimizer, schedule, momentum=args.momentum,
                        weight_decay=args.weight_decay)
    trainer = Trainer(task, TrainConfig(
        per_device_batch=args.batch_size, print_freq=args.print_freq,
        seed=args.seed, bf16=args.amp, grad_accum=args.grad_accum,
        bucket_cap_mb=args.bucket_cap_mb, wire_dtype=args.wire_dtype,
        zero1=args.zero1, fsdp_explicit=args.fsdp_explicit,
        slices=args.slices, slice_axis=args.slice_axis,
        overlap_grad_sync=not args.no_overlap_grad_sync,
        fused_quantize={"auto": None, "on": True, "off": False}[
            args.fused_quantize]), device=dev, mesh=mesh, rules=rules)
    wire_note = (f"; {args.wire_dtype} wire" if args.wire_dtype != "fp32"
                 else "")
    n_data = trainer.n_shards
    if trainer._fsdp and model_n > 1:
        log_main(f"TP x FSDP (explicit): megatron tensor parallelism over "
                 f"model={model_n} (one all-reduce per residual join); "
                 f"params + moments flat-sharded 1/{n_data * model_n} at "
                 "rest for TP-split tensors; per-layer gathers/scatters "
                 f"ride the data axes over each shard's 1/{model_n} slice"
                 + wire_note)
    elif trainer._zero1_tp:
        log_main(f"ZeRO-1: weight update sharded {n_data}-way over the "
                 "batch axes (per-leaf GSPMD update — model-axis mesh)")
    elif model_n > 1:
        log_main(f"Tensor parallel: megatron column/row-split blocks over "
                 f"model={model_n} (one all-reduce per residual join); "
                 f"the gradient summed over {n_data} data shard(s)")
    elif trainer._fsdp:
        log_main(f"FSDP (explicit): params + moments flat-sharded "
                 f"{n}-way at rest; per-layer just-in-time param gathers, "
                 "gradients reduce-scattered into the shard layout"
                 + wire_note)
    elif trainer._zero1:
        log_main(f"ZeRO-1: weight update sharded {n}-way over the batch "
                 "axes (reduce-scatter grads -> 1/N optimizer update -> "
                 "all-gather params"
                 + (f"; {args.wire_dtype} gradient wire"
                    if args.wire_dtype != "fp32" else "") + ")")
    elif trainer._grad_sync:
        log_main(f"Gradient sync: explicit bucketed reducer over "
                 f"{n} shards — bucket_cap_mb="
                 f"{args.bucket_cap_mb or 'inf (one bucket)'}, "
                 f"wire={args.wire_dtype}, overlap="
                 f"{'off' if args.no_overlap_grad_sync else 'on'}")
    if trainer._hier is not None:
        h = trainer._hier
        log_main(f"Two-tier wire (int8_hier): {h.n_slices} slices x "
                 f"{h.n_inner} replicas/slice — exact fp32 reduce-scatter "
                 f"inside the slice, s8+EF exchange across "
                 f"{h.slice_axis!r} (~2 B/element per slice on the slow "
                 "tier, slice-count independent)")
    if not args.no_telemetry:
        # the anomaly watchdog, fed by train_epoch's host timings and the
        # print-boundary losses; its abort hook only under
        # --telemetry-abort (under --max-restarts an abort is a
        # restartable failure). DPT_WATCHDOG_* override its knobs
        trainer.watchdog = telemetry.AnomalyWatchdog(
            abort=args.telemetry_abort, **kwargs_from_env())

    def state_factory() -> TrainState:
        """A fresh initial state: the weights drawn on the CPU, so one
        seed gives the same weights on every rank."""
        model = make_model()
        model.reset_parameters(torch.Generator().manual_seed(args.seed))
        return trainer.init_state(model, tx)

    state = state_factory()
    log_main(f"Model {args.model}: {state.param_count():,} params")
    if trainer._grad_sync:
        plan = trainer._plan
        log_main(f"Gradient sync: {plan.n_buckets} bucket(s) over "
                 f"{plan.total_bytes / 2 ** 20:.1f} MB of fp32 gradient")
    if trainer._fsdp:
        lp = trainer._layers
        mb = lp.total_padded * 4 / 2 ** 20
        log_main(f"FSDP plan: {len(lp.groups)} layer gather group(s), "
                 f"{mb:.1f} MB padded fp32 params "
                 + ("(this model shard's slices) " if model_n > 1 else "")
                 + f"({mb / n_data:.1f} MB/replica at rest)")
    if telemetry.is_configured() and n > 1 and not args.zero1:
        # the setup-time wire accounting rows `telemetry summary` reports
        # (ZeRO-1's split wire is outside their conventions, as in the
        # JAX entry); the model axis's bytes in their own row
        emit_wire_accounting(*trainer.wire_accounting_inputs(
            state, dict(wire_dtype=args.wire_dtype,
                        bucket_cap_mb=args.bucket_cap_mb,
                        fsdp_explicit=args.fsdp_explicit),
            seq_len if is_lm else 0), n_data)
    # MFU on the step line (a card with a known peak only): 3 x the
    # forward's matmul and convolution FLOPs of one sample
    peak = flops_mod.chip_peak_tflops(dev)
    if peak:
        try:
            fwd = flops_mod.matmul_flops(make_flops_model(), flops_input)
            trainer.set_mfu_reference(3.0 * fwd, peak * 1e12 * n)
        except Exception as e:  # MFU is a log nicety, never a crash
            log_main(f"NOTE: MFU logging disabled ({e})")

    # step-granular checkpoints: labels are epoch * steps_per_epoch + step,
    # so a mid-epoch save sorts between the epoch boundaries
    ckpt = None
    start_epoch = start_step = 0
    if args.checkpoint_dir:
        ckpt = CheckpointManager(
            args.checkpoint_dir, mesh=mesh.shape,
            post_save_hook=chaos.on_save if chaos else None,
            pre_finalize_hook=chaos.on_save_finalize if chaos else None)
        if args.resume:
            try:
                restored = ckpt.restore_latest(state, template_world_size=n)
            except CheckpointWorldSizeMismatch as e:
                raise not_ported(
                    f"--resume of checkpoint {e.label} (written at world "
                    f"size {e.world_size}) at world size {n}",
                    ELASTIC) from e
            except Exception as e:
                # the JAX entry's diagnosis: the layout follows --zero1
                # and --fsdp-explicit
                raise RuntimeError(f"checkpoint restore failed — "
                                   f"{LAYOUT_HINT}: {e}") from e
            if restored is not None:
                state, start_epoch, start_step = restored
                if start_step >= steps_per_epoch:  # stale steps_per_epoch
                    start_epoch, start_step = start_epoch + 1, 0
                log_main(f"Resumed from epoch {start_epoch}"
                         + (f" step {start_step}" if start_step else ""))

    csv = MetricsCSV(args.output_dir)
    # the stop flag agreed over the ranks, polled every print_freq steps
    # on several ranks (a collective) and every step on one
    stop = RankAgreedStop(guard)
    poll = 1 if n == 1 else args.print_freq

    def epoch_end(epoch, st, train_loss, train_acc, epoch_time):
        val_loss, val_acc = trainer.evaluate(st, val_loader.epoch(0))
        log_main(
            f"[Epoch {epoch + 1}/{args.epochs}] "
            f"Train: loss={train_loss:.4f}, acc={train_acc:.2f}% | "
            f"Val: loss={val_loss:.4f}, acc={val_acc:.2f}% | "
            f"Epoch time: {epoch_time:.2f}s"
        )
        csv.append(epoch, train_loss, train_acc, val_loss, val_acc,
                   epoch_time)

    if args.max_restarts > 0:
        # the restart supervisor: a checkpoint every epoch; on a step or
        # save failure it restores the newest valid checkpoint and
        # replays behind the step fence. It owns the save cadence
        # (--checkpoint-every and --profile-dir do not apply); a
        # preemption drains as in the plain loop
        if args.profile_dir:
            log_main("NOTE: --profile-dir is ignored under --max-restarts")
        sup = Supervisor(trainer, ckpt, state_factory, train_loader,
                         retry=RetryPolicy(max_restarts=args.max_restarts),
                         guard=stop, injector=chaos,
                         trust_existing=args.resume, epoch_end_cb=epoch_end,
                         stop_poll_every=poll)
        state, report = sup.run(args.epochs,
                                initial=(state, start_epoch, start_step))
        log_main(f"Supervisor: completed={report.completed} "
                 f"restarts={report.restarts} "
                 f"steps_replayed={report.steps_replayed} "
                 f"torn_checkpoints_skipped={report.checkpoints_skipped}"
                 + (f" faults_fired={report.faults_fired}"
                    if report.faults_fired else ""))
        ckpt.wait()
        _log_save_blocked(ckpt)
        ckpt.close()
        cleanup_distributed()
        return state

    def stop_fn():
        count = [0]

        def poll_stop() -> bool:
            count[0] += 1
            return count[0] % poll == 0 and stop.should_stop

        return poll_stop

    # the device-time plane: a StepProfiler exists whenever --profile-dir
    # names a static window or the live /metrics surface is up (captures
    # then land under <output-dir>/profiles). Armed three ways: the static
    # --profile-steps window, POST /profile?steps=K, and the watchdog's
    # anomaly capture hook. Every closed window becomes a device_profile
    # event (telemetry/device.py). With both off no profiler exists and
    # the loop's step_hook stays None
    profiler = None
    profile_base = args.profile_dir
    if profile_base is None and metrics_port and telemetry.is_configured():
        profile_base = str(Path(args.output_dir) / "profiles")
    if profile_base is not None:
        first = last = None
        if args.profile_dir:
            first, last = (int(x) for x in args.profile_steps.split(","))

        def _mfu_ref():
            # read lazily, as the JAX entry does: the reference exists only
            # on a card with a known peak
            if trainer._flops_per_sample and trainer._peak_flops_total:
                return (trainer._flops_per_sample * global_batch,
                        trainer._peak_flops_total)
            return None

        profiler = StepProfiler(
            profile_base, first, last,
            on_capture=tele_device.make_ingestor(mfu_ref=_mfu_ref),
            device=dev)
        server = (telemetry.get_metrics_server()
                  if metrics_port and telemetry.is_configured() else None)
        if server is not None:
            server.profile_handler = profiler.request_capture
        if trainer.watchdog is not None:
            trainer.watchdog.capture_hook = (
                lambda name, step: profiler.request_capture(
                    2, reason=f"anomaly:{name}", trigger_step=step))
        log_main(f"Profiler: on-demand capture armed (traces under "
                 f"{profile_base}"
                 + (f"; static window steps {first}-{last}"
                    if first is not None else "") + ")")

    # context-managed: an exception mid-epoch must still stop an open
    # profiler session (a leaked one fails every later capture)
    with profiler if profiler is not None else contextlib.nullcontext():
        for epoch in range(start_epoch, args.epochs):
            counts = samples_per_step_list(len(train_ds), global_batch,
                                           steps_per_epoch, args.drop_last)
            fault_hook = None
            if chaos is not None:
                # the absolute global step's fence for crash and sigterm
                base = epoch * steps_per_epoch + start_step
                fault_hook = (lambda i, _base=base: chaos.on_step(_base + i))
            state, train_loss, train_acc, epoch_time, steps_done = \
                trainer.train_epoch(
                    state, train_loader.epoch(epoch, start_step=start_step),
                    epoch, steps_per_epoch,
                    samples_per_step=counts[start_step:], step_hook=profiler,
                    start_step=start_step, stop_fn=stop_fn(),
                    fault_hook=fault_hook)
            abs_step = start_step + steps_done
            start_step = 0

            if abs_step < steps_per_epoch:
                # only the agreed stop ends an epoch early: persist (epoch,
                # step) now, so a resume replays nothing; no CSV row for the
                # unfinished epoch
                telemetry.flush_flight(
                    cause=f"preemption (sigterm) drained at epoch {epoch} "
                          f"step {abs_step}", rc=0)
                if ckpt:
                    ckpt.save(epoch * steps_per_epoch + abs_step, state,
                              wait=True, epoch=epoch, step_in_epoch=abs_step,
                              world_size=n)
                    log_main(f"Preempted: checkpointed epoch {epoch} step "
                             f"{abs_step}/{steps_per_epoch}; relaunch with "
                             "--resume to continue mid-epoch")
                else:
                    log_main("Preempted: stopping (no --checkpoint-dir, "
                             "nothing persisted beyond the metrics CSV)")
                break

            epoch_end(epoch, state, train_loss, train_acc, epoch_time)
            if ckpt and (epoch + 1) % args.checkpoint_every == 0:
                ckpt.save((epoch + 1) * steps_per_epoch, state,
                          epoch=epoch + 1, world_size=n)
            if stop.should_stop:
                telemetry.flush_flight(
                    cause=f"preemption (sigterm) drained at epoch boundary "
                          f"{epoch + 1}", rc=0)
                if ckpt:
                    if (epoch + 1) % args.checkpoint_every != 0:
                        ckpt.save((epoch + 1) * steps_per_epoch, state,
                                  epoch=epoch + 1, world_size=n)
                    ckpt.wait()
                    log_main(f"Preempted: checkpointed epoch {epoch + 1}; "
                             "relaunch with --resume to continue")
                else:
                    log_main("Preempted: stopping (no --checkpoint-dir, "
                             "nothing persisted beyond the metrics CSV)")
                break

    if ckpt:
        ckpt.wait()  # finish the async write before exit
        _log_save_blocked(ckpt)
        ckpt.close()
    cleanup_distributed()
    return state


def _lm_model_and_task(args, family, overrides, seq_len, train_ds,
                       val_ds, compute_dtype, mesh, attention,
                       pipelined=False):
    """A factory of the GPT-2, MoE GPT-2 or BERT model (the flash kernels
    on CUDA: causal for GPT-2, bidirectional for BERT; GPT-2's ring or
    Ulysses over the mesh's seq line; the pipelined GPT-2 over the pipe
    axis when ``pipelined``), checked once against the data's token ids,
    and its task (causal LM over this rank's sequence shard, with the
    router loss for an MoE model, or masked LM over the ids both the
    model and the data hold), computing in ``compute_dtype``. The checks
    and their messages are the JAX entry's."""
    lm_kwargs = dict(dtype=compute_dtype, remat=args.remat)
    if mesh.shape[MODEL] > 1:
        # Megatron's vocab padding (the JAX entry's): lcm(128, M) keeps the
        # padded vocab aligned and divisible by the model degree, so the
        # embedding splits instead of staying replicated
        lm_kwargs["pad_vocab_to_multiple_of"] = math.lcm(
            128, mesh.shape[MODEL])
    if "moe" in args.model:
        # the MoE layers gather a whole row over seq and average the
        # routing statistics over the batch line
        lm_kwargs.update(seq=mesh.axis_shard(SEQ),
                         batch=mesh.line_shard(BATCH_AXES))
    lm_kwargs.update(overrides)
    if attention == "flash":
        # BERT is bidirectional: legal because the masked LM task feeds no
        # padding mask (the kernel owns the attention's structure)
        lm_kwargs["attention_fn"] = make_flash_attention_fn(
            causal=family != "bert")
    elif attention == "ring":
        lm_kwargs["attention_fn"] = make_ring_attention_fn(mesh, causal=True)
    elif attention == "ulysses":
        lm_kwargs["attention_fn"] = make_ulysses_attention_fn(mesh,
                                                              causal=True)
    if pipelined:
        # GPipe: the blocks stage-stacked over the pipe axis, the config
        # of the named size (and the overrides) carried over, as the JAX
        # entry builds GPT2PipeLMHead (check_flags refused a kernel
        # attention, and auto is the einsum here)
        cfg = get_model(args.model, device="meta", **overrides)
        pipe_kwargs = dict(
            num_stages=mesh.shape[PIPE], num_microbatches=args.microbatches,
            vocab_size=cfg.vocab_size, hidden_dim=cfg.hidden_dim,
            depth=cfg.depth, num_heads=cfg.num_heads,
            max_position=max(cfg.max_position, seq_len),
            dtype=compute_dtype, remat=args.remat)
        # overrides of pipe-model fields beyond the list above (e.g.
        # layernorm_epsilon) are not dropped
        fields = inspect.signature(GPT2PipeLMHead).parameters
        pipe_kwargs.update({k: v for k, v in overrides.items()
                            if k in fields and k not in pipe_kwargs})
        lm_kwargs = pipe_kwargs
    vocab_size = (cfg.vocab_size if pipelined else
                  get_model(args.model, device="meta", **lm_kwargs).vocab_size)
    if vocab_size < train_ds.vocab_size:
        # ids past the embedding would index out of range: scan the ids
        # actually present (a byte corpus under the gpt2 stamp is fine)
        for split_ds, split in ((train_ds, "train"), (val_ds, "val")):
            max_id = int(split_ds.tokens.max()) if len(split_ds) else -1
            if max_id >= vocab_size:
                raise ValueError(
                    f"{split} dataset {split_ds.name} contains token id "
                    f"{max_id}, which exceeds the model's vocab_size "
                    f"({vocab_size}): such ids index past the "
                    "embedding, which JAX fills with NaN. Align "
                    "--model-overrides vocab_size with the data (byte "
                    f"corpora: 256; full {family} tokens: "
                    f"{train_ds.vocab_size}).")
    if family == "bert":
        # the recipe inserts [MASK] and draws replacement ids: both must
        # stay inside the (possibly shrunk) embedding
        bert_vocab = min(vocab_size, train_ds.vocab_size)
        task = MaskedLMTask(vocab_size=bert_vocab,
                            compute_dtype=compute_dtype)
        if task.mask_token_id >= bert_vocab:
            raise ValueError(
                f"vocab_size {bert_vocab} does not contain the [MASK] "
                f"token id {task.mask_token_id}; use a vocab of at "
                f"least {task.mask_token_id + 1}")
    elif "moe" in args.model:
        # MoE models add the Switch router load-balancing loss
        task = MoeLanguageModelingTask(compute_dtype=compute_dtype,
                                       seq_index=mesh.coords()[SEQ],
                                       seq_shards=mesh.shape[SEQ])
    else:
        task = LanguageModelingTask(compute_dtype=compute_dtype,
                                    seq_index=mesh.coords()[SEQ],
                                    seq_shards=mesh.shape[SEQ])
    if pipelined:
        return lambda: GPT2PipeLMHead(**lm_kwargs), task
    return lambda: get_model(args.model, **lm_kwargs), task


if __name__ == "__main__":
    main()
