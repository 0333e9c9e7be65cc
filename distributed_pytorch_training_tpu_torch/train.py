"""Training entry point of the PyTorch port: the causal-LM path (GPT-2) and
the image-classification path (ResNet) of the JAX package's ``train.py``.

    python -m distributed_pytorch_training_tpu_torch.train --model resnet18 \\
        --synthetic --batch-size 128 --epochs 2

    torchrun --standalone --nproc-per-node 2 \\
        -m distributed_pytorch_training_tpu_torch.train --model resnet18 \\
        --synthetic [--amp]

    torchrun --standalone --nproc-per-node 2 \\
        -m distributed_pytorch_training_tpu_torch.train --model resnet18 \\
        --synthetic --wire-dtype int8 --bucket-cap-mb 25

Same flags, stdout lines and ``metrics_rank0.csv`` (rank 0) as the JAX
entry. Under torchrun every rank trains its shard of each global batch of
``--batch-size x WORLD_SIZE`` rows, ResNet and GPT-2 alike: with the
defaults (``--wire-dtype fp32 --bucket-cap-mb 0``) on the implicit path
(global-batch BatchNorm, one fp32 all-reduce of the gradient, as the JAX
package's data-sharded jit), otherwise through the explicit bucketed
reducer (``--bucket-cap-mb``, ``--wire-dtype fp32|bf16|int8|
int8_multihop``, per-rank BatchNorm). ``--amp`` computes in bf16 beside
float32 parameters and optimizer state (flax's ``dtype``, no loss
scaling). The process group's backend follows ``runtime/dist.py``'s rule
and is printed in the banner. Every flag value this port does not
implement raises ``NotImplementedError`` naming the slice that brings
it. ``--device cpu``
runs the kernels' plain PyTorch versions on the CPU and is for tests;
without it the run needs a CUDA device. The initial weights are drawn from
a ``torch.Generator`` seeded by ``--seed``, the same on every rank (not
jax.random's numbers; ``convert.py`` carries weights between the
packages).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from .data.datasets import IMAGE_STATS, get_dataset
from .data.loader import ShardedLoader
from .data.text import TokenLoader, get_token_dataset
from .models import get_model
from .ops.flash_attention import (
    flash_backend_supported,
    flash_supports_length,
    make_flash_attention_fn,
)
from .parallel.grad_sync import refuse_unported_wire
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
from .training.tasks import ImageClassificationTask, LanguageModelingTask
from .utils import MetricsCSV, log_main, parse_args
from .utils.config import parse_model_overrides

LM_MODELS = ("gpt2_124m", "gpt2_355m")
IMAGE_MODELS = ("resnet18", "resnet50")
SHARDED_UPDATE = "the sharded-update (ZeRO-1/FSDP) slice"

# flag -> (is the value unsupported?, the slice that brings it)
_UNPORTED = {
    "--remat": (lambda a: a.remat, "the remat slice"),
    "--slices": (lambda a: a.slices > 1, "the multi-slice (--slices) slice"),
    "--zero1": (lambda a: a.zero1, SHARDED_UPDATE),
    "--fsdp-explicit": (lambda a: a.fsdp_explicit, SHARDED_UPDATE),
    "--checkpoint-dir": (lambda a: a.checkpoint_dir is not None,
                         "the checkpoint slice"),
    "--resume": (lambda a: a.resume, "the checkpoint slice"),
    "--max-restarts": (lambda a: a.max_restarts != 0, "the checkpoint slice"),
    "--chaos": (lambda a: a.chaos is not None, "the checkpoint slice"),
    "--profile-dir": (lambda a: a.profile_dir is not None,
                      "the telemetry slice"),
    "--metrics-port": (lambda a: a.metrics_port is not None,
                       "the telemetry slice"),
    "--telemetry-all-ranks": (lambda a: a.telemetry_all_ranks,
                              "the telemetry slice"),
    "--telemetry-abort": (lambda a: a.telemetry_abort,
                          "the telemetry slice"),
    "--autopilot": (lambda a: a.autopilot or a.autopilot_tune,
                    "the telemetry slice"),
    "--download": (lambda a: a.download,
                   "no slice: the port fetches nothing; put the CIFAR-10 "
                   "python pickles under --data-dir"),
    "--attention ring/ulysses": (lambda a: a.attention in ("ring",
                                                           "ulysses"),
                                 "the sequence-parallel slice"),
}


def _data_only_mesh(mesh: str, world: int) -> bool:
    """True for a mesh spec of one data axis over every rank ('data=-1'
    or 'data=<world>', other axes 1)."""
    for item in filter(None, (s.strip() for s in mesh.split(","))):
        axis, _, size = item.partition("=")
        try:
            n = int(size)
        except ValueError:
            return False
        if axis.strip() == "data":
            if n not in (-1, world):
                return False
        elif n != 1:
            return False
    return True


def refuse_unported(args: argparse.Namespace, world: int = 1) -> None:
    """Raise ``NotImplementedError`` for the first flag value this port
    does not implement."""
    if args.model not in LM_MODELS + IMAGE_MODELS:
        raise not_ported(f"--model {args.model}", "a later slice")
    if not _data_only_mesh(args.mesh, world):
        raise not_ported(f"--mesh {args.mesh}",
                         "the tensor-parallel and sequence-parallel slices "
                         "(the port's mesh is one data axis over the ranks)")
    for flag, (unsupported, where) in _UNPORTED.items():
        if unsupported(args):
            raise not_ported(flag, where)
    refuse_unported_wire(args.wire_dtype)


def resolve_attention(requested: str, device_type: str,
                      seq_len: int) -> str:
    """``auto`` is the flash kernels on CUDA and the einsum on the CPU."""
    if requested != "auto":
        return requested
    return ("flash" if flash_backend_supported(device_type)
            and flash_supports_length(seq_len) else "xla")


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
    refuse_unported(args, world)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # float32 means float32: cuDNN convolutions default to TF32 (under
        # --amp the products are bf16 by the model's casts, not by TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    ctx = setup_distributed(dev)
    dev = ctx.device
    set_seed(args.seed, ctx.process_index)
    n = ctx.process_count
    global_batch = args.batch_size * n
    log_main(f"Using device: {dev} (mesh {{'data': {n}}}), "
             f"world_size={n}, amp={args.amp}"
             + (f", backend={ctx.backend}" if ctx.backend else ""))
    if not args.no_telemetry:
        log_main("NOTE: the PyTorch port writes no telemetry stream yet "
                 "(it comes with the telemetry slice)")

    compute_dtype = torch.bfloat16 if args.amp else torch.float32
    is_lm = args.model in LM_MODELS
    seq_len = args.seq_len or 1024
    if is_lm:
        def load_datasets():
            return (get_token_dataset("gpt2", seq_len, args.data_dir,
                                      train=True,
                                      synthetic_size=args.synthetic_size,
                                      seed=args.seed),
                    get_token_dataset("gpt2", seq_len, args.data_dir,
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
    loader_kw = dict(process_index=ctx.process_index, process_count=n,
                     device=dev)
    if is_lm:
        model, task = _lm_model_and_task(args, overrides, dev, seq_len,
                                         train_ds, val_ds, compute_dtype)
        train_loader = TokenLoader(train_ds, args.batch_size, shuffle=True,
                                   seed=args.seed, drop_last=args.drop_last,
                                   **loader_kw)
        val_loader = TokenLoader(val_ds, args.batch_size, shuffle=False,
                                 seed=args.seed, **loader_kw)
    else:
        train_loader = ShardedLoader(train_ds, args.batch_size, shuffle=True,
                                     seed=args.seed, drop_last=args.drop_last,
                                     **loader_kw)
        val_loader = ShardedLoader(val_ds, args.batch_size, shuffle=False,
                                   seed=args.seed, **loader_kw)
        model_kwargs = dict(num_classes=train_ds.num_classes,
                            dtype=compute_dtype)
        model_kwargs.update(overrides)
        # an explicit --model-overrides wins over the dedicated flag
        model_kwargs.setdefault("cifar_stem", args.cifar_stem)
        model = get_model(args.model, **model_kwargs)
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
        overlap_grad_sync=not args.no_overlap_grad_sync,
        fused_quantize={"auto": None, "on": True, "off": False}[
            args.fused_quantize]), device=dev)
    if trainer._grad_sync:
        log_main(f"Gradient sync: explicit bucketed reducer over "
                 f"{n} shards — bucket_cap_mb="
                 f"{args.bucket_cap_mb or 'inf (one bucket)'}, "
                 f"wire={args.wire_dtype}, overlap="
                 f"{'off' if args.no_overlap_grad_sync else 'on'}")
    # drawn on the CPU, so one seed gives the same weights on every rank
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    state = trainer.init_state(model, tx)
    log_main(f"Model {args.model}: {state.param_count():,} params")
    if trainer._grad_sync:
        plan = trainer._plan
        log_main(f"Gradient sync: {plan.n_buckets} bucket(s) over "
                 f"{plan.total_bytes / 2 ** 20:.1f} MB of fp32 gradient")

    csv = MetricsCSV(args.output_dir)
    for epoch in range(args.epochs):
        counts = samples_per_step_list(len(train_ds), global_batch,
                                       steps_per_epoch, args.drop_last)
        state, train_loss, train_acc, epoch_time, _ = trainer.train_epoch(
            state, train_loader.epoch(epoch), epoch, steps_per_epoch,
            samples_per_step=counts)
        val_loss, val_acc = trainer.evaluate(state, val_loader.epoch(0))
        log_main(
            f"[Epoch {epoch + 1}/{args.epochs}] "
            f"Train: loss={train_loss:.4f}, acc={train_acc:.2f}% | "
            f"Val: loss={val_loss:.4f}, acc={val_acc:.2f}% | "
            f"Epoch time: {epoch_time:.2f}s"
        )
        csv.append(epoch, train_loss, train_acc, val_loss, val_acc,
                   epoch_time)
    cleanup_distributed()
    return state


def _lm_model_and_task(args, overrides, dev, seq_len, train_ds, val_ds,
                       compute_dtype):
    """The GPT-2 model (flash attention on CUDA) and the causal LM task,
    computing in ``compute_dtype``."""
    lm_kwargs = dict(dtype=compute_dtype)
    lm_kwargs.update(overrides)
    if resolve_attention(args.attention, dev.type, seq_len) == "flash":
        lm_kwargs["attention_fn"] = make_flash_attention_fn(causal=True)
    model = get_model(args.model, **lm_kwargs)
    if model.vocab_size < train_ds.vocab_size:
        # ids past the embedding would index out of range: scan the ids
        # actually present (a byte corpus under the gpt2 stamp is fine)
        for split_ds, split in ((train_ds, "train"), (val_ds, "val")):
            max_id = int(split_ds.tokens.max()) if len(split_ds) else -1
            if max_id >= model.vocab_size:
                raise ValueError(
                    f"{split} dataset {split_ds.name} contains token id "
                    f"{max_id}, which exceeds the model's vocab_size "
                    f"({model.vocab_size}); align --model-overrides "
                    "vocab_size with the data")
    return model, LanguageModelingTask(compute_dtype=compute_dtype)


if __name__ == "__main__":
    main()
