"""Training entry point of the PyTorch port: the causal-LM path of the JAX
package's ``train.py`` (GPT-2), on one CUDA device.

    python -m distributed_pytorch_training_tpu_torch.train --model gpt2_124m \\
        --attention flash --optimizer adamw --lr 3e-4 --synthetic \\
        --batch-size 8 --epochs 2

Same flags, stdout lines and ``metrics_rank0.csv`` as the JAX entry. Every
flag value this slice does not implement raises ``NotImplementedError``
naming the slice that brings it. ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU and is for tests; without it the run needs a
CUDA device. The initial weights are drawn from a ``torch.Generator``
seeded by ``--seed`` (not jax.random's numbers; ``convert.py`` carries
weights between the packages).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from .data.text import TokenLoader, get_token_dataset
from .models import get_model
from .ops.flash_attention import (
    flash_backend_supported,
    flash_supports_length,
    make_flash_attention_fn,
)
from .runtime import (
    barrier,
    cleanup_distributed,
    not_ported,
    resolve_device,
    set_seed,
    setup_distributed,
)
from .training import TrainConfig, Trainer, make_optimizer, make_schedule
from .training.tasks import LanguageModelingTask
from .utils import MetricsCSV, log_main, parse_args
from .utils.config import parse_model_overrides

PORTED_MODELS = ("gpt2_124m", "gpt2_355m")

# flag -> (is the value unsupported?, the slice that brings it)
_UNPORTED = {
    "--amp": (lambda a: a.amp, "the bf16 (--amp) slice"),
    "--remat": (lambda a: a.remat, "the remat slice"),
    "--slices": (lambda a: a.slices > 1, "the data-parallel slice"),
    "--zero1": (lambda a: a.zero1, "the data-parallel slice"),
    "--fsdp-explicit": (lambda a: a.fsdp_explicit, "the data-parallel slice"),
    "--bucket-cap-mb": (lambda a: a.bucket_cap_mb > 0,
                        "the data-parallel slice"),
    "--wire-dtype": (lambda a: a.wire_dtype != "fp32",
                     "the data-parallel slice"),
    "--fused-quantize on": (lambda a: a.fused_quantize == "on",
                            "the data-parallel slice"),
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
    "--download": (lambda a: a.download, "the ResNet-18 slice"),
    "--attention ring/ulysses": (lambda a: a.attention in ("ring",
                                                           "ulysses"),
                                 "the sequence-parallel slice"),
}


def _one_data_shard(mesh: str) -> bool:
    """True for a mesh spec of one data shard ('data=-1' or 'data=1',
    other axes 1)."""
    for item in filter(None, (s.strip() for s in mesh.split(","))):
        axis, _, size = item.partition("=")
        try:
            n = int(size)
        except ValueError:
            return False
        if n != 1 and not (axis.strip() == "data" and n == -1):
            return False
    return True


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` for the first flag value this slice
    does not implement."""
    if args.model not in PORTED_MODELS:
        where = ("the ResNet-18 slice" if args.model.startswith("resnet")
                 else "a later slice")
        raise not_ported(f"--model {args.model}", where)
    if not _one_data_shard(args.mesh):
        raise not_ported(f"--mesh {args.mesh}",
                         "the data-parallel and tensor-parallel slices")
    for flag, (unsupported, where) in _UNPORTED.items():
        if unsupported(args):
            raise not_ported(flag, where)


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


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    refuse_unported(args)
    dev = resolve_device(args.device)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    ctx = setup_distributed()
    set_seed(args.seed, ctx.process_index)
    global_batch = args.batch_size * ctx.device_count
    log_main(f"Using device: {dev} (mesh {{'data': 1}}), "
             f"world_size={ctx.device_count}, amp={args.amp}")
    if not args.no_telemetry:
        log_main("NOTE: the PyTorch port writes no telemetry stream yet "
                 "(it comes with the telemetry slice)")

    family = "gpt2"
    seq_len = args.seq_len or 1024
    attention = resolve_attention(args.attention, dev.type, seq_len)
    train_ds = get_token_dataset(family, seq_len, args.data_dir, train=True,
                                 synthetic_size=args.synthetic_size,
                                 seed=args.seed)
    val_ds = get_token_dataset(family, seq_len, args.data_dir, train=False,
                               synthetic_size=(args.synthetic_size or 0)
                               // 5 or None, seed=args.seed)
    barrier("data_ready")
    if train_ds.synthetic:
        log_main(f"NOTE: using synthetic data ({train_ds.name}, "
                 f"n={len(train_ds)})")

    train_loader = TokenLoader(train_ds, args.batch_size, shuffle=True,
                               seed=args.seed, drop_last=args.drop_last,
                               device=dev)
    val_loader = TokenLoader(val_ds, args.batch_size, shuffle=False,
                             seed=args.seed, device=dev)
    lm_kwargs = parse_model_overrides(args.model_overrides)
    if attention == "flash":
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
    task = LanguageModelingTask()

    steps_per_epoch = len(train_loader)
    schedule = make_schedule(args.schedule, args.lr,
                             total_steps=steps_per_epoch * args.epochs,
                             warmup_steps=args.warmup_steps)
    tx = make_optimizer(args.optimizer, schedule, momentum=args.momentum,
                        weight_decay=args.weight_decay)
    trainer = Trainer(task, TrainConfig(
        per_device_batch=args.batch_size, print_freq=args.print_freq,
        seed=args.seed, bf16=args.amp, grad_accum=args.grad_accum,
        overlap_grad_sync=not args.no_overlap_grad_sync), device=dev)
    # drawn on the CPU, so one seed gives the same weights on every device
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    state = trainer.init_state(model, tx)
    log_main(f"Model {args.model}: {state.param_count():,} params")

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


if __name__ == "__main__":
    sys.exit(main())
