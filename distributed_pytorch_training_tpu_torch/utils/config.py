"""CLI config: the JAX package's ``utils/config.py::parse_args`` with the
same flag names and defaults, plus ``--device``.

The training entry (``train.py``) refuses every flag value it does not
implement yet, naming the slice that brings it; the flags stay here so that
a command line written for the JAX package parses unchanged.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Distributed training, PyTorch port (ResNet and ViT "
                    "image classification, GPT-2 causal LM and BERT masked "
                    "LM, data-parallel under torchrun)")
    add = parser.add_argument

    # the reference's flags (same names and defaults)
    add("--data-dir", default="./data", type=str,
        help="directory holding the CIFAR-10 pickles or "
             "<family>_{train,val}.npy token files")
    add("--epochs", default=10, type=int, help="number of total epochs")
    add("--batch-size", default=128, type=int,
        help="mini-batch size per device")
    add("--workers", default=4, type=int,
        help="host prefetch depth (image loaders; unused by the LM path)")
    add("--lr", default=0.1, type=float, help="initial learning rate")
    add("--momentum", default=0.9, type=float, help="SGD momentum")
    add("--weight-decay", default=5e-4, type=float, help="weight decay")
    add("--amp", "--bf16", dest="amp", action="store_true",
        help="bf16 compute (not ported yet)")
    add("--print-freq", default=50, type=int,
        help="print frequency (in steps)")
    add("--output-dir", default="./experiments", type=str,
        help="directory for metrics_rank0.csv")
    add("--seed", default=42, type=int, help="random seed")

    # the JAX package's extensions
    add("--model", default="resnet18", type=str,
        help="model name (resnet18/resnet50 and gpt2_124m/gpt2_355m are "
             "ported)")
    add("--model-overrides", default="", type=str,
        help="comma-separated field=value constructor overrides, e.g. "
             "'depth=2,hidden_dim=64'")
    add("--dataset", default="cifar10", type=str,
        help="image dataset name (image models only)")
    add("--download", action="store_true",
        help="fetch the dataset (refused: the port fetches nothing)")
    add("--synthetic", action="store_true", help="force synthetic data")
    add("--synthetic-size", default=None, type=int,
        help="synthetic dataset size override")
    add("--mesh", default="data=-1", type=str,
        help="mesh spec; the port's mesh is one data axis over the ranks")
    add("--slices", default=1, type=int,
        help="factor the ranks into this many slices (the outermost "
             "mesh axis, the slow tier of --wire-dtype int8_hier)")
    add("--slice-axis", default="slice", type=str,
        help="mesh axis int8_hier treats as the slow tier")
    add("--microbatches", default=4, type=int,
        help="GPipe microbatches when the mesh has a pipe axis")
    add("--optimizer", default="sgd", type=str, help="sgd | adamw")
    add("--seq-len", default=None, type=int,
        help="sequence length for LM configs (default 1024 for gpt2, "
             "512 for bert)")
    add("--attention", default="auto", type=str,
        choices=["auto", "xla", "flash", "ring", "ulysses"],
        help="attention for LM configs: auto (flash on CUDA, the einsum "
             "on the CPU), xla (the einsum), flash (the hand-written "
             "kernels); ring and ulysses are not ported")
    add("--grad-accum", default=1, type=int,
        help="gradient accumulation: microbatches per optimizer step")
    add("--bucket-cap-mb", default=0.0, type=float,
        help="explicit bucketed gradient sync: bucket cap in MB (0: one "
             "bucket when a compressed wire engages the reducer)")
    add("--wire-dtype", default="fp32", type=str,
        choices=["fp32", "bf16", "int8", "int8_multihop", "int8_hier"],
        help="gradient wire dtype; int8_hier compresses only across the "
             "--slices slices")
    add("--fused-quantize", default="auto", type=str,
        choices=["auto", "on", "off"],
        help="int8 codec kernels for the int8 wires: auto and on run "
             "them on CUDA; off (the composed codec) is CPU-only here")
    add("--no-overlap-grad-sync", action="store_true",
        help="reduce buckets after the microbatch loop")
    add("--fsdp-explicit", action="store_true",
        help="explicit full-parameter FSDP: parameters and moments "
             "flat-sharded 1/N at rest, per-layer gathers and scatters")
    add("--zero1", action="store_true",
        help="ZeRO-1: reduce-scatter the gradient, update 1/N of the "
             "parameters, gather them back")
    add("--remat", action="store_true",
        help="gradient checkpointing: recompute each transformer block "
             "in the backward (gpt2, bert, vit)")
    add("--schedule", default="constant", type=str,
        help="lr schedule: constant | cosine | linear_warmup")
    add("--warmup-steps", default=0, type=int)
    add("--drop-last", action="store_true",
        help="drop the final partial batch")
    add("--no-augment", action="store_true",
        help="disable image augmentation (image models only)")
    add("--cifar-stem", action="store_true",
        help="3x3/1 ResNet stem (image models only)")
    add("--checkpoint-dir", default=None, type=str,
        help="checkpoint directory (not ported)")
    add("--checkpoint-every", default=1, type=int,
        help="checkpoint every N epochs")
    add("--resume", action="store_true", help="resume (not ported)")
    add("--max-restarts", default=0, type=int,
        help="restart supervisor (not ported)")
    add("--chaos", default=None, type=str,
        help="fault injection (not ported)")
    add("--profile-dir", default=None, type=str,
        help="profiler trace directory (not ported)")
    add("--profile-steps", default="10,20", type=str,
        help="start,stop step of the profiled window")
    add("--no-telemetry", action="store_true",
        help="disable the telemetry stream (the port writes none yet)")
    add("--telemetry-all-ranks", action="store_true",
        help="telemetry from every rank (not ported)")
    add("--metrics-port", default=None, type=int,
        help="live /metrics endpoint (not ported)")
    add("--autopilot", action="store_true",
        help="control-plane autopilot (not ported)")
    add("--autopilot-tune", action="store_true",
        help="autopilot perf tuner (not ported)")
    add("--telemetry-abort", action="store_true",
        help="anomaly watchdog abort hook (not ported)")

    # the port's own
    add("--device", default=None, type=str,
        help="cuda (the default) or cpu; cpu runs the plain PyTorch "
             "versions of the kernels and is for tests only")

    return parser.parse_args(argv)


def parse_model_overrides(spec: str) -> dict:
    """'depth=2,hidden_dim=64' -> {'depth': 2, 'hidden_dim': 64}. Values
    parse as int, then float, then bool ('true'/'false'), else string."""
    out: dict = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in item:
            raise ValueError(
                f"--model-overrides entry {item!r} is not field=value")
        key, val = (s.strip() for s in item.split("=", 1))
        for cast in (int, float):
            try:
                out[key] = cast(val)
                break
            except ValueError:
                continue
        else:
            out[key] = {"true": True, "false": False}.get(val.lower(), val)
    return out
