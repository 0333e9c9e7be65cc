"""Time the int8 codec's kernels, K2 (``dequant_sum_rows``) at the shapes
the int8 wires give it and at edge shapes, and K1 (``quantize_int8_rows``)
at its wire shapes, under ``flash_timers.py``'s three timers:

    python3 distributed_pytorch_training_tpu_torch/experiments/codec_timers.py \\
        [--root DIR] [--out FILE]

``launch_ms`` (CUDA events around the call after an L2 flush),
``device_ms`` (the same with the card kept busy until the call is queued:
the card's time alone) and ``host_ms`` (the host's time to return from one
call) are ``flash_timers.py``'s, each the mean of its repetitions.

``--root`` names the checkout whose package is timed (default: the one
this file is in), so two commits are compared on one card in one run:
parent, change, change, parent, each in a process of its own. The timers
come from the timed checkout's ``flash_timers.py``.

Every shape is first checked bitwise against the plain version. Prints one
JSON object: the card (name and power limit), the root, per kernel and
shape the three times, the bound (bytes over 3.35 TB/s) and, for K2, the
staged or generic variant of the checkout's launch plan (``null`` where the
checkout has none); and yardsticks under the same timers: an empty kernel,
and torch's float32 copy and fill of K2's bytes at BERT's shape.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet
# (n, s): BERT-base's int8 bucket, ResNet-18's one bucket, the cap-25
# buckets, the multihop hop-1 chunk, then edges
K2_SHAPES = [(2, 109_514_298), (2, 11_181_642), (2, 6_553_600),
             (2, 5_590_821), (2, 4_628_042), (2, 1), (1, 4097), (2, 4099)]
# K1 on the same wires: one row a bucket (int8), the multihop hop-0 chunks
K1_SHAPES = [(1, 109_514_298), (1, 11_181_642), (1, 6_553_600),
             (1, 4_628_042), (2, 5_590_821), (1, 5_590_821)]


def _rows(torch, shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    n, _ = shape
    return torch.randn(shape, generator=g, device=dev) * (
        torch.rand((n, 1), generator=g, device=dev) * 10 + 0.01)


def _times(torch, timers, fn, flush) -> dict:
    return {"launch_ms": timers._timed(torch, fn, flush, guard=False),
            "device_ms": timers._timed(torch, fn, flush, guard=True),
            "host_ms": timers._host_ms(torch, fn)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("codec_timers: no CUDA device")
    qz = importlib.import_module(
        "distributed_pytorch_training_tpu_torch.ops.quantize")
    timers = importlib.import_module(
        "distributed_pytorch_training_tpu_torch.experiments.flash_timers")
    for mod in (qz, timers):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise SystemExit(f"codec_timers: imported {mod.__file__}, "
                             f"not {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    plan = getattr(qz, "dequant_plan", None)
    report = {"card": card, "root": str(root),
              "dequant_sum_rows": {}, "quantize_int8_rows": {}}
    for seed, shape in enumerate(K2_SHAPES):
        n, s = shape
        q, sc = qz.quantize_int8_rows_ref(_rows(torch, shape, seed, dev))
        out, want = qz.dequant_sum_rows(q, sc), qz.dequant_sum_rows_ref(q, sc)
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"codec_timers: K2 {shape} differs from its "
                             "plain version")
        del out, want
        row = _times(torch, timers, lambda: qz.dequant_sum_rows(q, sc),
                     flush)
        row["bound_ms"] = (n * s + 4 * n + 4 * s) / BYTES_PER_S * 1e3
        row["variant"] = None if plan is None else (
            "staged" if plan(n, s, sms).staged else "generic")
        report["dequant_sum_rows"][f"{n}x{s}"] = row
        del q, sc
    for seed, shape in enumerate(K1_SHAPES):
        n, s = shape
        x = _rows(torch, shape, 100 + seed, dev)
        (q, sc), (qr, sr) = qz.quantize_int8_rows(x), \
            qz.quantize_int8_rows_ref(x)
        if not (torch.equal(q, qr) and torch.equal(sc.view(torch.int32),
                                                   sr.view(torch.int32))):
            raise SystemExit(f"codec_timers: K1 {shape} differs from its "
                             "plain version")
        del q, sc, qr, sr
        row = _times(torch, timers, lambda: qz.quantize_int8_rows(x), flush)
        row["bound_ms"] = (5 * n * s + 4 * n) / BYTES_PER_S * 1e3
        report["quantize_int8_rows"][f"{n}x{s}"] = row
        del x
    # yardsticks: an empty kernel (the timers' floor), and torch's float32
    # copy of as many bytes as K2 moves at BERT's shape, and its fill of
    # K2's output there
    n, s = K2_SHAPES[0]
    dst = torch.empty(s, device=dev)
    src = torch.empty((n * s + 4 * s) // 8, device=dev)
    src_to = torch.empty_like(src)
    report["yardsticks"] = {
        "empty kernel": _times(torch, timers, lambda: torch.cuda._sleep(0),
                               flush),
        f"float32 copy of {8 * src.numel()} bytes": _times(
            torch, timers, lambda: src_to.copy_(src), flush),
        f"float32 fill of {4 * s} bytes": _times(
            torch, timers, lambda: dst.fill_(1.0), flush)}
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
