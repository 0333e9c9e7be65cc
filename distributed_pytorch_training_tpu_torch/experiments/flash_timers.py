"""Time the flash-attention kernels (K3-K5) and torch's
``scaled_dot_product_attention`` at the main paths' shapes, in bfloat16
and float32, under three timers:

    python3 distributed_pytorch_training_tpu_torch/experiments/flash_timers.py \\
        [--root DIR] [--out FILE] [--shapes gpt2,bert,tp]

Shapes (B, S, H, D): ``gpt2`` GPT-2 124M's (8, 1024, 12, 64) causal (the
default), ``bert`` BERT-base's (8, 512, 12, 64) non-causal, ``tp`` one of
two tensor-parallel ranks' (and Ulysses') (8, 1024, 6, 64) causal.

``--root`` names the checkout whose package is timed (default: the one
this file is in), so two commits are compared on one card in one run:
parent, change, change, parent, each in a process of its own.

Every timed call follows an L2 flush (a 256 MiB write); each number is the
mean of 10 calls after one warm-up:

* ``launch_ms``: CUDA events around the call right after the flush, as
  ``chip_smoke.py``'s ``timed_ms``. When the host takes longer to queue
  the call than the card takes to flush, the card idles inside the timed
  window and the gap is counted;
* ``device_ms``: the same with a ~1 ms sleep on the card between the
  flush and the start event, so the whole call is queued before the
  start event fires: the card's time alone;
* ``host_ms``: the host's time to return from one call (queueing only,
  nothing waits for the card), mean of 50 calls.

Prints one JSON object: the card, the root, and per shape, dtype and
function the three times.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

# (B, S, H, D), causal
SHAPES = {"gpt2": ((8, 1024, 12, 64), True), "bert": ((8, 512, 12, 64), False),
          "tp": ((8, 1024, 6, 64), True)}
GUARD_CYCLES = 2_000_000            # ~1 ms at the H100's clock
REPS, HOST_REPS = 10, 50


def _timed(torch, fn, flush, guard: bool) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(REPS):
        flush.zero_()
        if guard:
            torch.cuda._sleep(GUARD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / REPS


def _host_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / HOST_REPS * 1e3


def _time_shape(torch, F, fa, shape, causal, dtype, dev, flush) -> dict:
    """{function: {launch_ms, device_ms, host_ms}} of K3-K5 and SDPA's
    forward and backward on seeded (B, S, H, D) inputs of ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
    delta = fa._delta(out, do)
    lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    ldo = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

    lout = sdpa()
    fns = {
        "flash_attention_fwd_lse":
            lambda: fa.flash_attention_fwd_lse(q, k, v, causal),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal),
        "sdpa_fwd": sdpa,
        "sdpa_bwd": lambda: torch.autograd.grad(
            lout, (lq, lk, lv), ldo, retain_graph=True),
    }
    return {name: {"launch_ms": _timed(torch, fn, flush, guard=False),
                   "device_ms": _timed(torch, fn, flush, guard=True),
                   "host_ms": _host_ms(torch, fn)}
            for name, fn in fns.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--shapes", default="gpt2",
                    help=f"comma-separated names of {sorted(SHAPES)}")
    args = ap.parse_args(argv)
    names = args.shapes.split(",")
    if not set(names) <= set(SHAPES):
        ap.error(f"--shapes names from {sorted(SHAPES)}")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("flash_timers: no CUDA device")
    fa = importlib.import_module(
        "distributed_pytorch_training_tpu_torch.ops.flash_attention")
    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"flash_timers: imported {fa.__file__}, not {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    report = {"card": card, "root": str(root), "shapes": {}}
    for name in names:
        shape, causal = SHAPES[name]
        report["shapes"][name] = {"shape": shape, "causal": causal,
                                  "times": {}}
        for dtype in (torch.bfloat16, torch.float32):
            report["shapes"][name]["times"][str(dtype)[6:]] = _time_shape(
                torch, F, fa, shape, causal, dtype, dev, flush)
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
