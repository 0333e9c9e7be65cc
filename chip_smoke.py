"""Drive the PyTorch port on one NVIDIA GPU: build its kernels, hold each
against its plain PyTorch version, and serve GPT-2 124M at full width.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):

1. print the card's name and power limit (nvidia-smi); TF32 off;
2. build every CUDA kernel from csrc/ with nvcc for sm_90a;
3. hold the int8 row quantizer against its plain version on the card,
   BITWISE (codes and scale bits), at the main path's shapes and at edge
   shapes, timing both beside the memory bound;
4. serve through the port's own entry (``serving smoke --model gpt2_124m
   --serve-dtype int8`` at the CLI defaults: 3 prompts, 8 new tokens
   each), with the launch counts set to 0 just before and read just
   after: the quantizer must have launched once per int8 leaf, 50 times;
   then build the same int8 engine on the CPU (same seed, same weights,
   the plain quantizer): every served leaf's codes and scales must be
   BITWISE equal to the card's, and the prefill logits within ATOL;
5. serve the same model in fp32 on the card and on the CPU and compare
   the prefill logits within ATOL;
6. print the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Details go to chiprun_out/chip_smoke.json. Without a CUDA device, or run
from a directory that lacks the port's package, it fails before printing
any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "distributed_pytorch_training_tpu_torch"
MODEL = "gpt2_124m"
MAX_NEW_TOKENS = 8      # the serving CLI's default
VOCAB = 50257

# card vs CPU, prefill logits, fp32 and int8 alike: the int8 leaves are
# bitwise equal on both (checked first), so what is left is float32
# reassociation over 12 blocks of K = 768..3072 products (TF32 is off),
# measured at 3.7e-6 on an H100; a real fault (a wrong mask, layout,
# GELU, dequantization or scale broadcast) moves logits by > 1e-2.
ATOL = 1e-4

# NVIDIA's data sheet for the H100 SXM (80 GB HBM3): memory rate and
# float32 rate outside the tensor cores, at the full 700 W.
H100_SXM = "H100 80GB HBM3"
BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timed_ms(torch, fn, x, flush, reps: int = 10) -> float:
    """Mean device time of ``fn(x)`` over ``reps`` launches, each started
    with a cold L2 (``flush`` is rewritten in between, outside the
    timed window), after one warm-up call."""
    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def quantizer_inputs(torch, dev):
    """name -> (n, s) float32 input on the card: the main path's shapes
    first (with their launch counts), then the edge shapes."""
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.serving import ServeConfig

    # the int8 leaves of the smoke's model, the shapes phase 4 quantizes
    # (max_position by build_serving_engine's rule at the CLI defaults)
    cfg = ServeConfig(buckets=(16, 32), max_new_tokens=MAX_NEW_TOKENS,
                      serve_dtype="int8")
    meta = get_model(MODEL, max_position=max(
        512, max(cfg.buckets) + cfg.max_new_tokens), device="meta")
    counts = {}
    for _, p in meta.named_parameters():
        if p.dim() >= 2 and p.numel() >= cfg.quantize_min_elements:
            shape = (p.numel() // p.shape[-1], p.shape[-1])
            counts[shape] = counts.get(shape, 0) + 1
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for shape, count in counts.items():
        x = torch.randn(shape, generator=g, device=dev) * 0.02
        cases.append((f"{shape[0]}x{shape[1]}", x, count))
    cases.append(("1x1000003", torch.randn((1, 1_000_003), generator=g,
                                           device=dev), 0))
    cases.append(("3x5", torch.randn((3, 5), generator=g, device=dev), 0))
    zero = torch.randn((4, 1000), generator=g, device=dev)
    zero[0] = 0.0
    zero[2] = 0.0
    cases.append(("4x1000 zero rows", zero, 0))
    # amax 127 makes the scale exactly 1.0, so k + 0.5 lands on a tie
    half = torch.arange(-127, 127, device=dev, dtype=torch.float32) + 0.5
    half = torch.cat([half, torch.tensor([127.0, -127.0], device=dev)])
    cases.append(("2x256 half codes", torch.stack([half, -half]), 0))
    return counts, cases


def check_quantizer(torch, dev):
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        quantize_int8_rows,
        quantize_int8_rows_ref,
    )

    counts, cases = quantizer_inputs(torch, dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, x, count in cases:
        q, s = quantize_int8_rows(x)
        qr, sr = quantize_int8_rows_ref(x)
        torch.cuda.synchronize()
        same = (torch.equal(q, qr)
                and torch.equal(s.view(torch.int32), sr.view(torch.int32)))
        err = max((q.int() - qr.int()).abs().max().item(),
                  (s - sr).abs().max().item())
        n, w = x.shape
        nbytes = 5 * n * w + 4 * n          # read 4 B, write 1 B, 4 B/row
        ops = 5 * n * w                     # abs, max, divide, round, clip
        bound_bytes_ms = nbytes / BYTES_PER_S * 1e3
        bound_ops_ms = ops / FP32_OPS_PER_S * 1e3
        row = {
            "shape": name, "main_path_launches": count, "bitwise": same,
            "max_abs_err": err,
            "ms": timed_ms(torch, quantize_int8_rows, x, flush),
            "plain_ms": timed_ms(torch, quantize_int8_rows_ref, x, flush),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
        }
        rows.append(row)
        log(f"quantize_int8_rows {name}: bitwise={same} "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); no single "
            "PyTorch call computes this function (library_ms null)")
        if not same:
            raise RuntimeError(f"quantize_int8_rows {name}: kernel differs "
                               f"from its plain version (max err {err})")
    return counts, rows


def logits_vs_cpu(report, cpu_engine) -> float:
    """Max |diff| of each smoke prompt's prefill last_logits on the card
    against ``cpu_engine`` serving the same prompt."""
    err = 0.0
    for prm, res in zip(report.prompts, report.results):
        ref = cpu_engine.serve_tokens([prm], max_new_tokens=1)[0]
        err = max(err, float(abs(res.last_logits - ref.last_logits).max()))
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / PACKAGE / "__init__.py").is_file():
        print(f"chip_smoke: {PACKAGE}/ not found beside {Path(__file__).name}"
              "; run it from the repository's root", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import distributed_pytorch_training_tpu_torch as port

    if Path(port.__file__).resolve().parent != ROOT / PACKAGE:
        raise RuntimeError(f"imported {port.__file__}, not this checkout's "
                           "package")
    from distributed_pytorch_training_tpu_torch.experiments.harness import (
        build_serving_engine,
    )
    from distributed_pytorch_training_tpu_torch.ops import build
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        quantize_int8_rows,
    )
    from distributed_pytorch_training_tpu_torch.serving import QuantizedLeaf
    from distributed_pytorch_training_tpu_torch.serving.__main__ import run

    t_start = time.perf_counter()
    # phase 1: the card
    card = nvidia_smi()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    if H100_SXM not in card:
        raise RuntimeError(f"the bounds use the H100 SXM's data sheet; this "
                           f"card is {card!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} x "
        f"{count}")

    # phase 2: build every kernel
    t0 = time.perf_counter()
    lib = build.build("quantize_int8_rows")
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    # phase 3: the quantizer against its plain version
    t0 = time.perf_counter()
    counts, rows = check_quantizer(torch, dev)
    log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")

    # phase 4: the main path, int8, through the serving CLI's smoke
    t0 = time.perf_counter()
    quantize_int8_rows.launches = 0
    report = run(["smoke", "--model", MODEL, "--serve-dtype", "int8"])
    launches = quantize_int8_rows.launches
    torch.cuda.synchronize()
    served = report.engine._served
    leaves = {name: leaf for name, leaf in served.items()
              if isinstance(leaf, QuantizedLeaf)}
    want = sum(counts.values())
    if launches != want or len(leaves) != want or want != 50:
        raise RuntimeError(f"int8 serving launched quantize_int8_rows "
                           f"{launches} times for {len(leaves)} int8 leaves "
                           f"(expected 50)")
    if len(report.results) != 3:
        raise RuntimeError(f"{len(report.results)} results for 3 prompts")
    for res in report.results:
        toks = res.tokens
        if toks.shape != (MAX_NEW_TOKENS,) or toks.min() < 0 \
                or toks.max() >= VOCAB:
            raise RuntimeError(f"bad tokens {toks.tolist()}")
        logits = torch.from_numpy(res.last_logits)
        if logits.shape != (VOCAB,) or not torch.isfinite(logits).all():
            raise RuntimeError("int8 last_logits are not finite (vocab,)")
    cpu_int8 = build_serving_engine(MODEL, max_new_tokens=MAX_NEW_TOKENS,
                                    serve_dtype="int8", device="cpu")
    for name, leaf in leaves.items():
        ref = cpu_int8._served[name]
        if not (torch.equal(leaf.q.cpu(), ref.q) and torch.equal(
                leaf.scale.cpu().view(torch.int32),
                ref.scale.view(torch.int32))):
            raise RuntimeError(f"int8 leaf {name}: the card's codes or "
                               "scales differ from the CPU's plain version")
    int8_err = logits_vs_cpu(report, cpu_int8)
    log(f"phase 4 done in {time.perf_counter() - t0:.1f} s: 3 prompts x "
        f"{MAX_NEW_TOKENS} tokens, quantize_int8_rows launches={launches}; "
        f"{len(leaves)} served leaves bitwise equal to the CPU's; int8 "
        f"prefill last_logits card vs CPU max |diff| {int8_err!r} "
        f"(tolerance {ATOL})")
    if not int8_err <= ATOL:
        raise RuntimeError(f"int8 logits differ from the CPU by {int8_err}")

    # phase 5: fp32 on the card against the same weights on the CPU
    t0 = time.perf_counter()
    gpu = run(["smoke", "--model", MODEL, "--serve-dtype", "fp32"])
    fp32_err = logits_vs_cpu(gpu, build_serving_engine(
        MODEL, max_new_tokens=MAX_NEW_TOKENS, device="cpu"))
    log(f"phase 5 done in {time.perf_counter() - t0:.1f} s: fp32 prefill "
        f"last_logits card vs CPU max |diff| {fp32_err!r} (tolerance "
        f"{ATOL})")
    if not fp32_err <= ATOL:
        raise RuntimeError(f"fp32 logits differ from the CPU by {fp32_err}")

    # phase 6: the kernels line (times summed over the main path's launches)
    main_rows = [r for r in rows if r["main_path_launches"]]
    kernel = {
        "name": "quantize_int8_rows", "route": "cuda",
        "source": f"{PACKAGE}/csrc/quantize_int8_rows.cu",
        "replaces": "distributed_pytorch_training_tpu/ops/quantize.py:147",
        "launches": launches,
        "bitwise": all(r["bitwise"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] * r["main_path_launches"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] * r["main_path_launches"]
                        for r in main_rows),
        "bound_ms": sum(r["bound_ms"] * r["main_path_launches"]
                        for r in main_rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in main_rows) else "operations"),
        "library_ms": None,
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "kernel": kernel, "per_shape": rows,
        "fp32_card_vs_cpu_max_abs": fp32_err,
        "int8_card_vs_cpu_max_abs": int8_err,
        "tokens_int8": [r.tokens.tolist() for r in report.results],
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
