"""Drive the PyTorch port on one NVIDIA GPU: build its kernels, hold each
against its plain PyTorch version, serve GPT-2 124M and train it at full
width.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):

1. print the card's name and power limit (nvidia-smi); TF32 off;
2. build every CUDA kernel from csrc/ with nvcc for sm_90a, one nvcc per
   source, all started together;
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
6. hold the flash-attention kernels (forward, dK/dV, dQ) against their
   plain versions at the training path's shape (fp32 and bf16) and at
   edge shapes, within FLASH_REL, timing each beside its bound and beside
   torch's scaled_dot_product_attention;
7. train through the port's own entry (``train.main``: GPT-2 124M at full
   width, seq 1024, flash attention, AdamW, 2 epochs of 8 steps on 64
   synthetic sequences, batch 8), with the launch counts set to 0 just
   before and read just after: the forward must have launched 240 times
   (12 blocks x (8 train + 2 eval batches) x 2 epochs), each backward
   kernel 192 times; the losses must be finite and epoch 2's train loss
   below epoch 1's;
8. one loss-and-backward on a fixed batch from the same initial weights
   on the card (the kernels) and on the CPU (the plain versions): the
   loss within LOSS_ATOL, each gradient within GRAD_REL of its leaf's
   max |g|;
9. print the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Details go to chiprun_out/chip_smoke.json. Without a CUDA device, or run
from a directory that lacks the port's package, it fails before printing
any result.
"""

from __future__ import annotations

import importlib
import json
import math
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

# NVIDIA's data sheet for the H100 SXM (80 GB HBM3): memory rate, float32
# rate outside the tensor cores and bf16 dense tensor-core rate, at the
# full 700 W.
H100_SXM = "H100 80GB HBM3"
BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# flash kernels against their plain versions, as max|diff| / max|plain|
# per output. float32: both sum in float32 in different orders (tiles vs
# full rows), some 1e-6 of the output's scale at these sizes; a wrong
# mask, scale or index moves whole rows by O(1). bfloat16: both round
# their float32 results to bfloat16 (8 bits of mantissa), so an element
# may differ by one bfloat16 step, 2**-8 of its magnitude.
FLASH_REL = {"float32": 1e-4, "bfloat16": 1e-2}

# (name, B, Sq, Sk, H, D, causal, kv_valid, dtype): the training path's
# shape first, then the edges
FLASH_CASES = [
    ("main fp32", 8, 1024, 1024, 12, 64, True, False, "float32"),
    ("main bf16", 8, 1024, 1024, 12, 64, True, False, "bfloat16"),
    ("non-causal", 8, 1024, 1024, 12, 64, False, False, "float32"),
    ("kv_valid, all-masked rows", 4, 512, 512, 12, 64, True, True,
     "float32"),
    ("Sq=Sk=1000", 8, 1000, 1000, 12, 64, True, False, "float32"),
    ("Sq=256 Sk=512", 8, 256, 512, 12, 64, True, False, "float32"),
    ("D=128", 8, 1024, 1024, 6, 128, True, False, "float32"),
]
TRAIN_STEPS = 8            # 64 sequences / batch 8
EVAL_STEPS = 2             # 64 // 5 = 12 sequences, 2 padded batches of 8
EPOCHS = 2
DEPTH = 12

# card vs CPU, one loss-and-backward from the same weights (TF32 off): the
# two sides differ by float32 reassociation over 12 blocks (cuBLAS vs the
# CPU's GEMMs, tiled vs full-row softmax), a few 1e-6 of a leaf's largest
# gradient; a wrong mask, scale or index in a backward kernel moves whole
# rows by O(1) of it.
LOSS_ATOL = 1e-4
GRAD_REL = 1e-3
CPU_BATCH, CPU_SEQ = 2, 256


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timed_ms(torch, fn, flush, reps: int = 10) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, each started
    with a cold L2 (``flush`` is rewritten in between, outside the
    timed window), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
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
            "ms": timed_ms(torch, lambda: quantize_int8_rows(x), flush),
            "plain_ms": timed_ms(torch, lambda: quantize_int8_rows_ref(x),
                                 flush),
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


def flash_module():
    """The port's ops/flash_attention.py (the ops package re-exports its
    function ``flash_attention`` under the module's name)."""
    return importlib.import_module(f"{PACKAGE}.ops.flash_attention")


def rel_err(torch, got, want) -> float:
    """max|got - want| / max|want|; a non-finite result fails."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise RuntimeError("a flash kernel wrote a non-finite value")
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def flash_bounds(torch, case, kv) -> dict:
    """{kernel: (bound ms, "bytes" or "operations")} of one launch: the
    larger of the bytes it must move (each input read once, each output
    written once) over the memory rate and the flops of this input's live
    (query, key) pairs (4, 8 and 6 x D each, the JAX module's cost counts)
    over the peak rate of the input type."""
    _, b, sq, sk, h, d, causal, _, dtype = case
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep = keep.tril()
    if kv is None:
        pairs = b * int(keep.sum())
    else:
        pairs = int((keep[None] & (kv.cpu()[:, None, :] > 0)).sum())
    pairs *= h
    item = 4 if dtype == "float32" else 2
    rate = FP32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
    nq, nk = b * sq * h * d * item, b * sk * h * d * item
    rows = b * h * sq * 4                       # lse or delta, float32
    mask = 0 if kv is None else b * sk * 4
    work = {
        "flash_attention_fwd_lse": (2 * nq + 2 * nk + rows + mask, 4),
        "flash_attention_bwd_dkv": (2 * nq + 4 * nk + 2 * rows + mask, 8),
        "flash_attention_bwd_dq": (3 * nq + 2 * nk + 2 * rows + mask, 6),
    }
    out = {}
    for name, (nbytes, per_pair) in work.items():
        t_bytes = nbytes / BYTES_PER_S * 1e3
        t_ops = per_pair * d * pairs / rate * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def check_flash(torch, dev, flush):
    """Each FLASH_CASES shape: the three kernels against their plain
    versions, then kernel, plain and library times beside the bounds."""
    import torch.nn.functional as F

    fa = flash_module()
    rows = []
    for case in FLASH_CASES:
        name, b, sq, sk, h, d, causal, masked, dtype_name = case
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device=dev).manual_seed(1)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        q, k, v, do = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d), \
            rnd(b, sq, h, d)
        kv = None
        keep = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            keep = keep.tril()
        live = keep.any(-1).expand(b, sq)
        if masked:
            kv = (torch.rand((b, sk), generator=g, device=dev) > 0.3).float()
            kv[0] = 0.0                         # every key of row 0 masked
            kv[1, : sk // 2] = 0.0              # early rows of row 1 too
            live = (keep[None] & (kv[:, None, :] > 0)).any(-1)
        # a row with no live key emits a tile-dependent mean(V) under
        # causal: the loss gives it no weight, so neither does dO
        do = do * live[:, :, None, None].to(dtype)
        args = (causal, None, kv)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, *args)
        out_r, lse_r = fa.flash_attention_fwd_lse_ref(q, k, v, *args)
        delta = fa._delta(out, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, *args)
        dk_r, dv_r = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                    *args)
        dq_r = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *args)
        torch.cuda.synchronize()
        lse_rows = lse.reshape(b, h, sq).transpose(1, 2)[live]
        lse_rows_r = lse_r.reshape(b, h, sq).transpose(1, 2)[live]
        if not torch.isfinite(out).all():
            raise RuntimeError(f"flash {name}: non-finite output")
        errs = {
            "out": rel_err(torch, out[live], out_r[live]),
            "lse": rel_err(torch, lse_rows, lse_rows_r),
            "dq": rel_err(torch, dq, dq_r),
            "dk": rel_err(torch, dk, dk_r),
            "dv": rel_err(torch, dv, dv_r),
        }
        abs_err = {
            "flash_attention_fwd_lse": max(
                (out[live].float() - out_r[live].float()).abs().max().item(),
                (lse_rows - lse_rows_r).abs().max().item()),
            "flash_attention_bwd_dkv": max(
                (dk.float() - dk_r.float()).abs().max().item(),
                (dv.float() - dv_r.float()).abs().max().item()),
            "flash_attention_bwd_dq":
                (dq.float() - dq_r.float()).abs().max().item(),
        }
        tol = FLASH_REL[dtype_name]
        # lse is float32 on both sides whatever the inputs' type
        bad = {o: e for o, e in errs.items()
               if e > (FLASH_REL["float32"] if o == "lse" else tol)}
        ms = {
            "flash_attention_fwd_lse": timed_ms(
                torch, lambda: fa.flash_attention_fwd_lse(q, k, v, *args),
                flush),
            "flash_attention_bwd_dkv": timed_ms(
                torch, lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, *args), flush),
            "flash_attention_bwd_dq": timed_ms(
                torch, lambda: fa.flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, *args), flush),
        }
        plain_ms = {
            "flash_attention_fwd_lse": timed_ms(
                torch, lambda: fa.flash_attention_fwd_lse_ref(q, k, v, *args),
                flush),
            "flash_attention_bwd_dkv": timed_ms(
                torch, lambda: fa.flash_attention_bwd_dkv_ref(
                    q, k, v, do, lse, delta, *args), flush),
            "flash_attention_bwd_dq": timed_ms(
                torch, lambda: fa.flash_attention_bwd_dq_ref(
                    q, k, v, do, lse, delta, *args), flush),
        }
        library = {"sdpa_fwd_ms": None, "sdpa_bwd_ms": None}
        if kv is None:
            # the yardstick: one torch call for the same function, (B, H,
            # S, D) views; its causal mask is top-left aligned as ours
            lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            ldo = do.transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(lq, lk, lv,
                                                      is_causal=causal)

            lout = sdpa()
            library["sdpa_fwd_ms"] = timed_ms(torch, sdpa, flush)
            library["sdpa_bwd_ms"] = timed_ms(
                torch, lambda: torch.autograd.grad(
                    lout, (lq, lk, lv), ldo, retain_graph=True), flush)
            del lout
        bounds = flash_bounds(torch, case, kv)
        row = {"shape": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
               "causal": causal, "kv_valid": masked, "dtype": dtype_name,
               "rel_err": errs, "tolerance": tol, "max_abs_err": abs_err,
               "ms": ms, "plain_ms": plain_ms, **library,
               "bound_ms": {n: t for n, (t, _) in bounds.items()},
               "bound_by": {n: by for n, (_, by) in bounds.items()}}
        rows.append(row)
        log(f"flash {name}: rel err "
            + ", ".join(f"{o} {e:.2e}" for o, e in errs.items())
            + f" (tolerance {tol}); kernel ms "
            + ", ".join(f"{n.rsplit('_', 1)[-1]} {t:.4f}"
                        for n, t in ms.items())
            + "; plain ms "
            + ", ".join(f"{n.rsplit('_', 1)[-1]} {t:.4f}"
                        for n, t in plain_ms.items())
            + f"; sdpa fwd {library['sdpa_fwd_ms']} bwd "
              f"{library['sdpa_bwd_ms']} ms; bound ms "
            + ", ".join(f"{n.rsplit('_', 1)[-1]} {t:.4f} ({by})"
                        for n, (t, by) in bounds.items()))
        if bad:
            raise RuntimeError(f"flash {name}: kernels differ from their "
                               f"plain versions: {bad} > {tol}")
        del q, k, v, do, out, out_r, dq, dk, dv, dq_r, dk_r, dv_r
        torch.cuda.empty_cache()
    return rows


def train_on_card(torch, fa):
    """Phase 7: the port's training entry at full width, in-process.
    Returns ({kernel: launches}, [(train_loss, val_loss) per epoch])."""
    from distributed_pytorch_training_tpu_torch import train

    out_dir = ROOT / "chiprun_out" / "train_smoke"
    csv = out_dir / "metrics_rank0.csv"
    csv.unlink(missing_ok=True)                 # the CSV appends
    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    train.main(["--model", MODEL, "--attention", "flash", "--optimizer",
                "adamw", "--lr", "6e-4", "--synthetic", "--synthetic-size",
                "64", "--batch-size", "8", "--epochs", str(EPOCHS),
                "--print-freq", "4", "--output-dir", str(out_dir)])
    launches = {fn.__name__: fn.launches for fn in kernels}
    torch.cuda.synchronize()
    want = {"flash_attention_fwd_lse":
            DEPTH * (TRAIN_STEPS + EVAL_STEPS) * EPOCHS,
            "flash_attention_bwd_dkv": DEPTH * TRAIN_STEPS * EPOCHS,
            "flash_attention_bwd_dq": DEPTH * TRAIN_STEPS * EPOCHS}
    if launches != want:
        raise RuntimeError(f"training launched {launches}, expected {want}")
    lines = csv.read_text().splitlines()[1:]
    losses = [(float(ln.split(",")[1]), float(ln.split(",")[3]))
              for ln in lines]
    if len(losses) != EPOCHS or not all(
            math.isfinite(x) for pair in losses for x in pair):
        raise RuntimeError(f"training CSV rows {lines}: expected {EPOCHS} "
                           "finite (train, val) losses")
    if not losses[1][0] < losses[0][0]:
        raise RuntimeError(f"epoch 2's train loss {losses[1][0]} is not "
                           f"below epoch 1's {losses[0][0]}")
    return launches, losses


def grads_card_vs_cpu(torch, dev):
    """Phase 8: (loss |diff|, max over leaves of max|g diff| / max|g|,
    the leaf that gives it) for one loss-and-backward on a fixed batch."""
    import numpy as np

    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        LanguageModelingTask,
    )

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, VOCAB, (CPU_BATCH, CPU_SEQ)).astype(np.int32))
    task = LanguageModelingTask()
    results = []
    for device in (dev, torch.device("cpu")):
        model = get_model(MODEL, attention_fn=make_flash_attention_fn(True))
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(device)
        loss, _ = task.loss_and_metrics(model, {
            "input_ids": ids.to(device),
            "weight": torch.ones(CPU_BATCH, device=device)}, train=True)
        loss.backward()
        results.append((loss.item(), {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()}))
        del model
    (loss_c, g_c), (loss_h, g_h) = results
    worst, worst_leaf = 0.0, ""
    for name, ref in g_h.items():
        err = ((g_c[name] - ref).abs().max()
               / ref.abs().max().clamp(min=1e-30)).item()
        if not math.isfinite(err) or err > worst:
            worst, worst_leaf = err, name
    return abs(loss_c - loss_h), worst, worst_leaf, loss_c, loss_h


def flash_kernel_rows(flash_rows, launches) -> list:
    """The kernels line's rows of K3, K4 and K5: times and bounds of the
    training path's shape (main fp32) summed over its launches; errors
    over every shape checked."""
    main = flash_rows[0]
    replaces = {
        "flash_attention_fwd_lse": 199,   # _flash_fwd_lse (_fwd_kernel)
        "flash_attention_bwd_dkv": 360,   # _flash_bwd (_bwd_dkv_kernel)
        "flash_attention_bwd_dq": 360,    # _flash_bwd (_bwd_dq_kernel)
    }
    rows = []
    for name, line in replaces.items():
        n = launches[name]
        lib = main["sdpa_fwd_ms"] if name.endswith("fwd_lse") \
            else main["sdpa_bwd_ms"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/flash_attention.cu",
            "replaces": "distributed_pytorch_training_tpu/ops/"
                        f"flash_attention.py:{line}",
            "launches": n,
            "max_abs_err": max(r["max_abs_err"][name] for r in flash_rows),
            "ms": main["ms"][name] * n,
            "plain_ms": main["plain_ms"][name] * n,
            "bound_ms": main["bound_ms"][name] * n,
            "bound_by": main["bound_by"][name],
            # scaled_dot_product_attention's forward for K3; its backward
            # (dq, dk and dv together) for K4 and K5 alike
            "library_ms": lib * n,
        })
    return rows


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

    # phase 2: build every kernel, one nvcc per source, all at once
    fa = flash_module()
    t0 = time.perf_counter()
    libs = build.build_all(["quantize_int8_rows", fa.LIBRARY])
    log(f"built {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

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

    # phase 6: the flash kernels against their plain versions
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flash_rows = check_flash(torch, dev, flush)
    del flush
    log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")

    # phase 7: the training path through the port's own entry
    t0 = time.perf_counter()
    flash_launches, losses = train_on_card(torch, fa)
    log(f"phase 7 done in {time.perf_counter() - t0:.1f} s: launches "
        f"{flash_launches}; (train, val) loss per epoch {losses}")

    # phase 8: one loss-and-backward, card (kernels) against CPU (plain)
    t0 = time.perf_counter()
    before = fa.flash_attention_bwd_dq.launches
    loss_err, grad_err, grad_leaf, loss_card, loss_cpu = grads_card_vs_cpu(
        torch, dev)
    if fa.flash_attention_bwd_dq.launches != before + DEPTH:
        raise RuntimeError("the card's backward did not run the kernels")
    log(f"phase 8 done in {time.perf_counter() - t0:.1f} s: {CPU_BATCH}x"
        f"{CPU_SEQ} loss card {loss_card!r} cpu {loss_cpu!r} (|diff| "
        f"{loss_err!r}, tolerance {LOSS_ATOL}); worst gradient "
        f"max|diff|/max|g| {grad_err!r} in {grad_leaf} (tolerance "
        f"{GRAD_REL})")
    if not (loss_err <= LOSS_ATOL and grad_err <= GRAD_REL):
        raise RuntimeError(f"card vs CPU: loss |diff| {loss_err}, gradient "
                           f"{grad_err} in {grad_leaf}")

    # phase 9: the kernels line (times summed over the main path's launches)
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
        "flash_per_shape": flash_rows, "flash_launches": flash_launches,
        "train_val_loss_per_epoch": losses,
        "card_vs_cpu": {"loss_card": loss_card, "loss_cpu": loss_cpu,
                        "loss_abs_diff": loss_err, "grad_rel": grad_err,
                        "grad_rel_leaf": grad_leaf},
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [kernel, *flash_kernel_rows(flash_rows, flash_launches)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
