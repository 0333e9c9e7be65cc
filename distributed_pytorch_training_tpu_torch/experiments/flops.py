"""FLOPs accounting, the card's peak, and MFU (the JAX package's
experiments/flops.py).

A samples/s claim that implies more FLOP/s than the card's peak is a
broken measurement: `check_mfu` fails loudly instead of reporting it.

``matmul_flops`` is the analytic matmul and convolution count of one
call (2 FLOPs per multiply-add), the counterpart of the JAX package's
``jaxpr_matmul_flops``: ``torch.utils.flop_counter.FlopCounterMode``
counts the matrix products and convolutions the call dispatches. It sees
what runs through PyTorch's operators, so count the plain path (the
flash kernels are ctypes calls, invisible to it); meta tensors count
without computing. A train step costs ~3x the forward (the backward
forms two products per forward product).

An MoE model (``gpt2_moe``) counts its expert products over all E C
capacity slots of every batch row, the work the card does, and its
router's product; the count equals JAX's at the same configuration. A
pipelined run (``--mesh pipe=P``) counts the sequential GPT-2 of the same
configuration: the model's products once. JAX's ``jaxpr_matmul_flops``
of its pipelined model walks the ``lax.scan`` of every stage's M + P - 1
ticks, fill and drain included, so its count is (M + P - 1) / M times
that per stage; the port's stages skip those ticks, and the MFU it
reports is the sequential model's work over the cards' peak.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

# Peak dense bf16 TFLOP/s per device, keyed by
# ``torch.cuda.get_device_name``: the H100 SXM's 989 (NVIDIA's data
# sheet, at its 700 W limit).
CHIP_PEAK_TFLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.0,
}

PEAK_ENV_VAR = "DPT_CHIP_PEAK_TFLOPS"


def chip_peak_tflops(device=None) -> Optional[float]:
    """Per-device peak dense bf16 TFLOP/s, or None when unknown (the CPU,
    a card the table does not list). ``DPT_CHIP_PEAK_TFLOPS`` overrides
    the lookup. ``device`` defaults to the current CUDA device."""
    override = os.environ.get(PEAK_ENV_VAR)
    if override:
        return float(override)
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return CHIP_PEAK_TFLOPS_BF16.get(torch.cuda.get_device_name(device))


def matmul_flops(fn, *args, **kwargs) -> float:
    """Analytic matmul and convolution FLOPs of ``fn(*args, **kwargs)``,
    counted as it runs."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


# -- MFU --------------------------------------------------------------------

def mfu_pct(flops_per_step: Optional[float], steps_per_sec: float,
            peak_tflops: Optional[float]) -> Optional[float]:
    if not flops_per_step or not peak_tflops:
        return None
    return 100.0 * flops_per_step * steps_per_sec / (peak_tflops * 1e12)


class MeasurementError(RuntimeError):
    """A benchmark number that cannot be true (e.g. implied FLOP/s > peak)."""


def check_mfu(mfu: Optional[float], context: str = "") -> Optional[str]:
    """Validate an MFU claim. Returns a warning string for suspicious-but-
    possible values; raises MeasurementError for impossible ones (>100% of
    the MXU peak means the timing or the FLOPs model is broken — the r2
    failure mode where 484 TFLOP/s was reported on a 197 TFLOP/s chip)."""
    if mfu is None:
        return None
    if mfu > 100.0:
        raise MeasurementError(
            f"measured MFU {mfu:.1f}% exceeds hardware peak ({context}); "
            "the timing harness or FLOPs model is broken — refusing to "
            "report an impossible number")
    if mfu > 60.0:
        return (f"MFU {mfu:.1f}% is above the ~60% typically achievable "
                f"({context}); verify the chip-peak table and timing")
    return None
