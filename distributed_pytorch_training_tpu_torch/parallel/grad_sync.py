"""Gradient-sync codecs. Only the int8 codec's quantizer is ported so far;
the bucketed reducer and the wires come with the data-parallel training
slice (ROADMAP.md, queue 1)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.quantize import quantize_int8_rows


def _quantize_int8_rows(rows: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric quantization of a (n, chunk) fp32 matrix: one
    fp32 max-abs scale per row, int8 codes. The single quantization grid
    every int8 path shares: ``max(amax, 1e-30) * (1/127)`` scales,
    round-half-even, clip to +-127."""
    return quantize_int8_rows(rows)
