"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd_lse,
    make_flash_attention_fn,
)
from .quantize import quantize_int8_rows, quantize_int8_rows_ref

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_fwd_lse", "make_flash_attention_fn",
           "quantize_int8_rows", "quantize_int8_rows_ref"]
