"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd_lse,
    make_flash_attention_fn,
)
from .quantize import quantize_int8_rows, quantize_int8_rows_ref
from .ring_attention import (
    make_ring_attention_fn,
    ring_attention,
    ring_attention_sharded,
)
from .ulysses_attention import (
    make_ulysses_attention_fn,
    ulysses_attention,
    ulysses_attention_sharded,
)

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_fwd_lse", "make_flash_attention_fn",
           "make_ring_attention_fn", "make_ulysses_attention_fn",
           "quantize_int8_rows", "quantize_int8_rows_ref", "ring_attention",
           "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_sharded"]
