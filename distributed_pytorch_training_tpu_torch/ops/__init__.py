"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .quantize import quantize_int8_rows, quantize_int8_rows_ref

__all__ = ["quantize_int8_rows", "quantize_int8_rows_ref"]
