"""Batched inference: the engine, its request queue and the CLI."""

from .batching import Request, RequestQueue, Result, drain, serve_forever
from .engine import (
    InferenceEngine,
    QuantizedLeaf,
    ServeConfig,
    dequantize_params,
    int8_weight_bytes,
    quantize_params,
)

__all__ = [
    "InferenceEngine", "QuantizedLeaf", "Request", "RequestQueue", "Result",
    "ServeConfig", "dequantize_params", "drain", "int8_weight_bytes",
    "quantize_params", "serve_forever",
]
