"""PyTorch and CUDA port of ``distributed_pytorch_training_tpu`` for NVIDIA
Hopper (H100).

The JAX package beside this one is the reference; every subpackage and
module here keeps its counterpart's name. This package imports ``torch``
and numpy, never ``jax``, ``flax`` or the JAX package. Its entry points run
on ``cuda`` unless the caller passes ``device="cpu"`` (the tests do), and
raise when no CUDA device is present.

Ported so far: the serving path of GPT-2 (``serving smoke``), in fp32 and
with int8 weights, whose one kernel is the int8 row quantizer
(``ops/quantize.py``, ``csrc/quantize_int8_rows.cu``).
"""
