"""Row-wise int8 quantization: the hand-written Hopper kernel and its plain
PyTorch version.

``quantize_int8_rows`` replaces the Pallas TPU kernel
``distributed_pytorch_training_tpu/ops/quantize.py::quantize_int8_rows_fused``
(body ``_quantize_kernel``). It is the one quantization grid of the system:
int8 served weights (``serving/engine.py::quantize_params``) use it today,
and the int8 gradient wire and int8 KV pages will.

* A tensor on the CPU takes the plain version, ``quantize_int8_rows_ref``.
* A tensor on a CUDA device launches the kernel
  (``csrc/quantize_int8_rows.cu``, built by ``ops/build.py``) or raises.
  There is no fallback from one to the other.

The kernel's design note and bound (memory: 4 B read and 1 B written per
element, 4 B written per row) sit in the CUDA source. Both versions are
bitwise equal to ``parallel/grad_sync.py::_quantize_int8_rows`` of the JAX
package with ``fused=False``, codes and scale bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

QMAX = 127.0
KERNEL = "quantize_int8_rows"


def quantize_int8_rows_ref(rows: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: one max-abs scale per row, int8 codes."""
    scales = rows.abs().amax(1).clamp(min=1e-30) * (1.0 / QMAX)
    q = (rows / scales[:, None]).round().clamp(-QMAX, QMAX).to(torch.int8)
    return q, scales


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, C launcher) of the kernel, built and bound once."""
    lib = build.load(KERNEL)
    fn = lib.dpt_quantize_int8_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(rows: torch.Tensor) -> None:
    if rows.dtype != torch.float32:
        raise TypeError(f"{KERNEL} takes float32 rows, got {rows.dtype}")
    if rows.dim() != 2:
        raise ValueError(f"{KERNEL} takes an (n, s) matrix, got shape "
                         f"{tuple(rows.shape)}")
    if rows.shape[1] == 0:
        raise ValueError(f"{KERNEL} needs non-empty rows, got shape "
                         f"{tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError(f"{KERNEL} takes a contiguous matrix")


def quantize_int8_rows(rows: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, s) float32 -> ((n, s) int8 codes, (n,) float32 scales).

    ``quantize_int8_rows.launches`` counts the kernel's launches; a CPU
    call runs the plain version and does not count."""
    _check(rows)
    if rows.device.type == "cpu":
        return quantize_int8_rows_ref(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {rows.device}")
    n, s = rows.shape
    q = torch.empty((n, s), dtype=torch.int8, device=rows.device)
    scales = torch.empty((n,), dtype=torch.float32, device=rows.device)
    if n == 0:
        return q, scales
    lib, fn = _launcher()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = fn(rows.data_ptr(), q.data_ptr(), scales.data_ptr(), n, s,
                  stream)
    build.check_launch(lib, KERNEL, code)
    quantize_int8_rows.launches += 1
    return q, scales


quantize_int8_rows.launches = 0
