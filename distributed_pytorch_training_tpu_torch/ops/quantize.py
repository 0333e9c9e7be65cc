"""The int8 codec: two hand-written Hopper kernels and their plain PyTorch
versions.

* ``quantize_int8_rows`` (K1) replaces the Pallas TPU kernel
  ``distributed_pytorch_training_tpu/ops/quantize.py::quantize_int8_rows_fused``
  (body ``_quantize_kernel``). It is the one quantization grid of the
  system: int8 served weights (``serving/engine.py::quantize_params``) and
  the int8 gradient wires (``parallel/grad_sync.py``) use it.
* ``dequant_sum_rows`` (K2) replaces ``dequant_sum_rows_fused`` (body
  ``_dequant_sum_kernel``): the column sum of dequantized rows, the
  receive-side accumulate of the int8 gradient wires.

For both:

* a tensor on the CPU takes the plain version (``*_ref``);
* a tensor on a CUDA device launches the kernel (``csrc/<name>.cu``, built
  by ``ops/build.py``) or raises. There is no fallback from one to the
  other.

The kernels' design notes and bounds (memory, both) sit in the CUDA
sources. K1 and its plain version are bitwise equal to
``parallel/grad_sync.py::_quantize_int8_rows`` of the JAX package with
``fused=False``, codes and scale bits. K2 and its plain version are bitwise
equal to each other and to ``_dequant_sum_rows(fused=False)`` as the JAX
package runs it, inside a compiled step: there XLA turns the multiply and
the row sum into one chain of fused multiply-adds, rows 0..n-1 in order
(``fma_f32`` reproduces each step exactly on any device).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import build

QMAX = 127.0
KERNEL = "quantize_int8_rows"
DEQUANT_KERNEL = "dequant_sum_rows"
# K2 stages the n scales in 48 KB of static-sized shared memory
MAX_DEQUANT_ROWS = 12288
# K1 splits a row over blocks until the card holds this many blocks an SM,
# each taking at least MIN_CHUNK columns
BLOCKS_PER_SM = 4
MIN_CHUNK = 4096


def quantize_int8_rows_ref(rows: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: one max-abs scale per row, int8 codes."""
    scales = rows.abs().amax(1).clamp(min=1e-30) * (1.0 / QMAX)
    q = (rows / scales[:, None]).round().clamp(-QMAX, QMAX).to(torch.int8)
    return q, scales


def chunks_per_row(n: int, s: int, sms: int) -> int:
    """K1's tiling: the number of blocks each of n rows of s columns is
    split over on a card of ``sms`` SMs. 1 (one warp or block a row, one
    launch) when the rows alone fill the card; else enough chunks of at least
    MIN_CHUNK columns for BLOCKS_PER_SM blocks an SM (two launches). Every
    tiling gives the same bits."""
    want = -(-BLOCKS_PER_SM * sms // n)
    return max(1, min(want, s // MIN_CHUNK))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, asked once (K1 runs per int8 leaf at
    engine build, where the wrapper's own host time shows)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, C launcher) of the kernel, built and bound once."""
    lib = build.load(KERNEL)
    fn = lib.dpt_quantize_int8_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
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

    ``quantize_int8_rows.launches`` counts the kernel's calls, one a call
    however many CUDA launches its tiling takes (``chunks_per_row``); a
    CPU call runs the plain version and does not count."""
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
    chunks = chunks_per_row(n, s, _sm_count(rows.device))
    # per-block partial maxima of a split row (no zeroing: every slot is
    # written before it is read)
    partials = (torch.empty((n * chunks,), dtype=torch.float32,
                            device=rows.device) if chunks > 1 else None)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = fn(rows.data_ptr(), q.data_ptr(), scales.data_ptr(),
                  None if partials is None else partials.data_ptr(), n, s,
                  chunks, stream)
    build.check_launch(lib, KERNEL, code)
    quantize_int8_rows.launches += 1
    return q, scales


quantize_int8_rows.launches = 0


# ---------------------------------------------------------------------------
# K2: column sums of dequantized rows
# ---------------------------------------------------------------------------


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` in float32 with ONE rounding (IEEE ``fmaf``), for
    operands whose product is exact in float64 (an int8 code times a
    float32 scale: 8 + 24 bits). The sum is taken in float64, rounded to
    odd (TwoSum gives its rounding error; an inexact even result steps to
    its odd neighbour toward the exact value), then rounded once to
    float32: a float64 rounded to odd, with 29 bits to spare, rounds to
    float32 exactly as the exact value does."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.full_like(s, float("inf")).copysign(err)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def dequant_sum_rows_ref(q: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    """The plain version: ``acc = 0``, then ``acc = fmaf(q[i], scales[i],
    acc)`` for rows i = 0..n-1 in order (the kernel's order, and XLA's)."""
    acc = torch.zeros(q.shape[1], dtype=torch.float32, device=q.device)
    for i in range(q.shape[0]):
        acc = fma_f32(q[i], scales[i], acc)
    return acc


# K2's launch plan (csrc/dequant_sum_rows.cu keeps the same constants):
# the staged variant takes up to N_STAGED rows, in tiles of a multiple of
# 16 columns, at most MAX_TILE (4 columns x 4 groups x 256 threads) and
# about STAGE_BYTES of codes; a persistent grid of STAGED_BLOCKS_PER_SM
# blocks an SM walks them through a ring of 4 stages. More rows take the
# generic variant.
N_STAGED = 8
MAX_TILE = 4096
STAGE_BYTES = 8192
STAGED_BLOCKS_PER_SM = 4
DEQUANT_THREADS = 256
GENERIC_BLOCKS_PER_SM = 8


class DequantPlan(NamedTuple):
    """K2's launch: the staged variant (``tile`` columns a tile, ``blocks``
    persistent blocks walking tiles b, b + blocks, ...) or the generic one
    (``tile`` 0, ``blocks`` grid-striding over 4-column groups)."""
    staged: bool
    tile: int
    blocks: int


def dequant_plan(n: int, s: int, sms: int) -> DequantPlan:
    """K2's variant, tile and grid for n rows of s columns on a card of
    ``sms`` SMs. Staged (n <= N_STAGED): tiles of STAGE_BYTES // n
    columns or fewer and, past one wave of blocks, as many tiles as blocks
    times waves, so every block walks as many; the tile then shrunk to
    split s evenly, a multiple of 16. A launch of one tile or less runs one
    block."""
    if n > N_STAGED:
        groups = -(-s // 4)
        return DequantPlan(False, 0, max(1, min(
            -(-groups // DEQUANT_THREADS), GENERIC_BLOCKS_PER_SM * sms)))
    widest = min(MAX_TILE, STAGE_BYTES // n // 16 * 16)
    cap = STAGED_BLOCKS_PER_SM * sms
    tiles = -(-s // widest)
    if tiles > cap:
        tiles = -(-tiles // cap) * cap
    tile = (-(-s // tiles) + 15) // 16 * 16
    return DequantPlan(True, tile, min(-(-s // tile), cap))


def staged_span(p: int, w: int, lo: int, hi: int) -> Tuple[int, int, int]:
    """(a, c_lo, c_hi): the staged variant's bulk copy of a row's w codes
    at address p, q's storage being [lo, hi). [a, b) is the span widened
    out to 16-byte boundaries; [c_lo, c_hi) is it clipped to the storage's
    16-byte-aligned part, the bytes copied (none when c_lo >= c_hi), landing
    at offset c_lo - a of the row's slot, so code p + j sits at slot offset
    (p & 15) + j. The kernel's ``staged_span``."""
    a = p & ~15
    b = (p + w + 15) & ~15
    return a, max(a, (lo + 15) & ~15), min(b, hi & ~15)


def ragged_codes(p: int, w: int, span: Tuple[int, int, int]
                 ) -> Tuple[range, range]:
    """The addresses of a row's codes that its copy ``span`` does not
    reach: a head at the storage's start and a tail at its end, at most 15
    each, which the kernel's ``stage_ragged`` reads from global memory into
    the row's slot (lanes 0-15 and 16-31 of the row's warp)."""
    _, c_lo, c_hi = span
    end = p + w
    return range(p, min(c_lo, end)), range(max(c_hi, c_lo, p), end)


_dequant_plan = functools.lru_cache(maxsize=4096)(dequant_plan)


@functools.lru_cache(maxsize=None)
def _dequant_launcher():
    """(library, C launcher) of K2, built and bound once."""
    lib = build.load(DEQUANT_KERNEL)
    fn = lib.dpt_dequant_sum_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_dequant(q: torch.Tensor, scales: torch.Tensor) -> None:
    name = DEQUANT_KERNEL
    if q.dtype is not torch.int8 or scales.dtype is not torch.float32:
        raise TypeError(f"{name} takes int8 codes and float32 scales, got "
                        f"{q.dtype} and {scales.dtype}")
    shape = q.shape
    if len(shape) != 2 or scales.shape != shape[:1]:
        raise ValueError(f"{name} takes (n, s) codes and (n,) scales, got "
                         f"{tuple(shape)} and {tuple(scales.shape)}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if q.device != scales.device:
        raise ValueError(f"{name}: codes on {q.device}, scales on "
                         f"{scales.device}")
    if shape[0] > MAX_DEQUANT_ROWS:
        raise ValueError(f"{name} takes at most {MAX_DEQUANT_ROWS} rows, "
                         f"got {shape[0]}")


def dequant_sum_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(n, s) int8 codes x (n,) float32 scales -> (s,) float32 column sums
    of the dequantized rows.

    ``dequant_sum_rows.launches`` counts the kernel's launches; a CPU call
    runs the plain version and does not count. The variant, tile and grid
    come from ``dequant_plan``; the device is switched only when q is not
    on the current one."""
    _check_dequant(q, scales)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return dequant_sum_rows_ref(q, scales)
        raise ValueError(f"{DEQUANT_KERNEL}: no kernel for device "
                         f"{q.device}")
    n, s = q.shape
    if n == 0 or s == 0:
        return torch.zeros((s,), dtype=torch.float32, device=q.device)
    out = q.new_empty((s,), dtype=torch.float32)
    lib, fn = _dequant_launcher()
    index = q.get_device()
    plan = _dequant_plan(n, s, _sm_count(index))
    # q's storage, which the staged variant's copies stay inside
    lo = q.data_ptr() - q.storage_offset()
    args = (q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, s,
            plan.staged, plan.tile, plan.blocks, lo,
            lo + q.untyped_storage().nbytes())
    # the device's current stream as a raw handle (no Stream object)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            code = fn(*args, stream)
    build.check_launch(lib, DEQUANT_KERNEL, code)
    dequant_sum_rows.launches += 1
    return out


dequant_sum_rows.launches = 0
