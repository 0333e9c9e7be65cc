"""Host-side data helpers: numpy mirrors of the JAX package's native/
runtime, as far as the LM and image data paths use it.

``permutation`` is the splitmix64 Fisher-Yates shuffle of the JAX package's
``native/__init__.py`` (its C++ ``dpt_permutation`` and the Python mirror
``_permutation_py``): the same seed gives the same permutation, bit for
bit, so both packages walk a dataset in the same order. ``gather_rows`` is
numpy row indexing with the native path's bounds check; ``chw_to_hwc_u8``
decodes planar CIFAR records into NHWC images.
"""

from __future__ import annotations

import numpy as np

_M64 = 2 ** 64 - 1


def _splitmix64_stream(seed: int, count: int) -> np.ndarray:
    """The first ``count`` outputs of splitmix64 seeded as the JAX
    package's shuffle seeds it, as uint64 (arithmetic wraps mod 2**64)."""
    state = np.uint64((seed ^ 0xDA3E39CB94B95BDB) & _M64)
    t = np.arange(1, count + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = state + t * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _mul_hi64(z: np.ndarray, m: np.ndarray) -> np.ndarray:
    """High 64 bits of z * m for uint64 z and m < 2**32 (Lemire's bounded
    draw): z = zh 2**32 + zl, so z m = zh m 2**32 + zl m, and no partial
    sum below overflows 64 bits."""
    lo32 = np.uint64(0xFFFFFFFF)
    zh, zl = z >> np.uint64(32), z & lo32
    return (zh * m + ((zl * m) >> np.uint64(32))) >> np.uint64(32)


def permutation(seed: int, n: int) -> np.ndarray:
    """Deterministic Fisher-Yates permutation of range(n), int64: for
    i = n-1 .. 1, swap i with j = hi64(splitmix64() * (i + 1))."""
    if n >= 2 ** 32:
        raise ValueError(f"permutation: n={n} must be < 2**32")
    if n < 2:
        return np.arange(n, dtype=np.int64)
    bounds = np.arange(n, 1, -1, dtype=np.uint64)          # i + 1
    js = _mul_hi64(_splitmix64_stream(seed, n - 1), bounds).tolist()
    out = list(range(n))
    for i, j in zip(range(n - 1, 0, -1), js):
        out[i], out[j] = out[j], out[i]
    return np.asarray(out, dtype=np.int64)


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Rows of ``src`` at ``idx``; an index outside [0, len(src)) raises
    (numpy would wrap a negative one)."""
    idx = np.asarray(idx, np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(
            f"gather_rows indices out of range [0, {len(src)}): "
            f"min={idx.min()}, max={idx.max()}")
    return np.ascontiguousarray(src)[idx]


def chw_to_hwc_u8(records: np.ndarray, c: int, h: int, w: int) -> np.ndarray:
    """(N, c*h*w) planar uint8 records -> (N, h, w, c) interleaved
    images (the CIFAR-10 pickle's record layout)."""
    records = np.ascontiguousarray(records, np.uint8)
    n = records.shape[0]
    return records.reshape(n, c, h, w).transpose(0, 2, 3, 1).copy()
