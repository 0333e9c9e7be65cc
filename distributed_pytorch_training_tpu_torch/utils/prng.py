"""jax.random's key stream, reproduced in torch integer ops.

The continuous serving engine samples the token at absolute position q of
a request with ``categorical(fold_in(PRNGKey(seed), q), logits)``, as the
JAX package does. The key stream is integer arithmetic, so this module
computes it bit for bit: the default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on (jax 0.9's defaults; ``jax/_src/prng.py``
and ``jax/_src/random.py``).

* A key is a pair of uint32 words, here an int64 tensor ``(..., 2)`` that
  holds each word in [0, 2**32). Every sum is masked back to 32 bits.
* ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)`` with 64-bit types
  off: the seed is cut to its low 32 bits, and the key is ``[0, seed]``.
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)`` under the
  key: the two output words are the new key.
* ``random_bits(key, n)`` hashes the counters ``(0, i)`` for i < n and
  XORs the two output words (the partitionable layout).
* ``uniform`` keeps 23 bits as a float in [1, 2), subtracts 1, and clips
  at ``minval``; ``gumbel`` is ``-log(-log(u))`` over ``[tiny, 1)``
  (jax's ``mode="low"``); ``categorical`` is the Gumbel argmax.

The bits are bitwise jax's. The Gumbel noise goes through two logs, whose
last bit may differ between libraries; a token moves only where two
noisy logits fall within that bit of each other.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# float32's smallest normal number (numpy's finfo(float32).tiny)
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); every argument an int64 tensor of 32-bit
    words, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x[0], x[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds): ``[0, seed mod 2**32]``
    as an int64 tensor of shape (2,)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: keys (..., 2), data (...) of
    integers (cut to 32 bits) -> new keys (..., 2)."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & MASK32
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack((y1, y2), dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32) for each key of (..., 2):
    (..., n) int64 words."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(counts), counts)
    return y1 ^ y2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0
            ) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)`` for each key
    of (..., 2). For ``minval`` below float32's resolution at 1 (jax's
    Gumbel passes ``tiny``), ``maxval - minval`` rounds to 1 and the
    result is ``max(minval, f + minval)``, f in [0, 1) on a 2**-23 grid."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` (float32, mode "low") for each key
    of (..., 2)."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` for each key (rows, 2) and row
    of ``logits`` (rows, n): the Gumbel argmax, first index on ties."""
    noise = gumbel(keys, logits.shape[-1]).to(logits.dtype)
    return torch.argmax(noise + logits, dim=-1)
