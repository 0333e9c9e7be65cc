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
  XORs the two output words (the partitionable layout). The counter of
  element i of a draw of any shape is its flat index i (high word, low
  word), so ``offset`` draws a block of a larger draw without the rest:
  a rank's rows of a draw over the global batch.
* ``split(key, num)`` hashes the counters ``(0, i)`` for i < num and keeps
  both words: key i is ``fold_in(key, i)``.
* ``uniform`` keeps 23 bits as a float in [1, 2), subtracts 1, and clips
  at ``minval``; ``bernoulli`` is ``uniform < p`` in float32; ``gumbel``
  is ``-log(-log(u))`` over ``[tiny, 1)`` (jax's ``mode="low"``);
  ``categorical`` is the Gumbel argmax.
* ``randint`` (int32) splits the key in two, draws a high and a low word
  for each element and reduces them into ``[minval, maxval)`` modulo the
  span, every product and sum wrapping at 32 bits as jax's uint32
  arithmetic does.

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


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys from one key (2,)."""
    return fold_in(key, torch.arange(num, device=key.device))


def random_bits(keys: torch.Tensor, n: int, offset: int = 0
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) for each key of (..., 2),
    elements ``offset .. offset + n - 1`` of the draw in flat (row-major)
    order: (..., n) int64 words."""
    counts = torch.arange(offset, offset + n, dtype=torch.int64,
                          device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          counts >> 32, counts & MASK32)
    return y1 ^ y2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, 1.0)`` for each key
    of (..., 2), elements ``offset ..`` as `random_bits` takes them. For
    ``minval`` below float32's resolution at 1 (jax's Gumbel passes
    ``tiny``), ``maxval - minval`` rounds to 1 and the result is
    ``max(minval, f + minval)``, f in [0, 1) on a 2**-23 grid."""
    bits = (random_bits(keys, n, offset) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, floats * span + lo)


def bernoulli(key: torch.Tensor, p: float, n: int, offset: int = 0
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (a float ``p``, float32):
    ``uniform < p``, elements ``offset ..`` as `random_bits` takes them;
    (n,) bool."""
    return uniform(key, n, offset=offset) < torch.tensor(
        p, dtype=torch.float32, device=key.device)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` modulo 2**32 for 32-bit words, in int64 without overflow
    (the 16-bit halves of ``b`` one at a time)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def randint(key: torch.Tensor, n: int, minval: int, maxval: int,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, scalar
    bounds inside int32), elements ``offset ..`` as `random_bits` takes
    them; (n,) int64 values. The span's arithmetic is jax's in uint32,
    wrapping: ``multiplier = (2**16 % span)**2 % span`` and
    ``(hi % span * multiplier + lo % span) % span``."""
    k1, k2 = split(key, 2)
    higher, lower = random_bits(k1, n, offset), random_bits(k2, n, offset)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    span_t = torch.tensor(span, dtype=torch.int64, device=key.device)
    mult_t = torch.tensor(mult, dtype=torch.int64, device=key.device)
    off = (_mul32(higher % span_t, mult_t) + lower % span_t) & MASK32
    return minval + off % span_t


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` (float32, mode "low") for each key
    of (..., 2)."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` for each key (rows, 2) and row
    of ``logits`` (rows, n): the Gumbel argmax, first index on ties."""
    noise = gumbel(keys, logits.shape[-1]).to(logits.dtype)
    return torch.argmax(noise + logits, dim=-1)
