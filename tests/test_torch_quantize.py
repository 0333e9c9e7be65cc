"""The PyTorch port's int8 row quantizer (ops/quantize.py of the port).

* The plain version ``quantize_int8_rows_ref`` is BITWISE equal, codes and
  scale bits, to the JAX reference ``grad_sync._quantize_int8_rows`` with
  ``fused=False``, over seeded shapes with zero rows and exact half-codes.
* The wrapper takes the plain version for a CPU tensor, counts only kernel
  launches, and refuses what the kernel does not take.
* The kernel's tiling (``chunks_per_row``) spreads the int8 wires' long
  rows over every SM of an H100 and keeps one block a row where the rows
  alone fill it.
* The kernel legs live in test_torch_kernels.py (no JAX there: the card's
  machine has none).

No tolerance anywhere in this file: the quantization grid is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_training_tpu.parallel.grad_sync import (
    _quantize_int8_rows as jax_quantize_int8_rows,
)
from distributed_pytorch_training_tpu_torch.ops import build
from distributed_pytorch_training_tpu_torch.ops.quantize import (
    BLOCKS_PER_SM,
    MIN_CHUNK,
    chunks_per_row,
    quantize_int8_rows,
    quantize_int8_rows_ref,
)
from distributed_pytorch_training_tpu_torch.parallel.grad_sync import (
    _quantize_int8_rows,
)

SHAPES = [(3, 5), (37, 64), (8, 768), (1, 100_003), (768, 3072)]


def seeded_rows(shape, seed=0):
    """Normal rows with a spread of magnitudes, an all-zero row (when there
    are several rows) and, in the last row, values on exact half-codes:
    amax 127 gives a scale of exactly 1.0, so 0.5, 2.5, ... tie."""
    rng = np.random.RandomState(seed)
    n, s = shape
    x = (rng.randn(n, s) * rng.uniform(0.01, 10.0, (n, 1))).astype(np.float32)
    if n > 2:
        x[1] = 0.0
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5,
                       3.5, -3.5], np.float32)
    k = min(s, halves.size)
    x[-1, :k] = halves[:k]
    x[-1, k:] = np.clip(x[-1, k:], -127.0, 127.0)
    return x


def jax_codes(x):
    q, scales = jax_quantize_int8_rows(jnp.asarray(x), fused=False)
    return np.asarray(q), np.asarray(scales)


def assert_bitwise(q, scales, q_ref, scales_ref):
    assert q.dtype == np.int8 and q_ref.dtype == np.int8
    assert scales.dtype == np.float32 and scales_ref.dtype == np.float32
    np.testing.assert_array_equal(q, q_ref)
    np.testing.assert_array_equal(scales.view(np.uint32),
                                  scales_ref.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_bitwise_equals_jax_reference(shape):
    x = seeded_rows(shape)
    q, scales = quantize_int8_rows_ref(torch.from_numpy(x))
    assert_bitwise(q.numpy(), scales.numpy(), *jax_codes(x))


def test_half_codes_round_to_even():
    x = seeded_rows((3, 16))
    q, scales = quantize_int8_rows_ref(torch.from_numpy(x))
    assert scales[-1].item() == 1.0
    assert q[-1, :10].tolist() == [127, 0, 2, 2, 0, -2, 126, -126, 4, -4]


def test_zero_row_gets_the_floor_scale():
    x = np.zeros((2, 7), np.float32)
    q, scales = quantize_int8_rows_ref(torch.from_numpy(x))
    assert not q.any()
    floor = np.float32(1e-30) * np.float32(1.0 / 127.0)
    assert (scales.numpy() == floor).all()
    assert_bitwise(q.numpy(), scales.numpy(), *jax_codes(x))


def test_codec_entry_routes_through_the_wrapper():
    x = seeded_rows((5, 33), seed=3)
    q, scales = _quantize_int8_rows(torch.from_numpy(x))
    assert_bitwise(q.numpy(), scales.numpy(), *jax_codes(x))


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    before = quantize_int8_rows.launches
    x = torch.from_numpy(seeded_rows((4, 9), seed=1))
    q, scales = quantize_int8_rows(x)
    q_ref, scales_ref = quantize_int8_rows_ref(x)
    assert torch.equal(q, q_ref) and torch.equal(scales, scales_ref)
    assert quantize_int8_rows.launches == before


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(4, 4, dtype=torch.float64), TypeError),
    (torch.zeros(16), ValueError),
    (torch.zeros(4, 0), ValueError),
    (torch.zeros(4, 8).T, ValueError),
], ids=["float64", "1-D", "empty-rows", "non-contiguous"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        quantize_int8_rows(bad)


def test_build_targets_hopper_without_fast_math():
    cmd = build.nvcc_command("quantize_int8_rows",
                             build.BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in c or "ftz" in c for c in cmd)
    assert cmd[-1].endswith("csrc/quantize_int8_rows.cu")
    assert build.library_path("quantize_int8_rows").parent == build.BUILD_DIR


H100_SMS = 132


@pytest.mark.parametrize("shape", [
    (1, 11_181_642), (2, 5_590_821), (1, 5_590_821), (1, 6_553_600),
    (1, 4_628_042), (3, 1_000_003), (1, 4_000_037),
], ids=str)
def test_tiling_spreads_long_rows_over_the_card(shape):
    """The int8 wires' rows (one bucket, its multihop halves, DDP's 25 MB
    buckets) and long edge rows: every SM gets blocks, none of them a
    sliver."""
    n, s = shape
    chunks = chunks_per_row(n, s, H100_SMS)
    assert n * chunks >= H100_SMS
    assert n * chunks <= BLOCKS_PER_SM * H100_SMS + n
    assert s // chunks >= MIN_CHUNK


@pytest.mark.parametrize("shape", [
    (50257, 768), (512, 768), (27648, 64), (768, 3072), (3072, 768),
    (3, 5), (1, 1), (1, MIN_CHUNK + 1),
], ids=str)
def test_tiling_keeps_one_block_a_row_for_short_or_many_rows(shape):
    """The serving path's weight matrices fill the card with rows alone,
    and a row shorter than two chunks is not split: one launch."""
    assert chunks_per_row(*shape, H100_SMS) == 1
