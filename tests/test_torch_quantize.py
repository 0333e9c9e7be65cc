"""The PyTorch port's int8 row quantizer (ops/quantize.py of the port).

* The plain version ``quantize_int8_rows_ref`` is BITWISE equal, codes and
  scale bits, to the JAX reference ``grad_sync._quantize_int8_rows`` with
  ``fused=False``, over seeded shapes with zero rows and exact half-codes.
* The wrapper takes the plain version for a CPU tensor, counts only kernel
  launches, and refuses what the kernel does not take.
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
