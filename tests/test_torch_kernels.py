"""The PyTorch port's CUDA kernels on the card (marker ``cuda``).

Each leg builds the kernel from csrc/, launches it on a CUDA tensor and
holds it BITWISE against its plain PyTorch version on the same inputs.
Without a CUDA device every leg skips. This file imports no JAX, so it
runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up the JAX CPU mesh.)
"""

import pytest
import torch

from distributed_pytorch_training_tpu_torch.ops.quantize import (
    quantize_int8_rows,
    quantize_int8_rows_ref,
)

# GPT-2 124M's int8 leaves as (rows, row width), the one-row int8 wire
# shape, and small edge shapes
SHAPES = [(50257, 768), (512, 768), (27648, 64), (768, 768), (768, 3072),
          (3072, 768), (1, 1_000_003), (3, 5), (37, 33), (1, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the GPU only")
    return torch.device("cuda")


def rows_on(shape, device, seed=0):
    """Normal rows of spread magnitudes; row 0 all zero when there are
    several; the last row has amax 127 (scale exactly 1.0) and exact
    half-codes, which round to even."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, s = shape
    x = torch.randn(shape, generator=g, device=device)
    x *= torch.rand((n, 1), generator=g, device=device) * 10 + 0.01
    if n > 2:
        x[0] = 0.0
    halves = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5],
                          device=device)
    k = min(s, halves.numel())
    x[-1] = x[-1].clamp(-127.0, 127.0)
    x[-1, :k] = halves[:k]
    return x


def assert_bitwise(got, want):
    (q, s), (q_ref, s_ref) = got, want
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, q_ref)
    assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_kernel_bitwise_equals_plain_version(cuda_device, shape):
    x = rows_on(shape, cuda_device)
    before = quantize_int8_rows.launches
    got = quantize_int8_rows(x)
    torch.cuda.synchronize()
    assert quantize_int8_rows.launches == before + 1
    assert_bitwise(got, quantize_int8_rows_ref(x))


@pytest.mark.cuda
def test_quantize_kernel_half_codes_round_to_even(cuda_device):
    x = rows_on((2, 8), cuda_device)
    q, s = quantize_int8_rows(x)
    assert s[-1].item() == 1.0
    assert q[-1].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]


@pytest.mark.cuda
def test_quantize_kernel_empty_matrix_launches_nothing(cuda_device):
    before = quantize_int8_rows.launches
    q, s = quantize_int8_rows(torch.zeros((0, 16), device=cuda_device))
    assert q.shape == (0, 16) and s.shape == (0,)
    assert quantize_int8_rows.launches == before


@pytest.mark.cuda
def test_int8_engine_quantizes_through_the_kernel(cuda_device):
    from distributed_pytorch_training_tpu_torch.models import GPT2LMHead
    from distributed_pytorch_training_tpu_torch.serving import (
        InferenceEngine, QuantizedLeaf, ServeConfig,
    )

    model = GPT2LMHead(vocab_size=97, hidden_dim=64, depth=2, num_heads=2,
                       max_position=64)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    before = quantize_int8_rows.launches
    engine = InferenceEngine(
        model, ServeConfig(buckets=(8,), max_new_tokens=4,
                           serve_dtype="int8", quantize_min_elements=64),
        params, device=cuda_device)
    leaves = {n: v for n, v in engine._served.items()
              if isinstance(v, QuantizedLeaf)}
    assert quantize_int8_rows.launches - before == len(leaves) > 0
    for name, leaf in leaves.items():
        rows = params[name].detach().reshape(-1, params[name].shape[-1])
        q_ref, s_ref = quantize_int8_rows_ref(rows)
        assert torch.equal(leaf.q.cpu().reshape(q_ref.shape), q_ref)
        assert torch.equal(leaf.scale.cpu().reshape(-1).view(torch.int32),
                           s_ref.view(torch.int32))
