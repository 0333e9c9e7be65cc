"""Which inputs the Hopper flash kernels read by TMA in place, and which
they stage first (``ops/flash_attention.py``: ``needs_staged_copy`` and
``_tma_operands``), on the CPU.

The forward (K3), dK/dV (K4) and dQ (K5), in bf16 and in float32, load
their tiles by TMA, through 4-D tensor maps over (D, H, S, B) built from
each tensor's own pointer and strides. TMA needs a 16-byte aligned start,
a stride of a multiple of 16 bytes on every axis longer than 1, and rows
of whole 16-byte chunks (D a multiple of 8 in bf16, of 4 in float32):
one rule for all six kernels. The model's q, k and v are views of one
fused (B, S, 3, H, D) projection
(``models/layers.py::MultiHeadAttention``); on every main path (GPT-2,
BERT, the ring's and Ulysses' blocks, a tensor-parallel rank's heads) they
must go to TMA with no copy. An unaligned view, an odd D or an odd stride
is copied first.
"""

import importlib
import types

import pytest
import torch

from distributed_pytorch_training_tpu_torch.models.layers import (
    MultiHeadAttention,
)
from distributed_pytorch_training_tpu_torch.parallel.collectives import TpAxis

fa = importlib.import_module(
    "distributed_pytorch_training_tpu_torch.ops.flash_attention")

# (B, S, H, D) of each main path's attention: GPT-2 124M at S 1024,
# BERT-base at S 512, the ring's block of S 1024 on 2 ranks, Ulysses'
# and a tensor-parallel rank's 6 of 12 heads
MAIN_PATHS = {"gpt2": (8, 1024, 12, 64), "bert": (8, 512, 12, 64),
              "ring": (8, 512, 12, 64), "ulysses": (8, 1024, 6, 64),
              "tp": (8, 1024, 6, 64)}


def fused_view(b, s, h, d):
    """Shape and element strides of q (or k, v) sliced from a contiguous
    fused (B, S, 3, H, D) projection."""
    return (b, s, h, d), (s * 3 * h * d, 3 * h * d, d, 1)


def contiguous(b, s, h, d):
    return (b, s, h, d), (s * h * d, h * d, d, 1)


@pytest.mark.parametrize("path", sorted(MAIN_PATHS))
def test_main_path_inputs_go_to_tma_in_place(path):
    """q, k, v as fused views and dO contiguous, at each main path's
    shape: no copy."""
    dims = MAIN_PATHS[path]
    for shape, strides in (fused_view(*dims), contiguous(*dims)):
        assert not fa.needs_staged_copy(shape, strides, 0, torch.bfloat16)


@pytest.mark.parametrize("tp", [1, 2], ids=["heads12", "tp2_heads6"])
def test_model_qkv_views_go_to_tma_in_place(tp):
    """The views the model itself makes: GPT-2's and BERT's attention (768
    wide, 12 heads of 64) and a tensor-parallel rank's, in bf16."""
    attn = MultiHeadAttention(768, 12, 64, tp=TpAxis(tp, 0),
                              dtype=torch.bfloat16)
    x = torch.zeros((2, 24, 768), dtype=torch.bfloat16)
    qkv = attn.qkv(x)
    assert qkv.shape == (2, 24, 3, 12 // tp, 64)
    for i in range(3):
        t = qkv[..., i, :, :]
        assert not t.is_contiguous()
        assert not fa.needs_staged_copy(tuple(t.shape), t.stride(),
                                        t.data_ptr() % 16, t.dtype)


def test_unaligned_view_is_staged():
    """A fused qkv that starts one element past a 16-byte boundary, as
    tests/test_torch_kernels.py's unaligned-view legs make it."""
    b, s, h, d = 2, 96, 4, 64
    flat = torch.zeros(b * s * 3 * h * d + 1, dtype=torch.bfloat16)
    qkv = flat[1:].view(b, s, 3, h, d)
    q = qkv[:, :, 0]
    assert q.data_ptr() % 16 == 2
    assert fa.needs_staged_copy(tuple(q.shape), q.stride(),
                                q.data_ptr() % 16, q.dtype)
    shape, strides = fused_view(b, s, h, d)
    for offset in (2, 4, 8, 14):
        assert fa.needs_staged_copy(shape, strides, offset, torch.bfloat16)


@pytest.mark.parametrize("d", [4, 20, 33, 100])
def test_head_dim_off_whole_chunks_is_staged(d):
    """D not a multiple of 8: a row is not whole 16-byte chunks."""
    for shape, strides in (fused_view(2, 100, 2, d), contiguous(2, 100, 2, d)):
        assert fa.needs_staged_copy(shape, strides, 0, torch.bfloat16)


@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 96, 128])
def test_head_dims_of_whole_chunks_go_in_place(d):
    shape, strides = fused_view(2, 100, 2, d)
    assert not fa.needs_staged_copy(shape, strides, 0, torch.bfloat16)


def test_stride_off_16_bytes_is_staged():
    """Every axis's stride counts: a batch stride of an odd number of
    elements (a view into a larger buffer) needs a copy."""
    shape = (2, 100, 2, 64)
    assert fa.needs_staged_copy(shape, (12801, 128, 64, 1), 0,
                                torch.bfloat16)
    assert fa.needs_staged_copy(shape, (12800, 132, 64, 1), 0,
                                torch.bfloat16)
    assert fa.needs_staged_copy(shape, (12800, 128, 68, 1), 0,
                                torch.bfloat16)


def test_stride_of_a_length_one_axis_is_ignored():
    """An axis of length 1 is never stepped, so its stride does not
    matter (PyTorch may give it any value)."""
    assert not fa.needs_staged_copy((1, 33, 1, 8), (7, 8, 3, 1), 0,
                                    torch.bfloat16)
    assert fa.needs_staged_copy((2, 33, 1, 8), (7, 8, 3, 1), 0,
                                torch.bfloat16)


def test_float32_forward_and_dq_stage_by_tma_rules():
    """float32 K3 and K5 read by TMA, as K4 does: D 7 (28-byte rows), an
    odd stride on any axis and a start off a 16-byte boundary are staged;
    the main paths' fused views and contiguous tensors, D 20 and strides
    of four elements are read in place."""
    for shape, strides in (contiguous(2, 100, 2, 7), fused_view(2, 100, 2, 7),
                           ((2, 100, 2, 64), (12801, 128, 64, 1)),
                           ((2, 100, 2, 64), (12800, 129, 64, 1)),
                           ((2, 100, 2, 64), (12800, 128, 65, 1))):
        assert fa.needs_staged_copy(shape, strides, 0, torch.float32)
    for offset in (4, 8, 12):
        assert fa.needs_staged_copy(*fused_view(*MAIN_PATHS["gpt2"]), offset,
                                    torch.float32)
    for dims in MAIN_PATHS.values():
        for shape, strides in (fused_view(*dims), contiguous(*dims)):
            assert not fa.needs_staged_copy(shape, strides, 0, torch.float32)
    for shape, strides in (contiguous(2, 100, 2, 20),
                           ((2, 100, 2, 20), (4004, 40, 20, 1))):
        assert not fa.needs_staged_copy(shape, strides, 0, torch.float32)


# (dtype, kernel) of the TMA readers beyond the bf16 forward, each held to
# the one rule: bf16 dQ and dK/dV, float32 dK/dV, forward and dQ
TMA_READERS = [(torch.bfloat16, "dq"), (torch.bfloat16, "dkv"),
               (torch.float32, "dkv"), (torch.float32, "fwd"),
               (torch.float32, "dq")]


def reader_id(reader):
    return f"{str(reader[0])[6:]}-{reader[1]}"


@pytest.mark.parametrize("reader", TMA_READERS, ids=reader_id)
@pytest.mark.parametrize("path", sorted(MAIN_PATHS))
def test_backward_main_path_inputs_go_to_tma_in_place(path, reader):
    """q, k, v as fused views and dO contiguous, at each main path's
    shape, for each reader: no copy."""
    dtype, _ = reader
    dims = MAIN_PATHS[path]
    for shape, strides in (fused_view(*dims), contiguous(*dims)):
        assert not fa.needs_staged_copy(shape, strides, 0, dtype)


@pytest.mark.parametrize("tp", [1, 2], ids=["heads12", "tp2_heads6"])
def test_model_qkv_views_go_to_float32_dkv_in_place(tp):
    """The model's own float32 views (GPT-2's, BERT's, a tensor-parallel
    rank's) reach the float32 kernels (K3, K4, K5) with no copy."""
    attn = MultiHeadAttention(768, 12, 64, tp=TpAxis(tp, 0),
                              dtype=torch.float32)
    qkv = attn.qkv(torch.zeros((2, 24, 768)))
    for i in range(3):
        t = qkv[..., i, :, :]
        assert not fa.needs_staged_copy(tuple(t.shape), t.stride(),
                                        t.data_ptr() % 16, t.dtype)


@pytest.mark.parametrize("reader", TMA_READERS, ids=reader_id)
def test_backward_unaligned_view_is_staged(reader):
    """A fused qkv one element off a 16-byte boundary: 2 bytes in bf16, 4
    in float32."""
    dtype, _ = reader
    b, s, h, d = 2, 96, 4, 64
    flat = torch.zeros(b * s * 3 * h * d + 1, dtype=dtype)
    q = flat[1:].view(b, s, 3, h, d)[:, :, 0]
    assert q.data_ptr() % 16 == q.element_size()
    assert fa.needs_staged_copy(tuple(q.shape), q.stride(),
                                q.data_ptr() % 16, dtype)
    shape, strides = fused_view(b, s, h, d)
    for offset in (4, 8, 12):
        assert fa.needs_staged_copy(shape, strides, offset, dtype)


@pytest.mark.parametrize("reader", TMA_READERS, ids=reader_id)
def test_backward_head_dim_off_whole_chunks_is_staged(reader):
    """D whose rows are not whole 16-byte chunks (not a multiple of 8 in
    bf16, of 4 in float32) is staged; whole chunks go in place."""
    dtype, _ = reader
    step = 16 // torch.empty((), dtype=dtype).element_size()
    for d in (1, 3, 5, 7, 9, 33, 94 if step == 8 else 95):
        for shape, strides in (fused_view(2, 40, 2, d),
                               contiguous(2, 40, 2, d)):
            assert fa.needs_staged_copy(shape, strides, 0, dtype)
    for d in range(step, 129, step):
        shape, strides = fused_view(2, 40, 2, d)
        assert not fa.needs_staged_copy(shape, strides, 0, dtype)


@pytest.mark.parametrize("reader", TMA_READERS, ids=reader_id)
def test_backward_stride_off_16_bytes_is_staged(reader):
    """Each axis's stride counts: one element past a multiple of 16 bytes
    on the batch, sequence or head axis needs a copy."""
    dtype, _ = reader
    shape = (2, 100, 2, 64)
    for strides in ((12801, 128, 64, 1), (12800, 129, 64, 1),
                    (12800, 128, 65, 1)):
        assert fa.needs_staged_copy(shape, strides, 0, dtype)
    assert not fa.needs_staged_copy(shape, (12800, 128, 64, 1), 0, dtype)


def test_float32_dkv_strides_of_four_elements_go_in_place():
    """16 bytes are 4 float32 elements: strides a multiple of 4 (not of
    8, as bf16 needs) are read in place."""
    shape = (2, 100, 2, 20)
    assert not fa.needs_staged_copy(shape, (4004, 40, 20, 1), 0,
                                    torch.float32)
    assert fa.needs_staged_copy(shape, (4004, 40, 20, 1), 0, torch.bfloat16)


def counter():
    return types.SimpleNamespace(staged_copies=0)


def test_tma_operands_pass_readable_tensors_through():
    """Aligned fused views go to the kernel as they are: no copy, none
    counted, D unchanged."""
    qkv = torch.randn((2, 40, 3, 4, 64)).to(torch.bfloat16)
    views = tuple(qkv[:, :, i] for i in range(3))
    wrapper = counter()
    out = fa._tma_operands(wrapper, views)
    assert wrapper.staged_copies == 0
    assert all(a is b for a, b in zip(out, views))


def test_tma_operands_copy_an_unaligned_view():
    """An unaligned view becomes an aligned contiguous copy of the same
    values, counted once per tensor copied."""
    b, s, h, d = 2, 40, 4, 64
    flat = torch.randn(b * s * 3 * h * d + 1).to(torch.bfloat16)
    qkv = flat[1:].view(b, s, 3, h, d)
    views = tuple(qkv[:, :, i] for i in range(3))
    wrapper = counter()
    out = fa._tma_operands(wrapper, views)
    assert wrapper.staged_copies == 3
    for got, want in zip(out, views):
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, want)
        assert not fa.needs_staged_copy(tuple(got.shape), got.stride(),
                                        got.data_ptr() % 16, got.dtype)


def test_tma_operands_pad_float32_dkv_to_four_columns():
    """float32 at D 6: every tensor copied to D 8, the new columns zero;
    an aligned float32 view needs no copy."""
    q, k, v, g = (torch.randn((2, 30, 2, 6)) for _ in range(4))
    wrapper = counter()
    out = fa._tma_operands(wrapper, (q, k, v, g))
    assert wrapper.staged_copies == 4
    for got, want in zip(out, (q, k, v, g)):
        assert got.shape == (2, 30, 2, 8)
        assert torch.equal(got[..., :6], want)
        assert not got[..., 6:].any()
    qkv = torch.randn((2, 40, 3, 4, 64))
    views = tuple(qkv[:, :, i] for i in range(3))
    wrapper = counter()
    assert all(a is b for a, b in zip(
        fa._tma_operands(wrapper, views), views))
    assert wrapper.staged_copies == 0


def test_tma_operands_pad_an_odd_head_dim_with_zeros():
    """D 20: every tensor is copied to D 24, the 4 new columns zero, which
    adds nothing to any product."""
    q, k, v, g = (torch.randn((2, 30, 2, 20)).to(torch.bfloat16)
                  for _ in range(4))
    wrapper = counter()
    out = fa._tma_operands(wrapper, (q, k, v, g))
    assert wrapper.staged_copies == 4
    for got, want in zip(out, (q, k, v, g)):
        assert got.shape == (2, 30, 2, 24)
        assert torch.equal(got[..., :20], want)
        assert not got[..., 20:].any()
