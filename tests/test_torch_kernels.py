"""The PyTorch port's CUDA kernels on the card (marker ``cuda``).

Each leg builds the kernel from csrc/, launches it on a CUDA tensor and
holds it against its plain PyTorch version on the same inputs: BITWISE for
the int8 codec, within FLASH_REL for flash attention.
Without a CUDA device every leg skips. This file imports no JAX, so it
runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py sets up the JAX CPU mesh.)
"""

import pytest
import torch

from distributed_pytorch_training_tpu_torch.ops.quantize import (
    N_STAGED,
    dequant_sum_rows,
    dequant_sum_rows_ref,
    quantize_int8_rows,
    quantize_int8_rows_ref,
)

# GPT-2 124M's int8 leaves as (rows, row width), the one-row int8 wire
# shape, and small edge shapes; then long rows split over many blocks: a
# width not a multiple of 4, the multihop hop-1 shape (row 1 starts 4 bytes
# past a 16-byte boundary) and three rows
SHAPES = [(50257, 768), (512, 768), (27648, 64), (768, 768), (768, 3072),
          (3072, 768), (1, 1_000_003), (3, 5), (37, 33), (1, 1),
          (1, 4_000_037), (2, 5_590_821), (3, 1_000_003)]


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
@pytest.mark.parametrize("width", [4_000_037, 11_181_642], ids=str)
def test_quantize_kernel_long_row_max_in_its_last_elements(cuda_device,
                                                           width):
    """The row's only maximum sits in the scalar tail or the last chunk's
    last float4: the split row must still find it."""
    x = torch.rand((1, width), device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(5))
    x[0, -2] = -40.0
    got = quantize_int8_rows(x)
    torch.cuda.synchronize()
    assert got[1].item() == pytest.approx(40.0 / 127.0)
    assert got[0][0, -2].item() == -127
    assert_bitwise(got, quantize_int8_rows_ref(x))


@pytest.mark.cuda
def test_quantize_kernel_long_zero_row_takes_the_floor_scale(cuda_device):
    x = torch.zeros((1, 4_000_037), device=cuda_device)
    got = quantize_int8_rows(x)
    torch.cuda.synchronize()
    assert not got[0].any()
    assert_bitwise(got, quantize_int8_rows_ref(x))


@pytest.mark.cuda
def test_quantize_kernel_unaligned_view_of_long_rows(cuda_device):
    """A contiguous view that starts one float past a 16-byte boundary:
    every row's head, body and code stores shift."""
    flat = rows_on((1, 2 * 2_000_003 + 1), cuda_device, seed=2).reshape(-1)
    x = flat[1:].view(2, 2_000_003)
    assert x.data_ptr() % 16 == 4
    got = quantize_int8_rows(x)
    torch.cuda.synchronize()
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


# ---------------------------------------------------------------------------
# K2: dequant-sum of int8 rows
# ---------------------------------------------------------------------------

# the int8 wires' shapes at a short width (2 ranks; 3 and 8 rows), s = 1,
# s not a multiple of 4, and one row; then the staged variant's tiles (4096
# columns at 2 rows): every s mod 16 across a tile boundary, n at 4, 8 =
# N_STAGED and N_STAGED + 1 (the generic variant), and ResNet-18's one
# int8 bucket
DEQUANT_SHAPES = [(2, 100_000), (2, 100_001), (3, 4099), (8, 777), (1, 5),
                  (2, 1), (2, 3)]
DEQUANT_SHAPES += [(2, 2 * 4096 + m) for m in range(16)]
DEQUANT_SHAPES += [(4, 3 * 2048 + 5), (N_STAGED, 3 * 1024 + 7),
                   (N_STAGED + 1, 3 * 1024 + 7), (2, 11_181_642)]


def codes_on(shape, device, seed=0):
    """Codes and scales as the wire makes them: K1 on normal rows."""
    return quantize_int8_rows(rows_on(shape, device, seed))


def assert_dequant_bitwise(q, s):
    """K2 on (q, s) is its plain version's bits, and counts one launch."""
    before = dequant_sum_rows.launches
    got = dequant_sum_rows(q, s)
    torch.cuda.synchronize()
    assert dequant_sum_rows.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (q.shape[1],)
    want = dequant_sum_rows_ref(q, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DEQUANT_SHAPES, ids=str)
def test_dequant_kernel_bitwise_equals_plain_version(cuda_device, shape):
    q, s = codes_on(shape, cuda_device)
    got = assert_dequant_bitwise(q, s)
    # and the card's plain version is the CPU's, bit for bit
    cpu = dequant_sum_rows(q.cpu(), s.cpu())
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.cuda
def test_dequant_kernel_zero_scales(cuda_device):
    q, _ = codes_on((3, 1001), cuda_device)
    got = dequant_sum_rows(q, torch.zeros(3, device=cuda_device))
    torch.cuda.synchronize()
    # 0 + (-k * 0) is +0.0 everywhere: every bit zero
    assert torch.equal(got.view(torch.int32),
                       torch.zeros(1001, dtype=torch.int32,
                                   device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_dequant_kernel_zero_scales_and_unaligned_rows(cuda_device, offset):
    """Views at every byte offset past a 16-byte boundary, over several
    tiles: the rows' heads sit off their copies' 16-byte boundaries, and
    the view ends with its storage, so the last tile's ragged tail is read
    from global memory, not copied past the storage."""
    width = 2 * 4096 + 5
    big, s = codes_on((2, width), cuda_device, seed=offset)
    flat = torch.empty(offset + 2 * width, dtype=torch.int8,
                       device=cuda_device)
    flat[offset:] = big.reshape(-1)
    view = flat[offset:].reshape(2, width)
    assert view.data_ptr() % 16 == offset % 16
    assert view.untyped_storage().nbytes() == offset + 2 * width
    assert_dequant_bitwise(view, s)
    # a view off a 4-byte boundary, with zero scales: every bit zero
    got = dequant_sum_rows(view, torch.zeros(2, device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32),
                       torch.zeros(width, dtype=torch.int32,
                                   device=cuda_device))


# ---------------------------------------------------------------------------
# flash attention: K3 (forward), K4 (dK, dV), K5 (dQ)
# ---------------------------------------------------------------------------

# Kernel against plain version, as max|diff| / max|plain| per output.
# float32: both sum in float32 in different orders (tiles vs full rows),
# and the kernels form each product as three TF32 products (3xTF32);
# 1e-4 of the output's scale is ~100x what either accounts for
# at these sizes, and a wrong mask or index moves whole rows by O(1). bfloat16:
# both round their float32 results to bfloat16 (8 bits of mantissa), so an
# element may differ by one bfloat16 step, 2**-8 to 2**-7 of its magnitude;
# the bf16 forward, dK/dV and dQ also round P and dS to bf16 before their
# second product, ~2e-3 of the output's scale (test_torch_bf16_mma.py).
FLASH_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# (B, Sq, Sk, H, D, causal, masked): the main path's heads at short length,
# ragged tails, Sq != Sk both ways, D of 128, 48, 8 and 20 (not a multiple
# of 8; in bfloat16 its rows are not whole 16-byte chunks), alone, with key
# padding and with Sq > Sk, and causal lengths of 384 whose tiles lie below
# the diagonal as well as on it, square and with key padding and Sq < Sk;
# last, BERT-base's bidirectional attention at its full shape (S 512, 12
# heads of 64, batch 8)
FLASH_CASES = [
    (2, 128, 128, 3, 64, True, False),
    (2, 128, 128, 3, 64, False, False),
    (2, 100, 100, 2, 64, True, False),
    (2, 70, 130, 2, 32, False, True),
    (2, 96, 96, 2, 64, True, True),
    (1, 64, 200, 2, 128, True, False),
    (1, 200, 64, 2, 48, True, False),
    (3, 33, 17, 1, 8, False, True),
    (2, 100, 100, 2, 20, True, False),
    (1, 384, 384, 2, 64, True, False),
    (2, 100, 100, 2, 20, False, True),
    (2, 130, 70, 2, 20, True, False),
    (2, 320, 384, 3, 64, True, True),
    (8, 512, 512, 12, 64, False, False),
]


def flash_inputs(b, sq, sk, h, d, masked, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    q, k, v, do = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d), \
        rnd(b, sq, h, d)
    kv = None
    if masked:
        kv = (torch.rand((b, sk), generator=g, device=device) > 0.3).float()
        kv[0] = 0.0        # batch row 0: every key masked
    return q, k, v, do, kv


def live_rows(sq, sk, causal, kv, b, device):
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep = keep.tril()
    if kv is None:
        return keep.any(-1).expand(b, sq)
    return (keep[None] & (kv[:, None, :] > 0)).any(-1)


def rel_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)
            ).item()


def flash_module():
    import importlib

    return importlib.import_module(
        "distributed_pytorch_training_tpu_torch.ops.flash_attention")


def staged(fa):
    """The TMA kernels' staged copies so far: forward, dK/dV, dQ."""
    return (fa.flash_attention_fwd_lse.staged_copies,
            fa.flash_attention_bwd_dkv.staged_copies,
            fa.flash_attention_bwd_dq.staged_copies)


def check_flash_case(case, dtype, device, masked_prefix=0):
    """K3-K5 against their plain versions on one case, within FLASH_REL;
    ``masked_prefix``: also mask batch row 1's first keys. Every kernel
    reads contiguous inputs by TMA in place, and copies them first only
    when D is not a whole number of 16-byte chunks (q, k, v; and dO in the
    backward)."""
    fa = flash_module()
    b, sq, sk, h, d, causal, masked = case
    q, k, v, do, kv = flash_inputs(b, sq, sk, h, d, masked, dtype, device)
    if masked_prefix:
        kv[1, :masked_prefix] = 0.0
    live = live_rows(sq, sk, causal, kv, b, device)     # (B, Sq)
    do = do * live[:, :, None, None].to(dtype)   # dead rows: zero weight
    before = (fa.flash_attention_fwd_lse.launches,
              fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    staged_before = staged(fa)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal, None, kv)
    out_r, lse_r = fa.flash_attention_fwd_lse_ref(q, k, v, causal, None, kv)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                        None, kv)
    dq_r, dk_r, dv_r = fa.flash_attention_bwd_ref(q, k, v, out_r, lse_r, do,
                                                  causal, None, kv)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd_lse.launches,
            fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == tuple(
                n + 1 for n in before)
    step = 8 if dtype == torch.bfloat16 else 4    # elements in 16 bytes
    copies = (3, 4, 4) if d % step else (0, 0, 0)
    assert tuple(n - m for n, m in zip(staged(fa), staged_before)) == copies
    assert out.dtype == dtype and dq.dtype == dtype
    tol = FLASH_REL[dtype]
    assert rel_err(out[live], out_r[live]) <= tol
    lse_rows = lse.reshape(b, h, sq).transpose(1, 2)[live]
    lse_rows_r = lse_r.reshape(b, h, sq).transpose(1, 2)[live]
    assert rel_err(lse_rows, lse_rows_r) <= FLASH_REL[torch.float32]
    for got, want in ((dq[live], dq_r[live]), (dk, dk_r), (dv, dv_r)):
        assert rel_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernels_match_plain_versions(cuda_device, case, dtype):
    check_flash_case(case, dtype, cuda_device)


# What the bf16 forward's and dK/dV's TMA loads fill with zeros, against
# the plain versions within FLASH_REL: D below (32) and past (96) a
# 64-column box, ragged tails of Sq and Sk on both sides of their 128-row
# tiles (non-causal), and rows whose keys are all masked (batch row 0's,
# and batch row 1's first 100 under causal) in a 128-row q tile that also
# holds live rows (the live rows are compared; the others emit a
# tile-dependent mean of V and carry no weight)
TMA_CASES = [
    (2, 512, 512, 4, 32, True, False),
    (2, 512, 512, 4, 96, True, False),
    (2, 200, 333, 3, 64, False, False),
    (2, 200, 200, 3, 64, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TMA_CASES, ids=str)
def test_flash_bf16_tma_edges_match_plain_versions(cuda_device, case):
    """K3, K4 and K5 in bf16, all three read by TMA."""
    check_flash_case(case, torch.bfloat16, cuda_device,
                     masked_prefix=100 if case[-1] else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TMA_CASES, ids=str)
def test_flash_fp32_tma_edges_match_plain_versions(cuda_device, case):
    """The same edges in float32, whose three kernels read by TMA too: D
    32 (its second 32-column box all zero fill), D 96 (the D-128 tiles),
    ragged Sq and Sk on both sides of the tiles, and all-masked rows
    straddling a tile; no copy staged (D is a multiple of 4)."""
    check_flash_case(case, torch.float32, cuda_device,
                     masked_prefix=100 if case[-1] else 0)


# An all-masked row against mean(V) over its real keys, absolute. float32:
# the kernel's sum of P V in float32, ~1e-7 of the mean's O(0.1) size.
# bfloat16: the mean of the bf16 values, written in bf16, is half a bf16
# step of it away from the float32 mean (2**-9 of a value below 1); a
# wrong mask moves it by O(0.1).
MEAN_V_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_flash_all_masked_rows_emit_mean_v(cuda_device, dtype):
    """NEG_INF masking on the card: without causal an all-masked row is
    mean(V) over the real keys only (the ragged tail is not averaged in)."""
    from distributed_pytorch_training_tpu_torch.ops import (
        flash_attention_fwd_lse,
    )

    q, k, v, _, kv = flash_inputs(2, 40, 100, 2, 64, True, dtype,
                                  cuda_device)
    out, lse = flash_attention_fwd_lse(q, k, v, False, None, kv)
    torch.cuda.synchronize()
    want = v[0].float().mean(0).expand(40, 2, 64)
    assert (out[0].float() - want).abs().max().item() <= MEAN_V_ATOL[dtype]
    assert (lse[:2] == torch.finfo(torch.float32).min).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_flash_reads_strided_qkv_views(cuda_device, dtype):
    """q, k, v as views of one fused (B, S, 3, H, D) tensor, as the model
    passes them: no copy, same result as contiguous inputs."""
    from distributed_pytorch_training_tpu_torch.ops import flash_attention

    qkv = torch.randn((2, 96, 3, 4, 64), device=cuda_device).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    fa = flash_module()
    before = staged(fa)
    got = flash_attention(q, k, v, True)
    assert staged(fa) == before          # read in place, as the model's
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_flash_reads_unaligned_qkv_views(cuda_device, dtype):
    """The unaligned twin of the test above: every row of the fused qkv
    starts one element off a 16-byte boundary, so the forward copies q, k
    and v before its TMA loads; same result as contiguous inputs."""
    from distributed_pytorch_training_tpu_torch.ops import flash_attention

    b, s, h, d = 2, 96, 4, 64
    flat = torch.randn(b * s * 3 * h * d + 1, device=cuda_device).to(dtype)
    qkv = flat[1:].view(b, s, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert q.data_ptr() % 16 != 0
    fa = flash_module()
    before = staged(fa)
    got = flash_attention(q, k, v, True)
    assert staged(fa) == (before[0] + 3, before[1], before[2])
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_flash_backward_reads_strided_qkv_views(cuda_device, offset, dtype):
    """The backward through q, k, v as views of one fused (B, S, 3, H, D)
    tensor, as the model passes them, within FLASH_REL of contiguous
    inputs; ``offset`` 1 starts every row off a 16-byte boundary, which
    every kernel copies before its TMA loads."""
    from distributed_pytorch_training_tpu_torch.ops import flash_attention

    b, s, h, d = 2, 160, 4, 64
    g = torch.Generator(device=cuda_device).manual_seed(3)
    flat = torch.randn(b * s * 3 * h * d + offset, generator=g,
                       device=cuda_device).to(dtype)
    qkv = flat[offset:].view(b, s, 3, h, d)
    do = torch.randn((b, s, h, d), generator=g,
                     device=cuda_device).to(dtype)
    views = [qkv[:, :, i].detach().requires_grad_(True) for i in range(3)]
    assert not views[0].is_contiguous()
    assert (views[0].data_ptr() % 16 != 0) == bool(offset)
    fa = flash_module()
    before = staged(fa)
    flash_attention(*views, True).backward(do)
    # at offset 1 every kernel copies q, k and v (dO is aligned); aligned
    # views are read in place
    copies = 3 if offset else 0
    assert staged(fa) == tuple(n + copies for n in before)
    dense = [t.detach().contiguous().requires_grad_(True) for t in views]
    flash_attention(*dense, True).backward(do)
    torch.cuda.synchronize()
    for got, want in zip(views, dense):
        assert rel_err(got.grad, want.grad) <= FLASH_REL[dtype]


# ---------------------------------------------------------------------------
# K6: the ring (K3-K5 around the ring) and Ulysses, every shard in one
# process (an AxisLoop: a loop stands in for the rotation)
# ---------------------------------------------------------------------------


def seq_parallel_case(op, causal, dtype, device, use_kernels, n=2):
    """(out, dq, dk, dv) of the ring or Ulysses over n shards of a seeded
    (2, 256, 4, 64) problem, and the kernels' launches it made."""
    import importlib

    fa = importlib.import_module(
        "distributed_pytorch_training_tpu_torch.ops.flash_attention")
    module = importlib.import_module(
        f"distributed_pytorch_training_tpu_torch.ops.{op}_attention")
    fn = getattr(module, f"{op}_attention")
    g = torch.Generator(device=device).manual_seed(5)
    q, k, v, do = (torch.randn((2, 256, 4, 64), generator=g,
                               device=device).to(dtype) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    before = [f.launches for f in kernels]
    out = fn(q, k, v, {"seq": n}, causal, use_kernels=use_kernels)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    return [out, *grads], [f.launches - b for f, b in zip(kernels, before)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("op", ["ring", "ulysses"])
def test_sequence_parallel_kernels_match_plain_versions(cuda_device, op,
                                                        causal, dtype):
    """The ring's ``_RingFlash`` against its plain ``_ring_body``, Ulysses'
    flash kernels against its plain ``_local_attention``, within
    FLASH_REL; the ring over 2 shards launches K3, K4 and K5 once a
    block it does not skip (3 causal, 4 full), Ulysses once a shard."""
    got, launches = seq_parallel_case(op, causal, dtype, cuda_device, True)
    want, plain = seq_parallel_case(op, causal, dtype, cuda_device, False)
    blocks = (3 if causal else 4) if op == "ring" else 2
    assert launches == [blocks] * 3 and plain == [0, 0, 0]
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert rel_err(a, b) <= FLASH_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_flash_kernels_on_a_tensor_parallel_ranks_heads(cuda_device, dtype):
    """K3-K5 at the shape one of 2 tensor-parallel ranks gives them on
    GPT-2 124M (B 8, S 1024, its 6 heads of 64), on the q, k and v views
    of a TP-local attention's qkv projection (the same views as at 12
    heads), against the plain attention within FLASH_REL; one launch
    each."""
    import importlib

    from distributed_pytorch_training_tpu_torch.models.layers import (
        MultiHeadAttention, causal_mask, dot_product_attention,
    )
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.parallel.collectives import (
        TpAxis,
    )

    fa = importlib.import_module(
        "distributed_pytorch_training_tpu_torch.ops.flash_attention")
    attn = MultiHeadAttention(768, 12, 64, tp=TpAxis(2, 1), dtype=dtype,
                              device=cuda_device)
    attn.qkv.reset_parameters(torch.Generator(device=cuda_device)
                              .manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((8, 1024, 768), generator=g, device=cuda_device)
    qkv = attn.qkv(x).detach()
    assert qkv.shape == (8, 1024, 3, 6, 64)
    q, k, v = (qkv[..., i, :, :].requires_grad_() for i in range(3))
    do = torch.randn((8, 1024, 6, 64), generator=g,
                     device=cuda_device).to(dtype)
    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    before = [f.launches for f in kernels]
    staged_before = staged(fa)
    out = make_flash_attention_fn(causal=True)(q, k, v, dtype=dtype)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kernels, before)] == [1, 1, 1]
    assert staged(fa) == staged_before   # the views go to TMA in place
    ref = dot_product_attention(q, k, v, causal_mask(1024, cuda_device),
                                dtype)
    ref_grads = torch.autograd.grad(ref, (q, k, v), do)
    for a, b in zip((out, *grads), (ref, *ref_grads)):
        assert a.dtype == dtype
        assert rel_err(a, b) <= FLASH_REL[dtype]
