"""FlashAttention-2 forward and backward: three hand-written Hopper kernels
and their plain PyTorch versions.

The kernels (built by ``ops/build.py``: for bfloat16 inputs in
``csrc/flash_attention_sm90.cu``, for float32 in
``csrc/flash_attention_sm90_tf32.cu``) replace the Pallas TPU kernels of
the JAX package's ``ops/flash_attention.py``:

* ``flash_attention_fwd_lse`` (K3) <- ``_flash_fwd_lse`` / ``_fwd_kernel``;
* ``flash_attention_bwd_dkv`` (K4) <- ``_flash_bwd`` / ``_bwd_dkv_kernel``;
* ``flash_attention_bwd_dq`` (K5) <- ``_flash_bwd`` / ``_bwd_dq_kernel``.

A tensor on the CPU takes the plain version; a tensor on a CUDA device
launches the kernel or raises. Each kernel wrapper counts its launches in
``<wrapper>.launches``; a CPU call does not count.

Every kernel reads its inputs by TMA, which needs each tensor 16-byte
aligned with 16-byte strides and rows of whole 16-byte chunks, D a
multiple of 8 in bf16 and of 4 in float32 (``needs_staged_copy``). The C
launchers refuse, before launching, an input that is not, such as an
unaligned view or an odd head width; the wrapper then copies the inputs
the predicate names (D zero-padded to the multiple, which is exact) and
launches on the copies.
``<wrapper>.staged_copies`` counts those copies. The model's fused qkv
views never need one, and the check costs them no host time.

Semantics kept from the JAX module (the tests pin each one): masked logits
are the float32 minimum (``NEG_INF``), so a row whose keys are all masked
emits mean(V) instead of NaN; causal alignment is top-left (``row >= col``
from index 0, also when Sq != Sk); the forward scales q before the dot and
the backward scales the dot; the backward re-masks, so no gradient leaks
into masked keys through a normal row. Unlike the JAX module, the port's
kernels mask a ragged last tile (keys past Sk do not exist, even for an
all-masked row), so every length is supported and there are no block-size
arguments. ``delta = rowsum(dO * O)`` is plain PyTorch between the kernels,
as the JAX module computes it outside its kernels.

Shapes follow the JAX module: q, k, v (B, S, H, D), lse (B*H, 1, Sq).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import build

NEG_INF = float(np.finfo(np.float32).min)
LIBRARY_SM90 = "flash_attention_sm90"     # bf16 forward, dK/dV and dQ
LIBRARY_SM90_TF32 = "flash_attention_sm90_tf32"   # float32 ones
LIBRARIES = (LIBRARY_SM90, LIBRARY_SM90_TF32)
# cudaErrorMisalignedAddress: the libraries' launchers return it,
# without launching, for an input that TMA cannot read in place
_NOT_TMA_READABLE = 716
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)


def flash_backend_supported(device_type: Optional[str] = None) -> bool:
    """Whether the flash kernels run on this device type: ``cuda`` (the
    JAX module's answer is the TPU). ``None`` asks for the default device,
    which is CUDA when present."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return device_type == "cuda"


def flash_supports_length(s: int) -> bool:
    """True for every length: the port's kernels mask a ragged tail."""
    return s > 0


# ---------------------------------------------------------------------------
# plain versions (full score matrices)
# ---------------------------------------------------------------------------


def _masked_scores(s: torch.Tensor, causal: bool,
                   kv_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, Sq, Sk) logits with NEG_INF where causal (top-left) or
    kv_valid masks the key."""
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, NEG_INF)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, :] > 0, s, NEG_INF)
    return s


def _scale_of(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_fwd_lse_ref(q, k, v, causal: bool,
                                sm_scale: Optional[float] = None,
                                kv_valid: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: full-matrix softmax in float32. Returns
    (out (B, Sq, H, D) in q's dtype, lse (B*H, 1, Sq) float32)."""
    b, sq, h, _ = q.shape
    scale = _scale_of(q, sm_scale)
    s = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    s = _masked_scores(s, causal, kv_valid)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhst,bthd->bshd", p, v.float()) \
        / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).reshape(b * h, 1, sq)
    return out.to(q.dtype), lse


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) as (B*H, 1, Sq) float32, lse's layout."""
    b, sq, h, _ = out.shape
    d = (g.float() * out.float()).sum(-1)           # (B, Sq, H)
    return d.permute(0, 2, 1).reshape(b * h, 1, sq).contiguous()


def _bwd_terms(q, k, v, g, lse, delta, causal, scale, kv_valid):
    """p and dS (B, H, Sq, Sk) of the backward, the K4/K5 formulas on full
    matrices: s = scale * q.k, p = exp(s - lse),
    dS = p * (dO.v - delta) * scale."""
    b, sq, h, _ = q.shape
    s = scale * torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    s = _masked_scores(s, causal, kv_valid)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = torch.einsum("bshd,bthd->bhst", g.float(), v.float())
    ds = p * (dp - delta.reshape(b, h, sq, 1)) * scale
    return p, ds


def flash_attention_bwd_dkv_ref(q, k, v, g, lse, delta, causal: bool,
                                sm_scale: Optional[float] = None,
                                kv_valid: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 on full matrices: (dk, dv) in k's dtype."""
    p, ds = _bwd_terms(q, k, v, g, lse, delta, causal, _scale_of(q, sm_scale),
                       kv_valid)
    return (torch.einsum("bhst,bshd->bthd", ds, q.float()).to(k.dtype),
            torch.einsum("bhst,bshd->bthd", p, g.float()).to(v.dtype))


def flash_attention_bwd_dq_ref(q, k, v, g, lse, delta, causal: bool,
                               sm_scale: Optional[float] = None,
                               kv_valid: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version of K5 on full matrices: dq in q's dtype."""
    _, ds = _bwd_terms(q, k, v, g, lse, delta, causal, _scale_of(q, sm_scale),
                       kv_valid)
    return torch.einsum("bhst,bthd->bshd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, g, causal: bool,
                            sm_scale: Optional[float] = None,
                            kv_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of K4 and K5 on full matrices: (dq, dk, dv) in the
    dtypes of q, k, v."""
    delta = _delta(out, g)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, g, lse, delta, causal,
                                         sm_scale, kv_valid)
    dq = flash_attention_bwd_dq_ref(q, k, v, g, lse, delta, causal, sm_scale,
                                    kv_valid)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launchers():
    """{(kernel, bf16): (library, C launcher)}, built and bound once. Each
    library exports the three entry points for its own dtype."""
    build.build_all(LIBRARIES)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [i] * 5 + [ll] * 9 + [ctypes.c_float, i, i, p]
    entries = {"fwd": ("dpt_flash_fwd", 6), "dkv": ("dpt_flash_bwd_dkv", 9),
               "dq": ("dpt_flash_bwd_dq", 8)}
    out = {}
    for name, (entry, n_ptrs) in entries.items():
        for bf16 in (False, True):
            lib = build.load(LIBRARY_SM90 if bf16 else LIBRARY_SM90_TF32)
            fn = getattr(lib, entry)
            fn.argtypes = [p] * n_ptrs + shape
            fn.restype = ctypes.c_int
            out[name, bf16] = (lib, fn)
    return out


def _tma_elements(dtype) -> int:
    """Elements of ``dtype`` in 16 bytes, the unit of TMA's rules."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def needs_staged_copy(shape, strides, offset16: int, dtype) -> bool:
    """Whether a (B, S, H, D) tensor of ``shape`` and element ``strides``,
    starting ``offset16`` bytes past a 16-byte boundary, must be copied
    before a kernel (any of the three, either dtype) can read it by TMA:
    TMA needs a 16-byte aligned start, 16-byte strides on every axis longer
    than 1 and rows of whole 16-byte chunks (D a multiple of 8 in bf16, of
    4 in float32)."""
    n = _tma_elements(dtype)
    b, s, h, d = shape
    sb, ss, sh = strides[:3]
    return bool(offset16 % 16 or d % n or (b > 1 and sb % n)
                or (s > 1 and ss % n) or (h > 1 and sh % n))


def _tma_operands(wrapper, tensors):
    """A kernel's operands, once its launcher has refused one: each
    tensor as it is when TMA reads it in place (``needs_staged_copy``),
    else a contiguous copy, and when D is not a whole number of 16-byte
    chunks every one copied with D zero-padded to the next (a zero column
    adds nothing to any product). Counts the copies on
    ``wrapper.staged_copies``."""
    d = tensors[0].shape[-1]
    n = _tma_elements(tensors[0].dtype)
    dp = -(-d // n) * n
    out = []
    for t in tensors:
        if needs_staged_copy(t.shape, t.stride(), t.data_ptr() % 16,
                             t.dtype):
            staged = t.new_zeros((*t.shape[:-1], dp))
            staged[..., :d] = t
            out.append(staged)
            wrapper.staged_copies += 1
        else:
            out.append(t)
    return out


def _check(name: str, q, k, v, kv_valid) -> None:
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.dim() != 4:
            raise ValueError(f"{name}: {what} must be (B, S, H, D), got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: q, k, v on different devices")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v of different dtypes")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if min(b, sq, h, d, k.shape[1]) == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if kv_valid is not None and (kv_valid.shape != (b, k.shape[1])
                                 or kv_valid.device != q.device):
        raise ValueError(f"{name}: kv_valid must be (B, Sk) = "
                         f"{(b, k.shape[1])} on {q.device}, got "
                         f"{tuple(kv_valid.shape)} on {kv_valid.device}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {what}'s last axis must be "
                             "contiguous")
    if b * h >= 2 ** 31 or -(-max(sq, k.shape[1]) // 64) > 65535:
        raise ValueError(f"{name}: shape {tuple(q.shape)} x "
                         f"{tuple(k.shape)} exceeds the launch grid")


def _kv_ptr(kv_valid: Optional[torch.Tensor]):
    """kv_valid as a contiguous float32 (B, Sk) tensor and its pointer."""
    if kv_valid is None:
        return None, None
    kvm = kv_valid.to(torch.float32).contiguous()
    return kvm, kvm.data_ptr()


def _raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:       # the handle alone, without a Stream object
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _problem(q, k, v, scale: float, causal: bool):
    """The launchers' shape, stride, scale, flag and stream arguments."""
    b, sq, h, d = q.shape
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    return [b, h, sq, k.shape[1], d, *strides, scale, int(causal),
            int(q.dtype == torch.bfloat16), _raw_stream(q.device)]


def flash_attention_fwd_lse(q, k, v, causal: bool,
                            sm_scale: Optional[float] = None,
                            kv_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (out (B, Sq, H, D) in q's dtype, lse (B*H, 1, Sq) float32).
    Counterpart of the JAX module's ``_flash_fwd_lse``."""
    _check("flash_attention_fwd_lse", q, k, v, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_ref(q, k, v, causal, sm_scale,
                                           kv_valid)
    b, sq, h, d = q.shape
    scale = _scale_of(q, sm_scale)
    lse = torch.empty((b * h, 1, sq), dtype=torch.float32, device=q.device)
    lib, fn = _launchers()["fwd", q.dtype == torch.bfloat16]
    kvm, kv_ptr = _kv_ptr(kv_valid)

    def launch(q, k, v):
        out = torch.empty((b, sq, h, q.shape[-1]), dtype=q.dtype,
                          device=q.device)
        with torch.cuda.device(q.device):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_ptr,
                      out.data_ptr(), lse.data_ptr(),
                      *_problem(q, k, v, scale, causal))
        return out, code

    out, code = launch(q, k, v)
    if code == _NOT_TMA_READABLE:
        q, k, v = _tma_operands(flash_attention_fwd_lse, (q, k, v))
        out, code = launch(q, k, v)
    build.check_launch(lib, "flash_attention_fwd_lse", code)
    flash_attention_fwd_lse.launches += 1
    if out.shape[-1] != d:
        out = out[..., :d].contiguous()
    return out, lse


def _check_bwd(name, q, k, v, g, lse, delta, kv_valid) -> None:
    _check(name, q, k, v, kv_valid)
    b, sq, h, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"{name}: dO must match q's shape, dtype, device")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.shape != (b * h, 1, sq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 "
                             f"{(b * h, 1, sq)} on {q.device}")


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal: bool,
                            sm_scale: Optional[float] = None,
                            kv_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (dk, dv), each (B, Sk, H, D) in k's dtype. ``g`` is dO,
    ``delta`` = rowsum(dO * O) in lse's layout."""
    _check_bwd("flash_attention_bwd_dkv", q, k, v, g, lse, delta, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, g, lse, delta, causal,
                                           sm_scale, kv_valid)
    d = q.shape[-1]
    scale = _scale_of(q, sm_scale)
    lib, fn = _launchers()["dkv", q.dtype == torch.bfloat16]
    kvm, kv_ptr = _kv_ptr(kv_valid)

    def launch(q, k, v, g):
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        with torch.cuda.device(q.device):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), kv_ptr,
                      dk.data_ptr(), dv.data_ptr(),
                      *_problem(q, k, v, scale, causal))
        return dk, dv, code

    g = g.contiguous()
    dk, dv, code = launch(q, k, v, g)
    if code == _NOT_TMA_READABLE:
        dk, dv, code = launch(*_tma_operands(flash_attention_bwd_dkv,
                                             (q, k, v, g)))
    build.check_launch(lib, "flash_attention_bwd_dkv", code)
    flash_attention_bwd_dkv.launches += 1
    if dk.shape[-1] != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def flash_attention_bwd_dq(q, k, v, g, lse, delta, causal: bool,
                           sm_scale: Optional[float] = None,
                           kv_valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K5: dq (B, Sq, H, D) in q's dtype; arguments as K4's."""
    _check_bwd("flash_attention_bwd_dq", q, k, v, g, lse, delta, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, g, lse, delta, causal,
                                          sm_scale, kv_valid)
    d = q.shape[-1]
    scale = _scale_of(q, sm_scale)
    lib, fn = _launchers()["dq", q.dtype == torch.bfloat16]
    kvm, kv_ptr = _kv_ptr(kv_valid)

    def launch(q, k, v, g):
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), kv_ptr,
                      dq.data_ptr(), *_problem(q, k, v, scale, causal))
        return dq, code

    g = g.contiguous()
    dq, code = launch(q, k, v, g)
    if code == _NOT_TMA_READABLE:
        dq, code = launch(*_tma_operands(flash_attention_bwd_dq,
                                         (q, k, v, g)))
    build.check_launch(lib, "flash_attention_bwd_dq", code)
    flash_attention_bwd_dq.launches += 1
    if dq.shape[-1] != d:
        dq = dq[..., :d].contiguous()
    return dq


flash_attention_fwd_lse.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_fwd_lse.staged_copies = 0
flash_attention_bwd_dkv.staged_copies = 0
flash_attention_bwd_dq.staged_copies = 0


def flash_attention_bwd(q, k, v, out, lse, g, causal: bool,
                        sm_scale: Optional[float] = None,
                        kv_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through K4 and K5. Counterpart of the JAX module's
    ``_flash_bwd``; delta = rowsum(dO * O) is plain PyTorch, as there."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, g, causal,
                                       sm_scale, kv_valid)
    delta = _delta(out, g)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal,
                                     sm_scale, kv_valid)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal, sm_scale,
                                kv_valid)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX module's ``custom_vjp``: K3 forward, K4 + K5 backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, sm_scale):
        out, lse = flash_attention_fwd_lse(q, k, v, causal, sm_scale,
                                           kv_valid)
        ctx.save_for_backward(q, k, v, out, lse, kv_valid)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, kv_valid = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal,
                                         ctx.sm_scale, kv_valid)
        # the mask gets no gradient (the JAX module returns zeros)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blockwise attention, softmax(q k^T * scale) v over (B, S, H, D),
    differentiable in q, k and v. ``kv_valid`` (B, Sk): 1 = real key,
    0 = padding. Rows whose keys are all masked emit mean(V); the loss
    must zero-weight such rows, as in the JAX module."""
    return _FlashAttention.apply(q, k, v, kv_valid, causal, sm_scale)


def _as_kv_valid(mask, batch: int, sk: int) -> Optional[torch.Tensor]:
    """A (B, Sk) key-validity tensor from a models.layers-style mask
    (broadcastable to (B, H, Sq, Sk), True = attend), or None when the mask
    is not a pure key-padding pattern."""
    if mask is None:
        return None
    shape = tuple(mask.shape)
    if len(shape) == 4 and shape[0] in (1, batch) and shape[1] == 1 \
            and shape[2] == 1 and shape[3] == sk:
        return mask[:, 0, 0, :].expand(batch, sk)
    if shape == (batch, sk):
        return mask
    return None


def make_flash_attention_fn(causal: bool) -> Callable:
    """Adapter matching models.layers' ``attention_fn(q, k, v, mask,
    dtype)``. The kernel owns causality; a key-padding mask rides the
    kernel as kv_valid. Any other mask goes to ``dot_product_attention``
    (combined with the causal mask), as in the JAX module: that is its
    semantics for masks with (Sq, Sk) structure, not a device fallback."""

    def attention_fn(q, k, v, mask=None, dtype=torch.float32):
        kv_valid = _as_kv_valid(mask, q.shape[0], k.shape[1])
        if mask is not None and kv_valid is None:
            from ..models.layers import dot_product_attention

            if causal:
                cm = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                                device=q.device).tril()[None, None]
                mask = mask.bool() & cm
            return dot_product_attention(q, k, v, mask=mask, dtype=dtype)
        return flash_attention(q, k, v, causal, None, kv_valid).to(dtype)

    return attention_fn
