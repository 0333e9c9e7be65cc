"""Transformer building blocks (attention, MLP, embeddings, LayerNorm).

Parameters keep the flax layout of the JAX package's models/layers.py, so
that a parameter here is the same array as its flax counterpart
(``convert.py`` only renames):

* a dense kernel is ``(in, out)`` and is applied as ``x @ kernel``;
* the fused qkv kernel is ``(d_model, 3, heads, head_dim)``, the attention
  out kernel ``(heads, head_dim, d_model)``;
* an embedding table is ``(rows, features)``.

The layout matters beyond convenience: int8 serving puts one scale on each
row over the trailing axis of these shapes (``serving/engine.py``), and a
``(out, in)`` layout would quantize on another grid.

The semantics carried over exactly: GELU is the tanh approximation (flax's
``nn.gelu``); masked attention logits are the float32 minimum and the
softmax runs in float32.

Compute dtype (bf16 under ``--amp``) is flax's ``dtype`` beside float32
parameters: a dense layer or embedding casts its input and parameters to
``dtype`` before the product (or the lookup), so products, biases, GELU
and the residual stream are in ``dtype``; LayerNorm takes its statistics
and normalizes in float32 and casts the result to ``dtype``; attention's
softmax runs in float32 and its weights are cast back to ``dtype``. Not
``torch.autocast``, whose per-op lists round elsewhere (its layer_norm
and softmax return float32). A kernel ``attention_fn`` (flash,
``ops/flash_attention.py``) serves the no-cache forward; the cache paths
refuse it, as in the JAX package. The paged KV pool of continuous serving
is here too. ``remat_call`` is flax's ``nn.remat`` of a block. Dropout
is not ported yet and raises ``NotImplementedError``.

Tensor parallelism (megatron, over the mesh's ``model`` axis, ``tp`` a
``parallel.collectives.TpAxis`` of size M > 1): the attention's qkv
kernel is column-split by heads, ``(d, 3, H/M, D)`` holding heads
[r H/M, (r+1) H/M) of each of q, k and v, its out projection row-split
(``RowParallelDense``); the MLP's fc1 column-split with its bias slice,
fc2 row-split. ``copy_to_tp`` at each region's input and one
``reduce_from_tp`` at each residual join, the replicated bias added once
after it. The parameter names are the unsplit modules', so a TP-local
model holds slices of the same tree (``tp_fsdp_rules`` is the layout;
``parallel/sharding.py`` reads it). The JAX package's refusals stay:
heads or hidden width not divisible by M, dropout, and a KV cache.

The ``fsdp`` axis (GSPMD's d_model sharding): a leaf the rules place on
``fsdp`` is held as its 1/F slice along that dim (marked with
``collectives.FsdpShard``) and each module reads it through
``collectives.gathered``, which gathers it whole for the product and
reduce-scatters its gradient back (``training/loop.py`` makes the
slices; a TP-local leaf's slice is cut again).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..parallel.collectives import (TpAxis, TpShardedLogits, copy_to_tp,
                                    gathered, reduce_from_tp)
from ..parallel.mesh import FSDP, MODEL
from ..parallel.sharding import PartitionRules
from ..runtime import not_ported

Shape = Union[int, Sequence[int]]

# flax's lecun_normal: a normal truncated at +-2 std, rescaled so the
# truncated distribution keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation. Below float32 it is jax.nn.gelu's formula
    op by op, its constants in ``x.dtype`` and each op rounded to it, as
    XLA computes it on the CPU: bitwise the JAX package's on bf16 inputs
    (torch's fused GELU, rounded once, differs in ~40% of them)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")

    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = const(_SQRT_2_OVER_PI) * (x + const(0.044715) * x ** 3)
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def _shape(s: Shape) -> Tuple[int, ...]:
    return (int(s),) if isinstance(s, int) else tuple(int(d) for d in s)


def dot_product_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, H, D)
    v: torch.Tensor,  # (B, T, H, D)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, S, T), True=attend
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """softmax(QK^T/sqrt(d))V. Softmax in fp32; output cast to ``dtype``."""
    d = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q, k).float()
    logits = logits / math.sqrt(d)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhst,bthd->bshd", weights, v)


# Attention over the KV cache in a decode step. The JAX package keeps a
# separate formulation there so that decode rows stay bitwise equal to the
# full forward's; the port pins logits within a tolerance instead, so both
# steps share one function.
decode_dot_product_attention = dot_product_attention


# ---------------------------------------------------------------------------
# The paged KV pool (continuous serving, serving/continuous.py)
#
# k/v live in a pool of fixed-size pages (L, n_pages, page_size, H, D),
# stacked over every block so that one gather and one scatter serve the
# whole model; each serving slot owns a row of a page table that maps its
# positions onto pool pages. The decode step gathers a slot's pages into
# the dense (rows, T, H, D) view the decode attention reads, and scatters
# the fresh rows back. int8 pages quantize each (position, head) row over
# D on the gradient wire's grid (K1, ``ops/quantize.py``): codes and one
# float32 scale a row.
#
# The pool is updated in place. JAX drops a masked write by pointing it at
# page n_pages (``mode="drop"``) and clips an out-of-range page-table
# lookup; torch indexing has neither. Here every lookup is clamped into
# the table, then masked, and a masked write is redirected to the first
# kept write of the same call (same location, same value), or, when the
# call keeps none, writes back what its location already holds. Every
# index is in range, the duplicates agree, no host sync is needed, and the
# pool's bytes are JAX's.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKV:
    """The model's paged KV pool, stacked across all blocks: ``k``/``v``
    (L, n_pages, page_size, H, D) in the model dtype, or int8 codes with
    ``k_scale``/``v_scale`` (L, n_pages, page_size, H), one float32 scale a
    (layer, page, position, head) row. Page 0 is the scratch page
    (``serving/paged.py``): unallocated table entries point at it, so a
    gather is always in range and masked positions stay finite."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(t for t in (self.k, self.v, self.k_scale, self.v_scale)
                     if t is not None)


def init_paged_kv(depth: int, n_pages: int, page_size: int, num_heads: int,
                  head_dim: int, dtype: torch.dtype = torch.float32,
                  quantized: bool = False, device=None) -> PagedKV:
    """Zero-filled paged pool for all ``depth`` blocks (stacked axis 0)."""
    shape = (depth, n_pages, page_size, num_heads, head_dim)
    if quantized:
        return PagedKV(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))
    return PagedKV(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _dequant_pages(codes: torch.Tensor, scales: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (codes.float() * scales[..., None]).to(dtype)


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize (..., D) on the gradient wire's grid, one scale a
    leading row: K1 on a CUDA tensor, its plain version on the CPU (both
    bitwise the JAX package's ``_quantize_int8_rows(fused=False)``)."""
    from ..ops.quantize import quantize_int8_rows

    lead = x.shape[:-1]
    q, scales = quantize_int8_rows(
        x.float().reshape(-1, x.shape[-1]).contiguous())
    return q.reshape(x.shape), scales.reshape(lead)


def gather_paged_kv(pkv: PagedKV, page_table: torch.Tensor,
                    dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot dense view of the whole pool: ``page_table`` (rows, P) ->
    (L, rows, P * page_size, H, D) k and v in ``dtype`` (dequantized when
    the pool is int8), one gather covering every layer. Positions past a
    slot's write frontier hold scratch or stale (finite) values that the
    caller's mask zeroes."""
    rows, pages = page_table.shape
    depth, _, ps = pkv.k.shape[:3]
    table = page_table.long()

    def dense(codes, scales):
        g = codes[:, table].reshape(depth, rows, pages * ps,
                                    *codes.shape[3:])
        if scales is not None:
            s = scales[:, table].reshape(depth, rows, pages * ps, -1)
            return _dequant_pages(g, s, dtype)
        return g.to(dtype)

    return dense(pkv.k, pkv.k_scale), dense(pkv.v, pkv.v_scale)


def _put(store: torch.Tensor, page: torch.Tensor, off: torch.Tensor,
         fresh: torch.Tensor, keep: torch.Tensor) -> None:
    """``store[:, page[m], off[m]] = fresh[:, m]`` for every m with
    ``keep[m]``, in place; JAX's ``mode="drop"`` for the rest (see the
    section's note). ``page``/``off``/``keep`` are (M,), ``fresh``
    (L, M, ...)."""
    first = torch.argmax(keep.to(torch.int32))
    held = store[:, page[first], off[first]]
    fill = torch.where(keep.any(), fresh[:, first], held)
    mask = keep.reshape(1, -1, *([1] * (fresh.dim() - 2)))
    store[:, torch.where(keep, page, page[first]),
          torch.where(keep, off, off[first])] = torch.where(
              mask, fresh, fill.unsqueeze(1))


def _put_kv(pkv: PagedKV, page: torch.Tensor, off: torch.Tensor,
            k_rows: torch.Tensor, v_rows: torch.Tensor,
            keep: torch.Tensor) -> PagedKV:
    """Write (L, M, H, D) k and v rows at M (page, offset) locations,
    quantizing first when the pool is int8 (two K1 calls: k, then v)."""
    for store, scale_store, fresh in ((pkv.k, pkv.k_scale, k_rows),
                                      (pkv.v, pkv.v_scale, v_rows)):
        if scale_store is not None:
            q, s = _quant_rows(fresh)
            _put(store, page, off, q, keep)
            _put(scale_store, page, off, s, keep)
        else:
            _put(store, page, off, fresh.to(store.dtype), keep)
    return pkv


def scatter_paged_rows(pkv: PagedKV, page_table: torch.Tensor,
                       positions: torch.Tensor, k_rows: torch.Tensor,
                       v_rows: torch.Tensor,
                       active: torch.Tensor) -> PagedKV:
    """Write one fresh (H, D) k/v row per slot per layer (``k_rows``/
    ``v_rows`` (L, rows, H, D)) at that slot's position (``positions``
    (rows,)): the paged decode step's write half, one scatter covering
    every layer. Inactive rows (``active`` False) write nothing."""
    return scatter_paged_window(pkv, page_table, positions[:, None],
                                k_rows[:, :, None], v_rows[:, :, None],
                                active[:, None])


def scatter_paged_window(pkv: PagedKV, page_table: torch.Tensor,
                         positions: torch.Tensor, k_rows: torch.Tensor,
                         v_rows: torch.Tensor,
                         active: torch.Tensor) -> PagedKV:
    """`scatter_paged_rows` over an S-position window per slot:
    ``positions``/``active`` (rows, S), ``k_rows``/``v_rows``
    (L, rows, S, H, D). The speculative verify step's write half and the
    draft's propose commit. A position past the slot's page span is looked
    up at its last table entry (JAX's clipped gather), so the caller masks
    it."""
    ps = pkv.k.shape[2]
    rows, s = positions.shape
    pos = positions.long()
    idx = torch.clamp(pos // ps, 0, page_table.shape[1] - 1)
    page = page_table.long()[
        torch.arange(rows, device=pos.device)[:, None], idx]
    depth = k_rows.shape[0]
    return _put_kv(pkv, page.reshape(-1), (pos % ps).reshape(-1),
                   k_rows.reshape(depth, rows * s, *k_rows.shape[3:]),
                   v_rows.reshape(depth, rows * s, *v_rows.shape[3:]),
                   active.reshape(-1))


def scatter_paged_prefill(pkv: PagedKV, page_row: torch.Tensor,
                          k_seqs: torch.Tensor, v_seqs: torch.Tensor,
                          length) -> PagedKV:
    """Write one slot's prompt k/v (``k_seqs``/``v_seqs`` (L, S, H, D),
    every layer at once) into its pages, positions [0, length) only:
    bucket padding is dropped, so a shared prefix page is only ever
    rewritten with its own bytes."""
    ps = pkv.k.shape[2]
    idx = torch.arange(k_seqs.shape[1], device=k_seqs.device)
    page = page_row.long()[torch.clamp(idx // ps, 0,
                                       page_row.shape[0] - 1)]
    return _put_kv(pkv, page, idx % ps, k_seqs, v_seqs, idx < length)


def paged_kv_bytes(pool: PagedKV) -> int:
    """At-rest bytes of a paged pool (codes and scales for int8 pools),
    compared against `dense_kv_bytes`."""
    return int(sum(t.numel() * t.element_size() for t in pool.tensors()))


def dense_kv_bytes(rows: int, cache_len: int, num_heads: int, head_dim: int,
                   depth: int, itemsize: int = 4) -> int:
    """The dense engine's at-rest KV bytes at the same configuration: the
    baseline of the int8 pool's >= 3x cut."""
    return 2 * depth * rows * cache_len * num_heads * head_dim * itemsize


class DenseGeneral(nn.Module):
    """flax's ``DenseGeneral``: contracts the trailing ``in_shape`` axes of
    the input with a kernel of shape ``in_shape + out_shape`` (flax layout)
    and adds a bias of shape ``out_shape``. ``Dense`` is the 1-D case."""

    def __init__(self, in_shape: Shape, out_shape: Shape,
                 use_bias: bool = True, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.in_shape, self.out_shape = _shape(in_shape), _shape(out_shape)
        self.kernel = nn.Parameter(
            torch.empty(self.in_shape + self.out_shape, device=device))
        self.bias = (nn.Parameter(torch.empty(self.out_shape, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        fan_in, fan_out = math.prod(self.in_shape), math.prod(self.out_shape)
        y = (x.to(self.dtype).reshape(*lead, fan_in)
             @ gathered(self.kernel).to(self.dtype).reshape(fan_in, fan_out))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).reshape(fan_out)
        return y.reshape(*lead, *self.out_shape)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun_normal kernel (fan_in = the contracted
        axes), zero bias."""
        std = math.sqrt(1.0 / math.prod(self.in_shape)) / _TRUNC_STD
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if self.bias is not None:
            self.bias.zero_()


def Dense(in_features: int, out_features: int, use_bias: bool = True,
          device=None, dtype: torch.dtype = torch.float32) -> DenseGeneral:
    return DenseGeneral(in_features, out_features, use_bias, device, dtype)


class Embed(nn.Module):
    """flax's ``nn.Embed``: a ``(rows, features)`` table; ``attend`` is the
    tied output head ``x @ embedding.T``."""

    def __init__(self, num_embeddings: int, features: int,
                 init_std: float = 0.02, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_std = init_std
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, gathered(self.embedding).to(self.dtype))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ gathered(self.embedding).to(self.dtype).T

    def one_hot_lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The lookup as a one-hot product: the same values (each output
        is one row times 1), and a table gradient that is a GEMM, summed
        in a fixed order. For a table of a few rows that each take
        thousands of lookups, whose gradient CUDA's embedding backward
        sums in an order that varies from run to run (an H100, a 2-row
        table, 4096 lookups of one row)."""
        hot = F.one_hot(ids.long(), self.embedding.shape[0])
        return hot.to(self.dtype) @ gathered(self.embedding).to(self.dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.normal_(0.0, self.init_std, generator=generator)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` parameters (``scale``, ``bias``). flax takes
    the variance as E[x^2] - E[x]^2 and PyTorch in two passes; the two
    agree to float32 rounding. Computed in float32, the result cast to
    ``dtype``."""

    def __init__(self, features: int, epsilon: float = 1e-5, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, self.epsilon).to(self.dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


class RowParallelDense(nn.Module):
    """Megatron's row-parallel linear: the kernel's contracted (input)
    dims hold this shard's slice, the partial product is summed over the
    model axis (`reduce_from_tp`, the one forward all-reduce of a
    residual join), and the model-replicated bias is added after the sum,
    once. Its parameters are named as ``DenseGeneral``'s."""

    def __init__(self, in_shape: Shape, features: int, tp: TpAxis,
                 use_bias: bool = True, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tp, self.dtype = tp, dtype
        self.in_shape = _shape(in_shape)
        self.kernel = nn.Parameter(
            torch.empty(self.in_shape + (features,), device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        fan_in = math.prod(self.in_shape)
        y = (x.to(self.dtype).reshape(*lead, fan_in)
             @ gathered(self.kernel).to(self.dtype).reshape(fan_in, -1))
        y = reduce_from_tp(y, self.tp)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def _tp_of(tp: Optional[TpAxis]) -> TpAxis:
    return tp if tp is not None else TpAxis(1)


_TP_DROPOUT = ("explicit TP runs the dropout RNG stream replicated over "
               "the model axis; per-shard {} slices would draw correlated "
               "masks — train explicit TP with dropout 0")


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused qkv projection.

    KV cache: ``cache=(k, v)`` of shape (B, T, H, D) engages the serving
    path and the call returns ``(out, new_cache)``.

    * prefill (``cache_positions=None``): the S fresh rows fill slots
      [0, S) and attention runs over the FRESH k/v with the caller's causal
      mask, exactly the no-cache computation;
    * decode (``cache_positions`` = per-row write index): window token j
      lands at each row's own ``position + j`` (a where-scatter, so rows at
      different prompt lengths advance independently; positions past the
      cache are dropped), then attention runs over the updated cache under
      the caller's per-row mask.

    The cache is returned as new tensors; the inputs are not modified.
    Under tensor parallelism (``tp`` of size M > 1) the module holds H/M
    heads and runs ``attention_fn`` on them alone (the flash kernels on
    CUDA), and has no cache path.
    """

    def __init__(self, features: int, num_heads: int, head_dim: int,
                 dropout_rate: float = 0.0, use_bias: bool = True,
                 attention_fn: Callable = dot_product_attention,
                 tp: Optional[TpAxis] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.tp = tp = _tp_of(tp)
        if tp.size > 1:
            if dropout_rate:
                raise ValueError(_TP_DROPOUT.format("head"))
            if num_heads % tp.size:
                raise ValueError(f"num_heads={num_heads} not divisible by "
                                 f"tp_size={tp.size}")
        if dropout_rate:
            raise not_ported("attention dropout (jax.random's dropout bits "
                             "cannot be reproduced)", "a later slice")
        self.attention_fn = attention_fn
        self.dtype = dtype
        heads = num_heads // tp.size
        self.qkv = DenseGeneral(features, (3, heads, head_dim), use_bias,
                                device, dtype)
        if tp.size > 1:
            self.out = RowParallelDense((heads, head_dim), features, tp,
                                        use_bias, device, dtype)
        else:
            self.out = DenseGeneral((heads, head_dim), features, use_bias,
                                    device, dtype)

    def forward(self, x, mask=None, cache=None, cache_positions=None):
        if self.tp.size > 1:
            if cache is not None:
                raise ValueError(
                    "explicit TP attention has no KV-cache path — serve TP "
                    "checkpoints via the GSPMD rules (--mesh model=N "
                    "without --fsdp-explicit on the serving side)")
            x = copy_to_tp(x, self.tp)
        qkv = self.qkv(x)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        new_cache = None
        y = None
        if cache is not None:
            if self.attention_fn is not dot_product_attention:
                raise ValueError(
                    "KV-cache decoding needs the einsum attention path: the "
                    "kernel attention_fns own their causal structure and "
                    "take no cache (serve with --attention xla)")
            ck, cv = cache
            if cache_positions is None:
                s = k.shape[1]
                new_cache = (torch.cat((k.to(ck.dtype), ck[:, s:]), dim=1),
                             torch.cat((v.to(cv.dtype), cv[:, s:]), dim=1))
            else:
                slots = torch.arange(ck.shape[1], device=ck.device)
                for j in range(q.shape[1]):
                    hit = (slots[None, :] == (cache_positions + j)[:, None]
                           )[:, :, None, None]
                    ck = torch.where(hit, k[:, j:j + 1].to(ck.dtype), ck)
                    cv = torch.where(hit, v[:, j:j + 1].to(cv.dtype), cv)
                new_cache = (ck, cv)
                y = decode_dot_product_attention(q, ck, cv, mask=mask,
                                                 dtype=self.dtype)
        if y is None:
            y = self.attention_fn(q, k, v, mask=mask, dtype=self.dtype)
        out = self.out(y)
        return out if cache is None else (out, new_cache)


class MlpBlock(nn.Module):
    """Transformer MLP: fc1, GELU (tanh approximation, as flax's
    ``nn.gelu``), fc2. Under tensor parallelism fc1 holds this shard's
    ``hidden_dim / M`` neurons (with its bias slice) and fc2 is
    row-parallel."""

    def __init__(self, features: int, hidden_dim: int,
                 dropout_rate: float = 0.0, tp: Optional[TpAxis] = None,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tp = tp = _tp_of(tp)
        if tp.size > 1:
            if dropout_rate:
                raise ValueError(_TP_DROPOUT.format("neuron"))
            if hidden_dim % tp.size:
                raise ValueError(f"hidden_dim={hidden_dim} not divisible by "
                                 f"tp_size={tp.size}")
        if dropout_rate:
            raise not_ported("MLP dropout", "a later slice")
        local = hidden_dim // tp.size
        self.fc1 = Dense(features, local, device=device, dtype=dtype)
        self.fc2 = (RowParallelDense(local, features, tp, device=device,
                                     dtype=dtype) if tp.size > 1
                    else Dense(local, features, device=device, dtype=dtype))

    def forward(self, x):
        return self.fc2(gelu(self.fc1(copy_to_tp(x, self.tp))))


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (GPT-2 style)."""

    def __init__(self, features: int, num_heads: int, head_dim: int,
                 mlp_dim: int, dropout_rate: float = 0.0,
                 layernorm_epsilon: float = 1e-5,
                 attention_fn: Callable = dot_product_attention,
                 tp: Optional[TpAxis] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.ln1 = LayerNorm(features, layernorm_epsilon, device, dtype)
        self.attn = MultiHeadAttention(
            features, num_heads, head_dim, dropout_rate,
            attention_fn=attention_fn, tp=tp, dtype=dtype, device=device)
        self.ln2 = LayerNorm(features, layernorm_epsilon, device, dtype)
        self.mlp = MlpBlock(features, mlp_dim, dropout_rate, tp, device,
                            dtype)

    def forward(self, x, mask=None, cache=None, cache_positions=None):
        y = self.attn(self.ln1(x), mask=mask, cache=cache,
                      cache_positions=cache_positions)
        new_cache = None
        if cache is not None:
            y, new_cache = y
        x = x + y
        x = x + self.mlp(self.ln2(x))
        return x if cache is None else (x, new_cache)


def remat_call(block: nn.Module, *args) -> torch.Tensor:
    """``block(*args)`` under flax's ``nn.remat``: with gradients on, the
    block keeps only its inputs and runs its forward again in the backward
    (``torch.utils.checkpoint``, non-reentrant), trading the activations'
    memory for a second forward; a kernel ``attention_fn`` launches its
    forward kernel twice a step. Without gradients, a plain call."""
    if not torch.is_grad_enabled():
        return block(*args)
    return torch.utils.checkpoint.checkpoint(block, *args,
                                             use_reentrant=False)


def padded_vocab_size(vocab_size: int, multiple: int) -> int:
    """Megatron-style vocab padding: the smallest multiple of `multiple`
    >= vocab_size. 0 or 1 disables padding."""
    if multiple <= 1:
        return vocab_size
    return -(-vocab_size // multiple) * multiple


class VocabPaddingMixin:
    """The padded vocab of a model with ``vocab_size`` and
    ``pad_vocab_to_multiple_of`` attributes (the JAX package's mixin)."""

    @property
    def padded_vocab(self) -> int:
        return padded_vocab_size(self.vocab_size,
                                 self.pad_vocab_to_multiple_of)

    @property
    def tp_vocab(self) -> bool:
        """Whether the tensor-parallel forward vocab-splits the token
        embedding: a ``tp`` model axis of size M > 1 that divides the
        padded vocab."""
        tp = getattr(self, "tp", None)
        return (tp is not None and tp.size > 1
                and self.padded_vocab % tp.size == 0)


class TpModelMixin:
    """The tensor-parallel model contract of GPT-2, BERT and ViT: a
    ``clone`` over the constructor's keywords (``_config``; flax's
    ``Module.clone``), the ``tp_fsdp_rules`` layout, and an init that a
    TP-local model (``tp`` of size > 1) refuses, since it holds slices of
    one global draw. ``fsdp_explicit_tp`` says whether the model also
    takes the sharded update (``fsdp_explicit``) on a model axis: in the
    JAX package only GPT-2 has that explicit-TP form, and its Trainer
    refuses the others there."""

    fsdp_explicit_tp = False

    def clone(self, **changes):
        """A new model of this configuration with ``changes``, its
        parameters uninitialized."""
        return type(self)(**{**self._config, **changes})

    @staticmethod
    def partition_rules() -> PartitionRules:
        return tp_fsdp_rules()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init with flax's initializers, drawn from ``generator``:
        each submodule's in registration order, then the model's own
        leaves (``reset_own_parameters``)."""
        if self.tp.size > 1:
            raise ValueError(
                "a tensor-parallel model holds slices of the global "
                "parameters: initialize the global model and load its "
                "slices (convert.tp_local_params), so every model rank "
                "starts from one draw")
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        self.reset_own_parameters(generator)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        """The init of the leaves the model holds outside its
        submodules."""


def vocab_parallel_embed(embed: Embed, ids: torch.Tensor,
                         tp: TpAxis) -> torch.Tensor:
    """The vocab-split lookup: shard r holds rows [r rows, (r+1) rows) of
    the table, ids outside them give exact zeros, and the partial rows
    are summed over the model axis into the whole row."""
    rows = embed.embedding.shape[0]
    local_ids = ids - tp.index * rows
    valid = (local_ids >= 0) & (local_ids < rows)
    found = embed(local_ids.clamp(0, rows - 1))
    return reduce_from_tp(torch.where(valid[..., None], found,
                                      torch.zeros_like(found)), tp)


def vocab_parallel_logits(embed: Embed, h: torch.Tensor, tp: TpAxis,
                          vocab_size: int,
                          bias: Optional[torch.Tensor] = None
                          ) -> TpShardedLogits:
    """The vocab-split tied decoder: this shard's float32 logit columns,
    kept sharded for the task's parallel-vocab cross-entropy. ``bias``, a
    replicated ``(padded vocab,)`` vector, adds this shard's slice after
    ``copy_to_tp`` (whose backward sums the slices' gradients over the
    model axis). The padding columns are masked by their global index on
    the shard that holds them."""
    rows = embed.embedding.shape[0]
    lo = tp.index * rows
    local = embed.attend(copy_to_tp(h, tp)).float()
    if bias is not None:
        local = local + copy_to_tp(bias, tp)[lo:lo + rows]
    cols = lo + torch.arange(rows, device=local.device)
    local = torch.where(cols < vocab_size, local,
                        torch.finfo(torch.float32).min)
    return TpShardedLogits(local, tp, rows, vocab_size)


def mask_vocab_padding(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Set the padded vocab columns' logits to the dtype minimum, so softmax
    gives them zero probability and argmax never picks them."""
    padded = logits.shape[-1]
    if padded == vocab_size:
        return logits
    keep = torch.arange(padded, device=logits.device) < vocab_size
    return torch.where(keep, logits, torch.finfo(logits.dtype).min)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """(1, 1, S, S) lower-triangular True=attend mask."""
    return torch.tril(torch.ones((seq_len, seq_len), dtype=torch.bool,
                                 device=device))[None, None]


def padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) 1=real token -> (B, 1, 1, T) attend mask."""
    return attention_mask[:, None, None, :].bool()


def tp_fsdp_rules() -> PartitionRules:
    """The layout table every transformer ships (the JAX package's
    ``tp_fsdp_rules``): megatron TP over ``model`` on the head and neuron
    dims, FSDP over ``fsdp`` on the complementary d_model dim of the same
    kernels. ``parallel.sharding.tp_split_dims`` reads its ``model``
    entries and ``fsdp_split_dims`` its ``fsdp`` ones."""
    return PartitionRules([
        (r"attn/qkv/kernel", (FSDP, None, MODEL, None)),
        (r"attn/qkv/bias", (None, MODEL, None)),
        (r"attn/out/kernel", (MODEL, None, FSDP)),
        (r"mlp/fc1/kernel", (FSDP, MODEL)),
        (r"mlp/fc1/bias", (MODEL,)),
        (r"mlp/fc2/kernel", (MODEL, FSDP)),
        (r"(token_embedding|wte)/embedding", (MODEL, FSDP)),
        (r"(position_embedding|wpe)/embedding", (None, FSDP)),
        (r"patch_embed/kernel", (None, None, None, FSDP)),
        (r"(head|fc|mlm_dense)/kernel", (FSDP, None)),
    ])
