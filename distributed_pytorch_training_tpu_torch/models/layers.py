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
softmax runs in float32. Tensor parallelism, kernel attention functions and
the paged KV substrate are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import not_ported

Shape = Union[int, Sequence[int]]

# flax's lecun_normal: a normal truncated at +-2 std, rescaled so the
# truncated distribution keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


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


class DenseGeneral(nn.Module):
    """flax's ``DenseGeneral``: contracts the trailing ``in_shape`` axes of
    the input with a kernel of shape ``in_shape + out_shape`` (flax layout)
    and adds a bias of shape ``out_shape``. ``Dense`` is the 1-D case."""

    def __init__(self, in_shape: Shape, out_shape: Shape,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.in_shape, self.out_shape = _shape(in_shape), _shape(out_shape)
        self.kernel = nn.Parameter(
            torch.empty(self.in_shape + self.out_shape, device=device))
        self.bias = (nn.Parameter(torch.empty(self.out_shape, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        fan_in, fan_out = math.prod(self.in_shape), math.prod(self.out_shape)
        y = x.reshape(*lead, fan_in) @ self.kernel.reshape(fan_in, fan_out)
        if self.bias is not None:
            y = y + self.bias.reshape(fan_out)
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
          device=None) -> DenseGeneral:
    return DenseGeneral(in_features, out_features, use_bias, device)


class Embed(nn.Module):
    """flax's ``nn.Embed``: a ``(rows, features)`` table; ``attend`` is the
    tied output head ``x @ embedding.T``."""

    def __init__(self, num_embeddings: int, features: int,
                 init_std: float = 0.02, device=None):
        super().__init__()
        self.init_std = init_std
        self.embedding = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.embedding.T

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.normal_(0.0, self.init_std, generator=generator)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` parameters (``scale``, ``bias``). flax takes
    the variance as E[x^2] - E[x]^2 and PyTorch in two passes; the two
    agree to float32 rounding."""

    def __init__(self, features: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias,
                            self.epsilon)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


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
    """

    def __init__(self, features: int, num_heads: int, head_dim: int,
                 dropout_rate: float = 0.0, use_bias: bool = True,
                 attention_fn: Callable = dot_product_attention,
                 tp_size: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if tp_size > 1:
            raise not_ported("explicit tensor parallelism",
                             "the transformer training slice")
        if attention_fn is not dot_product_attention:
            raise not_ported("kernel attention (flash, ring)",
                             "the transformer training slice")
        if dropout_rate:
            raise not_ported("attention dropout",
                             "the transformer training slice")
        self.dtype = dtype
        self.qkv = DenseGeneral(features, (3, num_heads, head_dim), use_bias,
                                device)
        self.out = DenseGeneral((num_heads, head_dim), features, use_bias,
                                device)

    def forward(self, x, mask=None, cache=None, cache_positions=None):
        qkv = self.qkv(x)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        new_cache = None
        y = None
        if cache is not None:
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
            y = dot_product_attention(q, k, v, mask=mask, dtype=self.dtype)
        out = self.out(y)
        return out if cache is None else (out, new_cache)


class MlpBlock(nn.Module):
    """Transformer MLP: fc1, GELU (tanh approximation, as flax's
    ``nn.gelu``), fc2."""

    def __init__(self, features: int, hidden_dim: int,
                 dropout_rate: float = 0.0, tp_size: int = 1, device=None):
        super().__init__()
        if tp_size > 1:
            raise not_ported("explicit tensor parallelism",
                             "the transformer training slice")
        if dropout_rate:
            raise not_ported("MLP dropout", "the transformer training slice")
        self.fc1 = Dense(features, hidden_dim, device=device)
        self.fc2 = Dense(hidden_dim, features, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (GPT-2 style)."""

    def __init__(self, features: int, num_heads: int, head_dim: int,
                 mlp_dim: int, dropout_rate: float = 0.0,
                 layernorm_epsilon: float = 1e-5,
                 attention_fn: Callable = dot_product_attention,
                 tp_size: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.ln1 = LayerNorm(features, layernorm_epsilon, device)
        self.attn = MultiHeadAttention(
            features, num_heads, head_dim, dropout_rate,
            attention_fn=attention_fn, tp_size=tp_size, dtype=dtype,
            device=device)
        self.ln2 = LayerNorm(features, layernorm_epsilon, device)
        self.mlp = MlpBlock(features, mlp_dim, dropout_rate, tp_size, device)

    def forward(self, x, mask=None, cache=None, cache_positions=None):
        y = self.attn(self.ln1(x), mask=mask, cache=cache,
                      cache_positions=cache_positions)
        new_cache = None
        if cache is not None:
            y, new_cache = y
        x = x + y
        x = x + self.mlp(self.ln2(x))
        return x if cache is None else (x, new_cache)


def padded_vocab_size(vocab_size: int, multiple: int) -> int:
    """Megatron-style vocab padding: the smallest multiple of `multiple`
    >= vocab_size. 0 or 1 disables padding."""
    if multiple <= 1:
        return vocab_size
    return -(-vocab_size // multiple) * multiple


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
