"""BERT-base for masked LM (the JAX package's models/bert.py, as an
``nn.Module``): the "BERT-base MLM seq-len 512 (grad-sync profiling run)"
configuration.

HF-equivalent architecture: token, position and type embeddings with a
LayerNorm after them, post-LN encoder blocks (sublayer, residual, LN),
and the MLM head (dense, GELU, LN) decoding through the tied token
embedding plus a ``(vocab,)`` bias. 109,514,298 parameters at the
defaults. Parameters keep flax's names and layouts (``convert.py``);
``dtype`` is flax's compute dtype (``models/layers.py``), the logits are
float32. The attention is bidirectional: a kernel ``attention_fn`` is
made with ``causal=False``. The type embedding is looked up as a one-hot
product (``Embed.one_hot_lookup``: the same values, a reproducible
gradient). ``remat`` recomputes each block in the backward. Dropout is
not ported.

Under tensor parallelism (``tp``, the mesh's ``model`` axis of size M >
1), laid out by ``tp_fsdp_rules`` as GPT-2 is: the blocks' attention
and MLP are megatron's column/row-split forms (``models/layers.py``;
the post-LN LayerNorms stay replicated), and when the padded vocab
divides by M (the entry pads it to lcm(128, M): 30592 at M 2 and 4) the
token embedding is vocab-split, its lookup summed over the model axis
and the tied decoder returning this shard's logit columns as a
``TpShardedLogits``. ``mlm_bias`` keeps its ``(vocab,)`` shape and stays
replicated: zero-padded to the padded vocab as in the JAX model, each
shard adds its own slice after ``copy_to_tp`` (whose backward sums the
slices' gradients over the model axis, so every shard holds the whole
bias gradient), and the padding columns, which the last shard holds,
are masked by their global index. The position and type embeddings,
``embed_ln`` and the MLM head's dense and LayerNorm are replicated. A
TP-local model is ``clone(tp=...)`` loaded with its slices of the global
parameters (``convert.tp_local_params``); it draws no init of its own.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..parallel.collectives import TpAxis
from .layers import (
    Dense,
    Embed,
    LayerNorm,
    MlpBlock,
    MultiHeadAttention,
    TpModelMixin,
    VocabPaddingMixin,
    dot_product_attention,
    gelu,
    mask_vocab_padding,
    padding_mask,
    remat_call,
    vocab_parallel_embed,
    vocab_parallel_logits,
)
from .registry import register_model


class BertBlock(nn.Module):
    """Post-LN encoder block (BERT's order: sublayer, residual, LN)."""

    def __init__(self, features: int, num_heads: int, head_dim: int,
                 mlp_dim: int, dropout_rate: float = 0.0,
                 layernorm_epsilon: float = 1e-12,
                 attention_fn=dot_product_attention,
                 tp: Optional[TpAxis] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.attn = MultiHeadAttention(
            features, num_heads, head_dim, dropout_rate,
            attention_fn=attention_fn, tp=tp, dtype=dtype, device=device)
        self.ln1 = LayerNorm(features, layernorm_epsilon, device, dtype)
        self.mlp = MlpBlock(features, mlp_dim, dropout_rate, tp, device,
                            dtype)
        self.ln2 = LayerNorm(features, layernorm_epsilon, device, dtype)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.ln1(x + self.attn(x, mask=mask))
        return self.ln2(x + self.mlp(x))


class BertForMaskedLM(TpModelMixin, VocabPaddingMixin, nn.Module):

    def __init__(self, vocab_size: int = 30522, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 max_position: int = 512, type_vocab_size: int = 2,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 layernorm_epsilon: float = 1e-12,
                 attention_fn=dot_product_attention, remat: bool = False,
                 pad_vocab_to_multiple_of: int = 0,
                 tp: Optional[TpAxis] = None, device=None):
        super().__init__()
        self._config = dict(
            vocab_size=vocab_size, hidden_dim=hidden_dim, depth=depth,
            num_heads=num_heads, mlp_dim=mlp_dim, max_position=max_position,
            type_vocab_size=type_vocab_size, dropout_rate=dropout_rate,
            dtype=dtype, layernorm_epsilon=layernorm_epsilon,
            attention_fn=attention_fn, remat=remat,
            pad_vocab_to_multiple_of=pad_vocab_to_multiple_of, tp=tp)
        self.vocab_size, self.hidden_dim = vocab_size, hidden_dim
        self.depth, self.num_heads = depth, num_heads
        self.max_position, self.dtype = max_position, dtype
        self.pad_vocab_to_multiple_of = pad_vocab_to_multiple_of
        self.remat = remat
        self.tp = tp if tp is not None else TpAxis(1)
        # flax's default embedding init: normal, variance 1 / features
        std = 1.0 / math.sqrt(hidden_dim)
        rows = (self.padded_vocab // self.tp.size if self.tp_vocab
                else self.padded_vocab)
        self.token_embedding = Embed(rows, hidden_dim, std, device, dtype)
        self.position_embedding = Embed(max_position, hidden_dim, std,
                                        device, dtype)
        self.type_embedding = Embed(type_vocab_size, hidden_dim, std,
                                    device, dtype)
        self.embed_ln = LayerNorm(hidden_dim, layernorm_epsilon, device,
                                  dtype)
        self.blocks = nn.ModuleList(
            BertBlock(hidden_dim, num_heads, hidden_dim // num_heads,
                      mlp_dim, dropout_rate, layernorm_epsilon,
                      attention_fn, tp, dtype, device)
            for _ in range(depth))
        self.mlm_dense = Dense(hidden_dim, hidden_dim, device=device,
                               dtype=dtype)
        self.mlm_ln = LayerNorm(hidden_dim, layernorm_epsilon, device, dtype)
        # HF-exact (vocab,) even when the table is padded
        self.mlm_bias = nn.Parameter(torch.empty(vocab_size, device=device))

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        self.mlm_bias.zero_()

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """(B, S) ids -> (B, S, vocab) float32 logits (this shard's
        columns, a ``TpShardedLogits``, when the vocab is split)."""
        s = input_ids.shape[1]
        x = (vocab_parallel_embed(self.token_embedding, input_ids, self.tp)
             if self.tp_vocab else self.token_embedding(input_ids))
        x = x + self.position_embedding(
            torch.arange(s, device=input_ids.device)[None, :])
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # the 2-row type table: every row of the batch looks up one row,
        # so its gradient is a one-hot product's, reproducible on CUDA
        x = self.embed_ln(x + self.type_embedding.one_hot_lookup(
            token_type_ids))
        mask = (padding_mask(attention_mask) if attention_mask is not None
                else None)
        for block in self.blocks:
            x = remat_call(block, x, mask) if self.remat else block(x, mask)
        h = self.mlm_ln(gelu(self.mlm_dense(x)))
        bias = self.mlm_bias
        if self.padded_vocab != self.vocab_size:
            bias = torch.nn.functional.pad(
                bias, (0, self.padded_vocab - self.vocab_size))
        if self.tp_vocab:
            # each shard adds its slice of the replicated, padded bias
            return vocab_parallel_logits(self.token_embedding, h, self.tp,
                                         self.vocab_size, bias)
        logits = self.token_embedding.attend(h)
        # the bias is float32: the sum is, as flax promotes it
        return mask_vocab_padding(logits.float() + bias, self.vocab_size)


@register_model("bert_base")
def bert_base(**kw) -> BertForMaskedLM:
    return BertForMaskedLM(**kw)
