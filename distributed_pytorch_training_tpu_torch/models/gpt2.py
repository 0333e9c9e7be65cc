"""GPT-2 causal LM (the JAX package's models/gpt2.py, as an ``nn.Module``).

HF-equivalent architecture: learned token + position embeddings, pre-LN
blocks (GELU MLP of 4x width), final LN, LM head tied to the token
embedding. Parameters keep the flax layout and flax's names, with the
blocks in ``blocks.<i>`` where flax has ``block<i>`` (``convert.py``).

A kernel ``attention_fn`` (flash) owns the causal structure: the blocks
then get only the padding mask. ``dtype`` is the compute dtype beside
float32 parameters (``models/layers.py`` says where it rounds); the logits
are float32. ``remat`` recomputes each block in the backward
(``layers.remat_call``, flax's ``nn.remat``). Not ported yet, and refused:
tensor parallelism and dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import (
    Embed,
    LayerNorm,
    TransformerBlock,
    VocabPaddingMixin,
    causal_mask,
    dot_product_attention,
    init_paged_kv,
    mask_vocab_padding,
    remat_call,
)
from .registry import register_model


class GPT2LMHead(VocabPaddingMixin, nn.Module):

    def __init__(self, vocab_size: int = 50257, hidden_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 max_position: int = 1024, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 layernorm_epsilon: float = 1e-5,
                 attention_fn=dot_product_attention, remat: bool = False,
                 pad_vocab_to_multiple_of: int = 0, tp_size: int = 1,
                 device=None):
        super().__init__()
        self.remat = remat
        self.vocab_size, self.hidden_dim = vocab_size, hidden_dim
        self.depth, self.num_heads = depth, num_heads
        self.max_position, self.dtype = max_position, dtype
        self.pad_vocab_to_multiple_of = pad_vocab_to_multiple_of
        self.uses_kernel = attention_fn is not dot_product_attention
        head_dim = hidden_dim // num_heads
        self.wte = Embed(self.padded_vocab, hidden_dim, 0.02, device, dtype)
        self.wpe = Embed(max_position, hidden_dim, 0.01, device, dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_dim, num_heads, head_dim, 4 * hidden_dim,
                             dropout_rate, layernorm_epsilon, attention_fn,
                             tp_size, dtype, device)
            for _ in range(depth))
        self.ln_f = LayerNorm(hidden_dim, layernorm_epsilon, device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init with flax's initializers (normal 0.02 / 0.01
        embeddings, lecun_normal kernels, zero biases, unit LayerNorm
        scales), drawn from ``generator``. Not the flax init's numbers:
        the tests convert flax's parameters instead."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                cache=None, cache_positions: Optional[torch.Tensor] = None):
        """Causal LM forward; three modes, selected by ``cache``:

        * ``cache=None``: the eval forward, (B, S, vocab) float32 logits;
        * prefill (``cache`` given, ``cache_positions=None``): the same
          causal forward over the padded prompt, also returning the
          per-block (k, v) caches filled at slots [0, S);
        * decode (``cache`` and ``cache_positions`` (B,) int): S new tokens
          per row starting at that row's own position; row j of the window
          attends cache slots ``<= position + j``.

        With a cache the return value is ``(logits, new_cache)``.
        """
        b, s = input_ids.shape
        dev = input_ids.device
        decoding = cache is not None and cache_positions is not None
        x = self.wte(input_ids)
        if decoding and s == 1:
            pos_ids = cache_positions[:, None]
        elif decoding:
            pos_ids = torch.clamp(
                cache_positions[:, None] + torch.arange(s, device=dev)[None],
                max=self.max_position - 1)
        else:
            pos_ids = torch.arange(s, device=dev)[None, :]
        x = x + self.wpe(pos_ids)

        if decoding:
            t = cache[0][0].shape[1]
            win = cache_positions[:, None] + torch.arange(s, device=dev)[None]
            mask = (torch.arange(t, device=dev)[None, None, :]
                    <= win[:, :, None])[:, None, :, :]
        elif self.uses_kernel:
            # the kernel owns causality: only the padding mask, or none
            mask = (attention_mask[:, None, None, :].bool()
                    if attention_mask is not None else None)
        else:
            mask = causal_mask(s, dev)
            if attention_mask is not None:
                mask = mask & attention_mask[:, None, None, :].bool()

        new_cache = []
        for i, block in enumerate(self.blocks):
            if cache is None:
                x = (remat_call(block, x, mask) if self.remat
                     else block(x, mask=mask))
            else:
                x, c = block(x, mask=mask, cache=cache[i],
                             cache_positions=cache_positions)
                new_cache.append(c)

        x = self.ln_f(x)
        logits = mask_vocab_padding(self.wte.attend(x).float(),
                                    self.vocab_size)
        return logits if cache is None else (logits, tuple(new_cache))

    def init_cache(self, batch: int, max_len: int, device=None):
        """Zero-filled per-block (k, v) cache: ``depth`` pairs of
        (batch, max_len, heads, head_dim) tensors in the compute dtype."""
        shape = (batch, max_len, self.num_heads,
                 self.hidden_dim // self.num_heads)
        return tuple((torch.zeros(shape, dtype=self.dtype, device=device),
                      torch.zeros(shape, dtype=self.dtype, device=device))
                     for _ in range(self.depth))

    def init_paged_pool(self, n_pages: int, page_size: int,
                        quantized: bool = False, device=None):
        """Zero-filled paged KV pool: one `layers.PagedKV` stacked over
        all ``depth`` blocks, (depth, n_pages, page_size, heads, head_dim)
        pages in the compute dtype, or int8 codes and per-row float32
        scales when ``quantized``. The continuous engine
        (``serving/continuous.py``) gathers a slot's pages into the dense
        cache shape `init_cache` gives, so the decode forward runs
        unchanged."""
        return init_paged_kv(self.depth, n_pages, page_size, self.num_heads,
                             self.hidden_dim // self.num_heads,
                             dtype=self.dtype, quantized=quantized,
                             device=device)


@register_model("gpt2_355m")
def gpt2_355m(**kw) -> GPT2LMHead:
    """GPT-2 medium (355M). Config values are defaults; callers may
    override any of them."""
    cfg = dict(hidden_dim=1024, depth=24, num_heads=16)
    cfg.update(kw)
    return GPT2LMHead(**cfg)


@register_model("gpt2_124m")
def gpt2_124m(**kw) -> GPT2LMHead:
    """GPT-2 small (124M)."""
    cfg = dict(hidden_dim=768, depth=12, num_heads=12)
    cfg.update(kw)
    return GPT2LMHead(**cfg)
