"""Mixture-of-Experts GPT-2 (the JAX package's models/moe.py): top-k
token-choice routing with a fixed capacity per expert, and expert
parallelism over the mesh's ``expert`` axis.

``MoeMlp`` keeps JAX's two dispatch formulations: ``sorted`` (the
default: a stable argsort of the assignments by expert, first-choice
major, each assignment's rank in its expert's segment, ranks past the
capacity sent to an overflow bin at E C, a scatter-add of the tokens
into the (B, E C + 1, d) buffer and a gather back) and ``einsum`` (the
dense one-hot (B, S, E, C) dispatch and combine tensors, the oracle).
Each batch row routes on its own, with ``ceil(S k / E cf)`` slots an
expert. The router is a float32 Dense and its softmax float32; the
expert products are einsums over the stacked ``wi`` (E, d, 4d) and
``wo`` (E, 4d, d), as JAX computes them (no kernel).

The Switch load-balancing loss, ``E sum_e frac_tokens_e frac_probs_e /
k``, is not sown into a flax collection: each forward of
``GPT2MoELMHead`` resets its ``aux_losses`` list and appends every MoE
layer's (``MoeMlp.last_aux``), and ``training/tasks.py``'s
``MoeLanguageModelingTask`` reads the list after the forward.

Expert parallelism (``expert``, an axis of size ep > 1): a rank holds
experts [r E/ep, (r+1) E/ep) of every MoE layer (``moe_rules``: ``wi``
and ``wo`` split on dim 0). The router, the top-k and the aux loss run
alike on every expert rank of a batch coordinate, which hold the same
tokens. The expert region: the dispatched tokens and the combine gates
enter through ``copy_to_tp`` over the expert group (identity forward,
SUM backward, so the router and everything upstream get the whole
gradient on every rank), each rank runs its own experts and combines
their share of each token, and ``reduce_from_tp`` sums the shares. A
rank's view of the other experts' slots reads zeros, so the sum is the
one-rank combine, term for term.

Tensor parallelism (``tp``, the ``model`` axis, M > 1; ``moe_rules() +
tp_fsdp_rules()``): attention and the dense blocks' MLPs take megatron's
column/row-split forms and ``wte`` is vocab-split (the vocab padded to
lcm(128, M) by the entry), as GPT-2's; the router and every MoE layer's
experts stay whole on every model rank (the rules place ``wi`` and ``wo``
on ``expert`` only), so each model rank routes and runs the experts
alike and their gradients need no model-axis sum.

Sequence parallelism (``seq``, M > 1): a rank embeds and runs its own S/N
positions (``pos_offset``, as GPT-2). GShard's routing groups are whole
rows, so each MoE layer gathers its input's row over ``seq``
(``collectives.gather_on_use``: the backward sums over the seq ranks and
keeps this rank's slice), routes and runs the experts on the whole row,
bitwise the unsharded dispatch on the same row, and keeps its own
positions of the output. ``frac_tokens`` and ``frac_probs`` are means
over the global batch: over the ranks of the batch line (``batch``, the
data x fsdp ranks) they are summed (``all_sum``, differentiable) and
divided by its size, so the aux loss is JAX's global one on every rank.
``last_dispatch`` keeps each assignment's destination slot of the last
forward (the overflow bin, E C, for a dropped one).

``router_noise`` > 0 draws from flax's ``dropout`` stream, which the port
does not reproduce: it is refused, as dropout is. ``remat`` recomputes
the dense blocks only, as JAX's.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import (TpAxis, all_sum, copy_to_tp,
                                    gather_on_use, psum, reduce_from_tp)
from ..parallel.mesh import EXPERT
from ..parallel.sharding import PartitionRules
from ..runtime import not_ported
from .layers import (Dense, Embed, LayerNorm, MultiHeadAttention,
                     TransformerBlock, VocabPaddingMixin, _TRUNC_STD,
                     causal_mask, dot_product_attention, gelu,
                     mask_vocab_padding, remat_call, tp_fsdp_rules,
                     vocab_parallel_embed, vocab_parallel_logits)
from .registry import register_model

ROUTER_NOISE = "the dropout slice (flax's dropout stream for router noise)"


def expert_capacity(seq_len: int, top_k: int, num_experts: int,
                    capacity_factor: float) -> int:
    """Slots an expert a batch row: ``ceil(S k / E cf)``, at least 1 (k
    assignments a token, so the slots cover S k routing decisions)."""
    return max(1, int(math.ceil(seq_len * top_k / num_experts
                                * capacity_factor)))


class MoeMlp(nn.Module):
    """Top-k token-choice MoE feed-forward (in place of the MLP block).
    ``last_aux`` is the aux loss of its last forward."""

    def __init__(self, features: int, num_experts: int, hidden_dim: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32,
                 activation: Callable = gelu, router_noise: float = 0.0,
                 dispatch_mode: str = "sorted",
                 expert: Optional[TpAxis] = None,
                 seq: Optional[TpAxis] = None,
                 batch: Optional[TpAxis] = None, device=None):
        super().__init__()
        if router_noise:
            raise not_ported("router_noise > 0", ROUTER_NOISE)
        if dispatch_mode not in ("sorted", "einsum"):
            raise ValueError(f"dispatch_mode {dispatch_mode!r} is not "
                             "'sorted' or 'einsum'")
        self.expert = expert = expert if expert is not None else TpAxis(1)
        self.seq = seq if seq is not None else TpAxis(1)
        self.batch = batch if batch is not None else TpAxis(1)
        if num_experts % expert.size:
            raise ValueError(f"num_experts={num_experts} not divisible by "
                             f"the mesh's expert={expert.size}")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.activation, self.dispatch_mode = activation, dispatch_mode
        self.router = Dense(features, num_experts, use_bias=False,
                            device=device)
        local = num_experts // expert.size
        self.wi = nn.Parameter(torch.empty(local, features, hidden_dim,
                                           device=device))
        self.wo = nn.Parameter(torch.empty(local, hidden_dim, features,
                                           device=device))
        self.last_aux: Optional[torch.Tensor] = None
        self.last_dispatch: Optional[torch.Tensor] = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's lecun_normal with the expert axis as a batch axis: the
        fan-in is dim -2. (The router, a Dense, draws its own.)"""
        for w in (self.wi, self.wo):
            std = math.sqrt(1.0 / w.shape[-2]) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq, width = self.seq, x.shape[1]
        # GShard's groups are whole rows: a sequence shard gathers its row
        x = gather_on_use(x, 1, seq)
        b, s, d = x.shape
        e, k = self.num_experts, self.top_k
        cap = expert_capacity(s, k, e, self.capacity_factor)
        logits = self.router(x.float())   # (B, S, E), float32
        probs = torch.softmax(logits, dim=-1)
        dispatch = (self._dispatch_sorted if self.dispatch_mode == "sorted"
                    else self._dispatch_einsum)
        xin, combine_fn, frac_tokens = dispatch(x, probs, b, s, d, e, cap)
        frac_probs = probs.reshape(-1, e).mean(0)
        batch = self.batch
        if batch.size > 1:
            # means over the global batch (every rank holds as many rows)
            frac_probs = all_sum(frac_probs, batch.group) / batch.size
            frac_tokens = psum(frac_tokens, batch.group) / batch.size
        self.last_aux = e * torch.sum(frac_tokens * frac_probs) / k
        # this rank's experts: slots [lo, lo + E/ep) of the buffer
        ep = self.expert
        n_local = e // ep.size
        lo = ep.index * n_local
        xin = copy_to_tp(xin, ep)[:, lo:lo + n_local]
        h = self.activation(torch.einsum(
            "becd,edh->bech", xin, self.wi.to(self.dtype)))
        out = torch.einsum("bech,ehd->becd", h, self.wo.to(self.dtype))
        y = reduce_from_tp(combine_fn(out, lo, n_local), ep)
        return y[:, seq.index * width:(seq.index + 1) * width] \
            if seq.size > 1 else y

    def _topk(self, probs, b, s):
        """(expert ids, gates) per assignment, flattened FIRST-CHOICE
        MAJOR (every k = 0 assignment before any k = 1), the einsum
        oracle's round-robin priority."""
        gates, choice = torch.topk(probs, self.top_k, dim=-1)
        eids = choice.transpose(1, 2).reshape(b, self.top_k * s)
        gvals = gates.transpose(1, 2).reshape(b, self.top_k * s)
        return eids, gvals

    def _dispatch_sorted(self, x, probs, b, s, d, e, cap):
        """Rank each assignment within its expert by a stable argsort,
        send ranks >= capacity to the overflow bin at E C, scatter the
        tokens into the (B, E C + 1, d) buffer. No (B, S, E, C) tensor."""
        k = self.top_k
        n = k * s
        dev = x.device
        eids, gates = self._topk(probs, b, s)
        sort_idx = torch.argsort(eids, dim=-1, stable=True)
        sorted_e = eids.gather(-1, sort_idx)
        counts = torch.zeros(b, e, dtype=torch.long, device=dev
                             ).scatter_add_(1, eids, torch.ones_like(eids))
        starts = torch.cat([torch.zeros(b, 1, dtype=torch.long, device=dev),
                            counts.cumsum(-1)[:, :-1]], dim=-1)
        ranks_sorted = (torch.arange(n, device=dev)[None, :]
                        - starts.gather(-1, sorted_e))
        inv = torch.argsort(sort_idx, dim=-1, stable=True)
        ranks = ranks_sorted.gather(-1, inv)
        kept = ranks < cap
        # overflow assignments land in a sacrificial bin at E * cap
        dest = torch.where(kept, eids * cap + ranks,
                           torch.full_like(eids, e * cap))
        self.last_dispatch = dest.detach()
        tok = torch.arange(n, device=dev) % s   # k-major: token of slot n
        x_gath = x.to(self.dtype)[:, tok]       # (B, N, d)
        xin_flat = torch.zeros(b, e * cap + 1, d, dtype=self.dtype,
                               device=dev).scatter_add(
            1, dest[..., None].expand(b, n, d), x_gath)
        xin = xin_flat[:, :e * cap].reshape(b, e, cap, d)
        kept_hot = torch.zeros(b, n, e, device=dev).scatter_(
            2, eids[..., None], kept[..., None].float())
        frac_tokens = kept_hot.sum(1).mean(0) / s

        def combine_fn(out, lo, n_local):
            # out: (B, E/ep, C, d), this rank's experts; another rank's
            # slots and the overflow bin read zeros
            first, last = lo * cap, (lo + n_local) * cap
            mine = (dest >= first) & (dest < last)
            local = torch.where(mine, dest - first,
                                torch.full_like(dest, n_local * cap))
            out_flat = torch.cat([out.reshape(b, n_local * cap, d),
                                  out.new_zeros(b, 1, d)], dim=1)
            y_n = out_flat.gather(1, local[..., None].expand(b, n, d))
            y_n = y_n * copy_to_tp(gates, self.expert)[..., None].to(
                self.dtype)
            return y_n.reshape(b, k, s, d).sum(1)

        return xin, combine_fn, frac_tokens

    def _dispatch_einsum(self, x, probs, b, s, d, e, cap):
        """The dense one-hot formulation: (B, S, E, C) dispatch and
        combine tensors. The oracle of the sorted path."""
        dev = x.device
        combine = torch.zeros(b, s, e, cap, device=dev)
        fill = torch.zeros(b, e, dtype=torch.long, device=dev)
        remaining = probs
        total = torch.zeros(b, s, e, device=dev)
        for _ in range(self.top_k):
            choice = remaining.argmax(-1)                 # (B, S)
            onehot = F.one_hot(choice, e).float()         # (B, S, E)
            gate = (probs * onehot).sum(-1)               # (B, S)
            pos = (onehot.cumsum(1) - 1.0) + fill[:, None, :]
            pos_tok = (pos * onehot).sum(-1).long()
            keep = pos_tok < cap
            slot = F.one_hot(pos_tok.clamp(max=cap), cap + 1)[..., :cap
                                                              ].float()
            disp = onehot * keep[..., None]
            combine = combine + (gate[..., None, None] * disp[..., None]
                                 * slot[..., None, :])
            total = total + disp
            fill = fill + disp.sum(1).long()
            remaining = remaining * (1.0 - onehot)
        frac_tokens = total.reshape(-1, e).mean(0)
        dispatch = (combine > 0).to(self.dtype)
        xin = torch.einsum("bsec,bsd->becd", dispatch, x.to(self.dtype))

        def combine_fn(out, lo, n_local):
            local = copy_to_tp(combine, self.expert)[:, :, lo:lo + n_local]
            return torch.einsum("bsec,becd->bsd", local.to(self.dtype), out)

        return xin, combine_fn, frac_tokens


def moe_rules() -> PartitionRules:
    """Expert parallelism: the stacked expert weights split over
    ``expert``; the router stays replicated."""
    return PartitionRules([
        (r"moe/wi", (EXPERT, None, None)),
        (r"moe/wo", (EXPERT, None, None)),
    ])


class MoeTransformerBlock(nn.Module):
    """Pre-LN block with the MoE feed-forward in place of the MLP."""

    def __init__(self, features: int, num_heads: int, head_dim: int,
                 num_experts: int, mlp_dim: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32,
                 layernorm_epsilon: float = 1e-5,
                 attention_fn: Callable = dot_product_attention,
                 router_noise: float = 0.0, dispatch_mode: str = "sorted",
                 expert: Optional[TpAxis] = None,
                 tp: Optional[TpAxis] = None, seq: Optional[TpAxis] = None,
                 batch: Optional[TpAxis] = None, device=None):
        super().__init__()
        self.ln1 = LayerNorm(features, layernorm_epsilon, device, dtype)
        self.attn = MultiHeadAttention(features, num_heads, head_dim,
                                       attention_fn=attention_fn, tp=tp,
                                       dtype=dtype, device=device)
        self.ln2 = LayerNorm(features, layernorm_epsilon, device, dtype)
        self.moe = MoeMlp(features, num_experts, mlp_dim, top_k,
                          capacity_factor, dtype,
                          router_noise=router_noise,
                          dispatch_mode=dispatch_mode, expert=expert,
                          seq=seq, batch=batch, device=device)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask=mask)
        return x + self.moe(self.ln2(x))


class GPT2MoELMHead(VocabPaddingMixin, nn.Module):
    """GPT-2-style causal LM with MoE feed-forwards on alternating layers
    (layer i is MoE iff i % moe_every == moe_every - 1). ``expert``, when
    given, makes the model expert-local and ``tp`` model-local
    (``clone``); ``seq`` and ``batch`` are the lines the MoE layers
    gather a row and average the routing statistics over."""

    def __init__(self, vocab_size: int = 50257, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25, moe_every: int = 2,
                 max_position: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 layernorm_epsilon: float = 1e-5,
                 attention_fn: Callable = dot_product_attention,
                 router_noise: float = 0.0, dispatch_mode: str = "sorted",
                 remat: bool = False, pad_vocab_to_multiple_of: int = 0,
                 expert: Optional[TpAxis] = None,
                 tp: Optional[TpAxis] = None, seq: Optional[TpAxis] = None,
                 batch: Optional[TpAxis] = None, device=None):
        super().__init__()
        self._config = dict(
            vocab_size=vocab_size, hidden_dim=hidden_dim, depth=depth,
            num_heads=num_heads, num_experts=num_experts, top_k=top_k,
            capacity_factor=capacity_factor, moe_every=moe_every,
            max_position=max_position, dtype=dtype,
            layernorm_epsilon=layernorm_epsilon, attention_fn=attention_fn,
            router_noise=router_noise, dispatch_mode=dispatch_mode,
            remat=remat, pad_vocab_to_multiple_of=pad_vocab_to_multiple_of,
            expert=expert, tp=tp, seq=seq, batch=batch)
        self.vocab_size, self.hidden_dim = vocab_size, hidden_dim
        self.depth, self.num_heads = depth, num_heads
        self.num_experts, self.moe_every = num_experts, moe_every
        self.max_position, self.dtype, self.remat = max_position, dtype, remat
        self.pad_vocab_to_multiple_of = pad_vocab_to_multiple_of
        self.expert = expert if expert is not None else TpAxis(1)
        self.tp = tp = tp if tp is not None else TpAxis(1)
        self.uses_kernel = attention_fn is not dot_product_attention
        head_dim = hidden_dim // num_heads
        rows = (self.padded_vocab // tp.size if self.tp_vocab
                else self.padded_vocab)
        self.wte = Embed(rows, hidden_dim, 0.02, device, dtype)
        self.wpe = Embed(max_position, hidden_dim, 0.01, device, dtype)
        blocks = []
        for i in range(depth):
            if i % moe_every == moe_every - 1:
                blocks.append(MoeTransformerBlock(
                    hidden_dim, num_heads, head_dim, num_experts,
                    4 * hidden_dim, top_k, capacity_factor, dtype,
                    layernorm_epsilon, attention_fn, router_noise,
                    dispatch_mode, expert, tp, seq, batch, device))
            else:
                blocks.append(TransformerBlock(
                    hidden_dim, num_heads, head_dim, 4 * hidden_dim, 0.0,
                    layernorm_epsilon, attention_fn, tp, dtype=dtype,
                    device=device))
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = LayerNorm(hidden_dim, layernorm_epsilon, device, dtype)
        # the aux losses of the last forward, one a MoE layer
        self.aux_losses: List[torch.Tensor] = []

    def clone(self, **changes) -> "GPT2MoELMHead":
        """A new model of this configuration with ``changes``
        (``expert`` makes it expert-local), its parameters
        uninitialized."""
        return type(self)(**{**self._config, **changes})

    @staticmethod
    def partition_rules() -> PartitionRules:
        return moe_rules() + tp_fsdp_rules()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init with flax's initializers from ``generator`` (not
        the flax init's numbers: the tests carry flax's parameters
        across). An expert-local or model-local model refuses: its
        experts or its split leaves are slices of one global draw."""
        if self.expert.size > 1 or self.tp.size > 1:
            raise ValueError(
                "an expert-parallel model holds a slice of the experts: "
                "initialize the global model and load its slices "
                "(convert.tp_local_params), so every expert rank starts "
                "from one draw")
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                pos_offset: int = 0):
        """(B, S, vocab) float32 logits (this shard's columns as
        ``TpShardedLogits`` when vocab-split); ``aux_losses`` holds this
        forward's aux loss of every MoE layer, in layer order.
        ``input_ids`` may be one sequence shard of longer rows, positions
        ``pos_offset`` onward."""
        b, s = input_ids.shape
        dev = input_ids.device
        tp = self.tp
        self.aux_losses = []
        x = (vocab_parallel_embed(self.wte, input_ids, tp) if self.tp_vocab
             else self.wte(input_ids))
        x = x + self.wpe(pos_offset + torch.arange(s, device=dev)[None])
        if self.uses_kernel:
            # the kernel owns causality: only the padding mask, or none
            mask = (attention_mask[:, None, None, :].bool()
                    if attention_mask is not None else None)
        else:
            mask = causal_mask(s, dev)
            if attention_mask is not None:
                mask = mask & attention_mask[:, None, None, :].bool()
        for block in self.blocks:
            if isinstance(block, MoeTransformerBlock):
                x = block(x, mask=mask)
                self.aux_losses.append(block.moe.last_aux)
            elif self.remat:
                x = remat_call(block, x, mask)
            else:
                x = block(x, mask=mask)
        x = self.ln_f(x)
        if self.tp_vocab:
            return vocab_parallel_logits(self.wte, x, tp, self.vocab_size)
        return mask_vocab_padding(self.wte.attend(x).float(),
                                  self.vocab_size)


@register_model("gpt2_moe")
def gpt2_moe(**kw) -> GPT2MoELMHead:
    """GPT-2-small-sized MoE LM (8 experts, top-2, MoE every other
    layer)."""
    return GPT2MoELMHead(**kw)
