"""Pipelined GPT-2 (the JAX package's models/gpt2_pipe.py): the LM's
blocks run as GPipe stages over the mesh's ``pipe`` axis
(``parallel/pipeline.py``), trained through the same Trainer and task as
every other model (``--mesh pipe=P[,data=D] --microbatches M``).

The parameters are the JAX tree: ``wte/embedding``, ``wpe/embedding``,
``ln_f/{scale,bias}`` and the stage-stacked block leaves
``blocks/<block path>`` of shape (P, L/P, ...), one block's leaves
stacked over the layers in stage-major order (layer p L/P + j at
[p, j]). A stage-local model (``pipe``, an axis of size P > 1, given by
``clone``) holds its (1, L/P, ...) slice of every stacked leaf and the
replicated embeddings and final LayerNorm whole; the leading dim is the
one ``partition_rules`` puts on ``pipe``, so the Trainer cuts, joins and
checkpoints the stages as it does tensor parallelism's split leaves
(``convert.tp_local_params``, ``parallel/sharding.py``). The stage's L/P
blocks are these stacked leaves, not modules of their own: each layer
runs one template ``TransformerBlock`` (no parameters of its own) on its
[0, j] slices (``torch.func.functional_call``), as JAX scans one block
over the stacked leaves. The model without ``pipe`` holds every stage,
(P, L/P, ...), and runs the layers in order: the global model the entry
draws, sliced by the Trainer.

As in JAX: attention inside the stages is always the einsum (no kernel;
the entry refuses ``--attention`` other than ``xla``/``auto`` with
``pipe`` > 1), the embeddings are looked up in the parameters' float32
and cast to ``dtype`` after adding the positions, the final LayerNorm and
the tied head run by hand in float32, there is no vocab padding and no
dropout, ``remat`` recomputes each stage layer (``remat_call``), and a
depth that does not divide into the stages is refused with JAX's message.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..parallel.collectives import TpAxis
from ..parallel.mesh import PIPE
from ..parallel.pipeline import pipeline_apply
from ..parallel.sharding import PartitionRules
from .layers import Embed, LayerNorm, TransformerBlock, causal_mask, \
    remat_call


def _block(hidden_dim: int, num_heads: int, layernorm_epsilon: float,
           dtype: torch.dtype, device=None) -> TransformerBlock:
    return TransformerBlock(hidden_dim, num_heads, hidden_dim // num_heads,
                            4 * hidden_dim, 0.0, layernorm_epsilon,
                            dtype=dtype, device=device)


class GPT2PipeLMHead(nn.Module):
    """GPT-2 with its blocks run as a GPipe pipeline over ``pipe``.
    ``num_stages`` is the mesh's ``pipe`` size (P); ``pipe``, when given,
    is this rank's place on that axis and makes the model stage-local."""

    def __init__(self, num_stages: int = 1, num_microbatches: int = 2,
                 vocab_size: int = 50257, hidden_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 max_position: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 layernorm_epsilon: float = 1e-5, remat: bool = False,
                 pipe: Optional[TpAxis] = None, device=None):
        super().__init__()
        if depth % num_stages:
            raise ValueError(f"depth {depth} not divisible into "
                             f"{num_stages} pipeline stages")
        self.pipe = pipe if pipe is not None else TpAxis(1)
        if self.pipe.size not in (1, num_stages):
            raise ValueError(f"a pipe axis of {self.pipe.size} ranks for "
                             f"{num_stages} pipeline stages")
        self._config = dict(
            num_stages=num_stages, num_microbatches=num_microbatches,
            vocab_size=vocab_size, hidden_dim=hidden_dim, depth=depth,
            num_heads=num_heads, max_position=max_position, dtype=dtype,
            layernorm_epsilon=layernorm_epsilon, remat=remat, pipe=pipe)
        self.num_stages, self.num_microbatches = num_stages, num_microbatches
        self.vocab_size, self.hidden_dim = vocab_size, hidden_dim
        self.depth, self.num_heads = depth, num_heads
        self.max_position, self.dtype = max_position, dtype
        self.layernorm_epsilon, self.remat = layernorm_epsilon, remat
        self.wte = Embed(vocab_size, hidden_dim, 0.02, device)
        self.wpe = Embed(max_position, hidden_dim, 0.01, device)
        # the stacked leaves: a block whose every parameter has the
        # (stages held, L/P) dims in front
        stages = num_stages if self.pipe.size == 1 else 1
        self.blocks = _block(hidden_dim, num_heads, layernorm_epsilon,
                             dtype, "meta")
        for module in self.blocks.modules():
            for name, p in list(module._parameters.items()):
                module._parameters[name] = nn.Parameter(torch.empty(
                    (stages, depth // num_stages, *p.shape), device=device))
        self.ln_f = LayerNorm(hidden_dim, layernorm_epsilon, device)
        # the block every layer runs, on its slices (not a submodule: it
        # holds no parameters of the model)
        self.__dict__["_template"] = _block(hidden_dim, num_heads,
                                            layernorm_epsilon, dtype, "meta")

    def clone(self, **changes) -> "GPT2PipeLMHead":
        """A new model of this configuration with ``changes`` (``pipe``
        makes it stage-local), its parameters uninitialized."""
        return type(self)(**{**self._config, **changes})

    @staticmethod
    def partition_rules() -> PartitionRules:
        """The stage-stacked block leaves ride ``pipe`` on their leading
        dim; the embeddings and the final LayerNorm are replicated."""
        return PartitionRules([(r"blocks/", (PIPE,))])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init with flax's initializers, drawn from ``generator``
        in GPT2LMHead's order (``wte``, ``wpe``, each block in layer
        order, ``ln_f``), so one seed gives a pipelined model and a
        ``gpt2_*`` model of one configuration the same weights. A
        stage-local model refuses, as a tensor-parallel one does."""
        if self.pipe.size > 1:
            raise ValueError(
                "a stage-local model holds one stage of the stacked "
                "blocks: initialize the global model and load its slices "
                "(convert.tp_local_params), so every stage starts from one "
                "draw")
        self.wte.reset_parameters(generator)
        self.wpe.reset_parameters(generator)
        per = self.depth // self.num_stages
        stacked = dict(self.blocks.named_parameters())
        for i in range(self.depth):
            block = _block(self.hidden_dim, self.num_heads,
                           self.layernorm_epsilon, self.dtype)
            for module in block.modules():
                if module is not block and hasattr(module,
                                                   "reset_parameters"):
                    module.reset_parameters(generator)
            for name, p in block.named_parameters():
                stacked[name][i // per, i % per].copy_(p)
        self.ln_f.reset_parameters(generator)

    def _apply_layer(self, mask):
        block = self._template

        def apply_layer(layer, h):
            def call(x):
                return functional_call(block, layer, (x,), {"mask": mask})

            if self.remat:
                return remat_call(call, h)
            return call(h)

        return apply_layer

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S, vocab) float32 logits, the same on every stage."""
        b, s = input_ids.shape
        x = F.embedding(input_ids, self.wte.embedding) + self.wpe.embedding[:s]
        x = x.to(self.dtype)
        mask = causal_mask(s, input_ids.device)
        x = pipeline_apply(self._apply_layer(mask),
                           dict(self.blocks.named_parameters()), x,
                           self.pipe, self.num_microbatches)
        # the final LayerNorm and the tied head by hand, in float32
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mean).mean(-1, keepdim=True)
        xn = (xf - mean) * torch.rsqrt(var + self.layernorm_epsilon)
        xn = xn * self.ln_f.scale.float() + self.ln_f.bias.float()
        return xn @ self.wte.embedding.float().T
