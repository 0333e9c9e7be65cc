"""ViT-B/16 (the JAX package's models/vit.py, as an ``nn.Module``): the
"ViT-B/16 / ImageNet bf16 (AMP-path parity)" configuration.

Torchvision-equivalent architecture: a 16x16 stride-16 convolution
embeds the patches, a CLS token and learned position embeddings join
them, then pre-LN transformer blocks, a final LN and a linear head on the
CLS row. 86,567,656 parameters at 224x224 and 1000 classes. Parameters
keep flax's names and layouts (``convert.py``): the patch kernel is HWIO,
and the patches are flattened in flax's NHWC order (row-major over the
patch grid). flax sizes ``pos_embedding`` from its first input; here
``image_size`` gives it. The attention is the plain einsum, as on the JAX
package's image path. ``remat`` recomputes each block in the backward.
Images are NHWC; ``forward(x, train=True)`` returns ``(logits, {})`` (no
BatchNorm statistics), as the image task expects.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Dense,
    LayerNorm,
    TransformerBlock,
    _TRUNC_STD,
    dot_product_attention,
    remat_call,
)
from .registry import register_model
from .resnet import same_padding


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(features, (p, p), strides=(p, p))`` with its bias:
    an HWIO ``kernel``, ``SAME`` padding, NCHW activations."""

    def __init__(self, in_channels: int, features: int, patch: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.kernel = nn.Parameter(torch.empty(patch, patch, in_channels,
                                               features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        (t, b), (l, r) = (same_padding(x.shape[2], p, p),
                          same_padding(x.shape[3], p, p))
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        y = F.conv2d(x, self.kernel.to(self.dtype).permute(3, 2, 0, 1),
                     stride=p)
        return y + self.bias.to(self.dtype)[:, None, None]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun_normal kernel, zero bias."""
        std = math.sqrt(1.0 / math.prod(self.kernel.shape[:3])) / _TRUNC_STD
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.bias.zero_()


class ViT(nn.Module):

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 layernorm_epsilon: float = 1e-6,
                 attention_fn=dot_product_attention, remat: bool = False,
                 image_size: Union[int, Sequence[int]] = 224,
                 device=None):
        super().__init__()
        h, w = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        self.num_classes, self.hidden_dim = num_classes, hidden_dim
        self.dtype, self.remat = dtype, remat
        self.patch_embed = PatchEmbed(3, hidden_dim, patch_size, dtype,
                                      device)
        tokens = -(-h // patch_size) * -(-w // patch_size) + 1
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden_dim,
                                                  device=device))
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, hidden_dim,
                                                      device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_dim, num_heads, hidden_dim // num_heads,
                             mlp_dim, dropout_rate, layernorm_epsilon,
                             attention_fn, dtype=dtype, device=device)
            for _ in range(depth))
        self.ln_final = LayerNorm(hidden_dim, layernorm_epsilon, device,
                                  dtype)
        self.head = Dense(hidden_dim, num_classes, device=device,
                          dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init with flax's initializers (a zero CLS token, normal
        0.02 position embeddings), drawn from ``generator``."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        self.cls_token.zero_()
        self.pos_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False):
        """NHWC images -> (N, num_classes) float32 logits; ``(logits, {})``
        with ``train``."""
        n = x.shape[0]
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                  # (N, S, D)
        cls = self.cls_token.to(self.dtype).expand(n, 1, self.hidden_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(self.dtype)
        for block in self.blocks:
            x = remat_call(block, x) if self.remat else block(x)
        logits = self.head(self.ln_final(x)[:, 0]).float()
        return (logits, {}) if train else logits


@register_model("vit_b16")
def vit_b16(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, **kw)
