"""ResNet-18/50 (the JAX package's models/resnet.py) with flax's leaf names,
layouts and numerics, so ``convert.py`` carries weights and BatchNorm
statistics across by renaming alone.

* Images come in NHWC, as in the JAX package; the model copies them to
  contiguous NCHW (torch's CPU convolution backward crashes, multi-threaded,
  on some channels-last batches of 4 or 6; the CPU tests run there).
* Conv kernels are HWIO parameters ``(kh, kw, in, out)``, applied with
  flax's ``SAME`` padding: for a stride-2 conv on an even input that pads
  one more row and column after than before (a 7x7/2 stem pads (2, 3)),
  which torch's symmetric ``padding=3`` does not.
* ``BatchNorm`` is flax's, not ``nn.BatchNorm2d``'s: the batch variance is
  the biased E[x^2] - E[x]^2 clipped at 0 (flax ``use_fast_variance``),
  and the running statistics update as ``0.9 * ra + 0.1 * batch`` with
  that biased variance (torch's running var takes the unbiased one).
  Statistics cover every row of the batch, weight-0 padding included, as
  in the JAX step. With a ``sync_group`` (the Trainer's implicit
  multi-rank path) they cover the GLOBAL batch, as a data-sharded jit
  computes them (SyncBN semantics): one differentiable all-reduce of the
  per-channel sum and sum of squares, whose backward all-reduces their
  gradients. Not ``nn.SyncBatchNorm``, whose running variance is the
  unbiased one and whose statistics combine per-rank Welford moments.
* ``dtype`` is flax's compute dtype (bf16 under ``--amp``) beside float32
  parameters: convolutions and the dense head cast their inputs and
  kernels to it; BatchNorm computes its statistics and normalizes in
  float32 (flax's ``_compute_stats`` promotes to at least float32, and
  its float32 statistics promote the arithmetic) and casts the result to
  ``dtype``; the running statistics and the logits stay float32.
* In train mode the forward does not touch the running statistics: it
  returns ``(logits, new_stats)``, the updated statistics by buffer name,
  and the Trainer decides what to write (one EMA update per step, averaged
  over microbatches and ranks).
* The stem max-pool pads (1, 1) on each side (``max_pool2d(3, 2, 1)``);
  ``cifar_stem`` gives the 3x3/1 stem without it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Type

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import Group, all_sum, world_size
from .layers import Dense
from .registry import register_model

Stats = Optional[Dict[str, torch.Tensor]]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: an HWIO kernel, ``SAME`` padding."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int], strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*kernel_size, in_features,
                                               features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        (t, b), (l, r) = (same_padding(x.shape[2], kh, self.strides),
                          same_padding(x.shape[3], kw, self.strides))
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)  # OIHW view
        if t == b and l == r:
            return F.conv2d(x, w, stride=self.strides, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.strides)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's ``variance_scaling(2.0, "fan_out", "normal")``:
        normal with variance 2 / (kh * kw * out)."""
        kh, kw, _, out = self.kernel.shape
        self.kernel.normal_(0.0, math.sqrt(2.0 / (kh * kw * out)),
                            generator=generator)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of an NCHW tensor. Parameters ``scale``, ``bias``; the running
    ``mean`` and ``var`` are buffers (flax's ``batch_stats``).
    ``sync_group``: None normalizes by this rank's batch; a process group
    normalizes by the global batch over its ranks (set by the Trainer)."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, features: int, zero_scale: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.zero_scale = zero_scale
        self.dtype = dtype
        self.sync_group: Group = None
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.stats_name = ""       # its buffer prefix, set by the ResNet

    def forward(self, x: torch.Tensor, new_stats: Stats = None
                ) -> torch.Tensor:
        x = x.float()
        if new_stats is None:
            mean, var = self.mean, self.var
        else:
            count = x.numel() // x.shape[1]
            sums = torch.stack([x.sum(dim=(0, 2, 3)),
                                (x * x).sum(dim=(0, 2, 3))])
            if self.sync_group is not None:
                sums = all_sum(sums, self.sync_group)
                count *= world_size(self.sync_group)
            mean, mean_sq = (sums / count).unbind(0)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            m = self.momentum
            new_stats[self.stats_name + "mean"] = (
                m * self.mean + (1 - m) * mean.detach())
            new_stats[self.stats_name + "var"] = (
                m * self.var + (1 - m) * var.detach())
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None]).to(self.dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(in_features, features, (3, 3), strides, dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = Conv(features, features, (3, 3), dtype=dtype)
        self.bn2 = BatchNorm(features, zero_init_residual, dtype)
        self.downsample_conv = self.downsample_bn = None
        if strides != 1 or in_features != features:
            self.downsample_conv = Conv(in_features, features, (1, 1),
                                        strides, dtype)
            self.downsample_bn = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, new_stats: Stats = None
                ) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), new_stats))
        y = self.bn2(self.conv2(y), new_stats)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), new_stats)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with 4x expansion (ResNet-50+)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv(in_features, features, (1, 1), dtype=dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = Conv(features, features, (3, 3), strides, dtype)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.conv3 = Conv(features, out, (1, 1), dtype=dtype)
        self.bn3 = BatchNorm(out, zero_init_residual, dtype)
        self.downsample_conv = self.downsample_bn = None
        if strides != 1 or in_features != out:
            self.downsample_conv = Conv(in_features, out, (1, 1), strides,
                                        dtype)
            self.downsample_bn = BatchNorm(out, dtype=dtype)

    def forward(self, x: torch.Tensor, new_stats: Stats = None
                ) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), new_stats))
        y = F.relu(self.bn2(self.conv2(y), new_stats))
        y = self.bn3(self.conv3(y), new_stats)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), new_stats)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Images (N, H, W, C) float, already normalized -> (N, num_classes)
    float32 logits, computed in ``dtype``. Blocks are attributes
    ``stage{s}_block{b}``, as the flax module names them."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: Type[nn.Module],
                 num_classes: int = 1000, num_filters: int = 64,
                 cifar_stem: bool = False, zero_init_residual: bool = False,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.cifar_stem = cifar_stem
        self.dtype = dtype
        stem_kernel = (3, 3) if cifar_stem else (7, 7)
        self.stem_conv = Conv(in_channels, num_filters, stem_kernel,
                              1 if cifar_stem else 2, dtype)
        self.stem_bn = BatchNorm(num_filters, dtype=dtype)
        self.block_names = []
        features = num_filters
        for stage, n_blocks in enumerate(stage_sizes):
            width = num_filters * 2 ** stage
            for block in range(n_blocks):
                name = f"stage{stage + 1}_block{block}"
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(name, block_cls(features, width, strides,
                                                zero_init_residual, dtype))
                self.block_names.append(name)
                features = width * block_cls.expansion
        self.fc = Dense(features, num_classes, dtype=dtype)
        for name, module in self.named_modules():
            if isinstance(module, BatchNorm):
                module.stats_name = name + "."

    def forward(self, x: torch.Tensor, train: bool = False):
        """Eval (``train=False``): logits from the running statistics.
        Train: ``(logits, new_stats)`` from the batch statistics."""
        new_stats: Stats = {} if train else None
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous()   # NCHW
        x = F.relu(self.stem_bn(self.stem_conv(x), new_stats))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, new_stats)
        # the pool sums in float32 and rounds once, as jnp.mean does
        logits = self.fc(x.float().mean(dim=(2, 3)).to(self.dtype)).float()
        return (logits, new_stats) if train else logits

    def set_stats_group(self, group: Group) -> None:
        """Normalize every BatchNorm over the ranks of ``group`` (None:
        over this rank's batch)."""
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.sync_group = group

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init with the JAX model's initializers, drawn from
        ``generator`` (not the flax init's numbers: the tests convert
        flax's parameters instead)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)


@register_model("resnet18")
def resnet18(num_classes: int = 10, **kw) -> ResNet:
    """torchvision's resnet18(num_classes=10) with flax's numerics."""
    return ResNet(stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock,
                  num_classes=num_classes, **kw)


@register_model("resnet50")
def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck,
                  num_classes=num_classes, **kw)
