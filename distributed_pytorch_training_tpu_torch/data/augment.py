"""Image augmentation on the device (the JAX package's data/augment.py):
normalize, and RandomCrop(padding) + RandomHorizontalFlip.

``jax.random``'s bits cannot be reproduced here, so the crop offsets and
flip bits are inputs: ``draw_crop_flip`` draws them from a
``torch.Generator`` (on the CPU, so one seed gives the same draws whatever
the device), and ``random_crop_flip`` applies them with a gather. The JAX
module's one-hot einsums are a TPU layout device, not a kernel; the
gather selects the same pixels. Under bf16 compute the JAX module selects
8-bit pixels through a bf16 product, which is exact (0..255 fit in bf16's
8 significand bits, and each output sums one nonzero term), so the
gather's uint8 values are its values at every compute dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def normalize_images(images: torch.Tensor, mean: Sequence[float],
                     std: Sequence[float],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> ``(x / 255 - mean) / std`` (ToTensor + Normalize),
    computed in float32 and cast to ``dtype``, the compute dtype."""
    x = images.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return ((x - m) / s).to(dtype)


def draw_crop_flip(n: int, generator: torch.Generator, padding: int = 4,
                   flip_prob: float = 0.5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(off_h, off_w, flip) for ``n`` images: offsets uniform in
    [0, 2 * padding], flips with probability ``flip_prob``; CPU tensors."""
    off_h = torch.randint(0, 2 * padding + 1, (n,), generator=generator)
    off_w = torch.randint(0, 2 * padding + 1, (n,), generator=generator)
    flip = torch.rand((n,), generator=generator) < flip_prob
    return off_h, off_w, flip


def random_crop_flip(images: torch.Tensor, off_h: torch.Tensor,
                     off_w: torch.Tensor, flip: torch.Tensor,
                     padding: int = 4) -> torch.Tensor:
    """Zero-pad NHWC ``images`` by ``padding``, crop each back to (H, W)
    at its (off_h, off_w), and mirror the columns where ``flip``."""
    n, h, w, c = images.shape
    dev = images.device
    off_h, off_w, flip = off_h.to(dev), off_w.to(dev), flip.to(dev)
    padded = F.pad(images, (0, 0, padding, padding, padding, padding))
    hp, wp = h + 2 * padding, w + 2 * padding
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    rows = off_h[:, None] + ar_h                                  # (N, h)
    cols = torch.where(flip[:, None], off_w[:, None] + (w - 1) - ar_w,
                       off_w[:, None] + ar_w)                     # (N, w)
    flat = padded.reshape(n, hp * wp, c)
    idx = (rows[:, :, None] * wp + cols[:, None, :]).reshape(n, h * w, 1)
    return flat.gather(1, idx.expand(n, h * w, c)).reshape(n, h, w, c)
