"""The per-rank image loader (the JAX package's data/loader.py).

Each rank walks its slice of the sampler's global plan (``process_index =
rank``, ``process_count = world``), gathers its uint8 images and labels on
the host, and copies them to its device from pinned host memory with
``non_blocking``; the caching host allocator keeps a pinned block until
its copy has run. Every batch carries the sampler's ``weight`` mask, which
gives ``drop_last=False`` at a fixed batch shape.

Batches: {"image": uint8 (B, H, W, C), "label": int64 (B,), "weight":
float32 (B,)}; normalization and augmentation run on the device
(``data/augment.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .. import native
from .datasets import ArrayDataset
from .sampler import ShardedSampler


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory with a
    non-blocking copy on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class ShardedLoader:
    """This rank's batches of an ArrayDataset, ``per_device_batch`` rows
    each, from a global batch of ``per_device_batch * process_count``."""

    def __init__(self, dataset: ArrayDataset, per_device_batch: int,
                 shuffle: bool, seed: int = 42, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1,
                 device: torch.device = torch.device("cpu"),
                 fault_hook: Optional[Callable[[int], None]] = None):
        # the loader_stall injection point: called with the step index
        # before that step's batch is produced (None: no chaos plan)
        self.fault_hook = fault_hook
        self.dataset = dataset
        self.device = torch.device(device)
        self.global_batch = per_device_batch * process_count
        self.sampler = ShardedSampler(
            n=len(dataset), global_batch=self.global_batch, shuffle=shuffle,
            seed=seed, drop_last=drop_last, process_index=process_index,
            process_count=process_count)

    def __len__(self) -> int:
        return self.sampler.steps_per_epoch()

    def epoch(self, epoch: int, start_step: int = 0
              ) -> Iterator[Dict[str, torch.Tensor]]:
        images, labels = self.dataset.images, self.dataset.labels
        for k, (idx, w) in enumerate(self.sampler.iter_epoch(epoch,
                                                             start_step)):
            if self.fault_hook is not None:
                self.fault_hook(start_step + k)
            yield {
                "image": to_device(native.gather_rows(images, idx),
                                   self.device),
                "label": to_device(labels[idx].astype(np.int64),
                                   self.device),
                "weight": to_device(w, self.device),
            }
