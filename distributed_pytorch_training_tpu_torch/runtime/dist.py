"""Process runtime, single-process (the JAX package's runtime/dist.py).

The port trains in one process on one device so far. ``WORLD_SIZE > 1``
(the torchrun contract) raises: multi-process training comes with the
data-parallel slice, which will call ``torch.distributed
.init_process_group`` here.
"""

from __future__ import annotations

import dataclasses
import os
import random

import numpy as np
import torch

from . import not_ported


@dataclasses.dataclass(frozen=True)
class DistContext:
    """The ``(rank, world_size, local_rank)`` of the process."""

    process_index: int
    process_count: int
    local_device_count: int
    device_count: int

    @property
    def is_main(self) -> bool:
        """True on the process that writes logs and metrics."""
        return self.process_index == 0


def setup_distributed() -> DistContext:
    """The process context; raises for a multi-process launch."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise not_ported(f"multi-process training (WORLD_SIZE={world})",
                         "the data-parallel slice")
    return DistContext(process_index=0, process_count=1,
                       local_device_count=1, device_count=1)


def cleanup_distributed() -> None:
    """Tear down the process group, if one was initialized."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def barrier(name: str = "") -> None:
    """Wait for every process: a no-op in one process."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.barrier()


def per_process_seed(seed: int, process_index: int = 0) -> int:
    """The reference's per-rank seed rule: ``seed + rank``."""
    return seed + process_index


def set_seed(seed: int, process_index: int = 0) -> np.random.Generator:
    """Seed Python's, NumPy's and PyTorch's global generators with
    ``seed + rank`` and return a dedicated NumPy generator for host-side
    use."""
    s = per_process_seed(seed, process_index)
    random.seed(s)
    np.random.seed(s % (2 ** 32))
    torch.manual_seed(s)
    return np.random.default_rng(s)
