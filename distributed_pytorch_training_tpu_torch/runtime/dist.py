"""Process runtime (the JAX package's runtime/dist.py) on
``torch.distributed``.

The launch contract is torchrun's (``env://``): ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` in the environment, the store at
``MASTER_ADDR:MASTER_PORT``. ``WORLD_SIZE`` unset or 1 is one process and
no process group, as the reference's ``(0, 1, 0)`` fast path.

Rank r runs on ``cuda:(LOCAL_RANK % device_count)``. The backend follows
one rule, and the entry prints it in its banner:

* ``nccl`` when the device is CUDA and every local rank has a card of its
  own (``LOCAL_WORLD_SIZE <= device_count``);
* ``gloo`` on the CPU, or when ranks share a card (NCCL refuses two ranks
  on one device). Gloo moves CUDA tensors through host memory.

There is no ``try`` around NCCL that drops to gloo: a failing NCCL init
raises.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DistContext:
    """The ``(rank, world_size, local_rank)`` of the process, its device
    and the process group's backend (None in one process)."""

    process_index: int
    process_count: int
    local_device_count: int
    device_count: int
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None

    @property
    def is_main(self) -> bool:
        """True on the process that writes logs and metrics."""
        return self.process_index == 0


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value.strip() else default


def choose_backend(device_type: str, local_world: int,
                   cuda_devices: int) -> str:
    """The module docstring's rule: NCCL when every local rank has a card
    of its own, gloo on the CPU or when ranks share a card."""
    if device_type == "cuda" and local_world <= cuda_devices:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The device of a local rank: ``cuda:(local_rank % device_count)``
    for a CUDA device, the CPU as is."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def setup_distributed(device: torch.device = torch.device("cpu"),
                      init_method: str = "env://") -> DistContext:
    """Join the process group when ``WORLD_SIZE > 1`` and return the
    process context, with this rank's device. ``init_method`` is torchrun's
    ``env://`` by default; the tests pass a ``file://`` store."""
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    dev = rank_device(torch.device(device), local_rank)
    if world <= 1:
        return DistContext(process_index=0, process_count=1,
                           local_device_count=1, device_count=1,
                           device=dev)
    cuda_devices = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, local_world, cuda_devices)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    return DistContext(process_index=rank, process_count=world,
                       local_device_count=1, device_count=world,
                       local_rank=local_rank, device=dev, backend=backend)


def cleanup_distributed() -> None:
    """Tear down the process group, if one was initialized."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier(name: str = "") -> None:
    """Wait for every process: a no-op in one process."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


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
