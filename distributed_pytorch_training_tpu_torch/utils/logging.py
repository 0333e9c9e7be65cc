"""Main-process-only logging (the reference's rank-0 print convention)."""

from __future__ import annotations

import sys

import torch.distributed as dist


def is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def log_main(*args, **kwargs) -> None:
    """print() on process 0 only."""
    if is_main_process():
        print(*args, **kwargs)
        sys.stdout.flush()
