"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on. ``None`` means ``cuda``; a CUDA
    device with no CUDA present raises. The CPU runs only when asked for
    by name (``"cpu"``, as the tests ask): there is no quiet fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on a GPU; pass "
                "device='cpu' (--device cpu) only to run the plain "
                "PyTorch versions on the CPU, as the tests do")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error for a feature of the JAX package this port has not reached
    yet, naming the slice (ROADMAP.md, queue 1) that brings it."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet; it comes with {where} "
        "(ROADMAP.md, queue 1)")
