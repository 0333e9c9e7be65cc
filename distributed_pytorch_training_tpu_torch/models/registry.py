"""Model registry: name -> constructor."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn: Callable):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, **kwargs):
    """Instantiate a registered model (e.g. ``get_model("gpt2_124m")``)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
