"""Builders the CLIs share (the JAX package's experiments/harness.py).

Only the serving builder is ported so far, without mesh or checkpoint.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..runtime import DeviceLike, resolve_device


def build_serving_engine(model_name: str,
                         buckets: Sequence[int] = (16, 32), rows: int = 8,
                         max_new_tokens: int = 8, serve_dtype: str = "fp32",
                         model_overrides: Optional[dict] = None,
                         seed: int = 0, device: DeviceLike = None):
    """An `InferenceEngine` for a serving config on one device, with
    random-init weights drawn from ``seed`` (a smoke of the serving path,
    not a served model). The weights are drawn on the CPU and then copied
    to ``device``, so one seed gives the same weights on every device.

    The model's position table holds ``max(512, top bucket +
    max_new_tokens)`` rows unless ``model_overrides`` sets it, as in the
    JAX package."""
    from ..models import get_model
    from ..serving.engine import InferenceEngine, ServeConfig

    dev = resolve_device(device)
    cfg = ServeConfig(buckets=tuple(buckets), rows=rows,
                      max_new_tokens=max_new_tokens, serve_dtype=serve_dtype)
    kwargs = dict(model_overrides or {})
    need = max(cfg.buckets) + cfg.max_new_tokens
    kwargs.setdefault("max_position", max(512, need))
    model = get_model(model_name, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    params = {name: p.detach() for name, p in model.named_parameters()}
    return InferenceEngine(model, cfg, params, device=dev)
