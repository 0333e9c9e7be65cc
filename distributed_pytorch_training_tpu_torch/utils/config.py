"""CLI parsing helpers (copied from the JAX package's utils/config.py)."""

from __future__ import annotations


def parse_model_overrides(spec: str) -> dict:
    """'depth=2,hidden_dim=64' -> {'depth': 2, 'hidden_dim': 64}. Values
    parse as int, then float, then bool ('true'/'false'), else string."""
    out: dict = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in item:
            raise ValueError(
                f"--model-overrides entry {item!r} is not field=value")
        key, val = (s.strip() for s in item.split("=", 1))
        for cast in (int, float):
            try:
                out[key] = cast(val)
                break
            except ValueError:
                continue
        else:
            out[key] = {"true": True, "false": False}.get(val.lower(), val)
    return out
