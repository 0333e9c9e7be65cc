"""Convert the JAX package's parameters into the port's.

The input is the flax parameter tree as nested dicts of numpy arrays
(``jax.device_get(variables["params"])``; no flax import is needed here).
The port keeps flax's layouts and leaf names, so the conversion is a
rename: the path ``block3/attn/qkv/kernel`` becomes the PyTorch parameter
name ``blocks.3.attn.qkv.kernel``, and the array is copied unchanged.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_FLAX_BLOCK = re.compile(r"^block(\d+)$")


def flax_path_to_name(path: Tuple[str, ...]) -> str:
    """('block3', 'attn', 'qkv', 'kernel') -> 'blocks.3.attn.qkv.kernel'."""
    parts = []
    for p in path:
        m = _FLAX_BLOCK.match(p)
        parts.append(f"blocks.{m.group(1)}" if m else p)
    return ".".join(parts)


def iter_flax_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf of a nested mapping, in key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from iter_flax_leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def flax_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{PyTorch parameter name: float32 CPU tensor} from a flax tree."""
    return {flax_path_to_name(path): torch.from_numpy(
                np.array(leaf, dtype=np.float32, copy=True))
            for path, leaf in iter_flax_leaves(params)}


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Copy a flax parameter tree into ``model`` (every parameter, shapes
    checked; a missing or extra leaf raises)."""
    converted = flax_to_torch(params)
    own = dict(model.named_parameters())
    if set(converted) != set(own):
        raise ValueError(
            "flax tree and model disagree: missing "
            f"{sorted(set(own) - set(converted))}, extra "
            f"{sorted(set(converted) - set(own))}")
    with torch.no_grad():
        for name, tensor in converted.items():
            if own[name].shape != tensor.shape:
                raise ValueError(f"{name}: flax shape {tuple(tensor.shape)} "
                                 f"!= port shape {tuple(own[name].shape)}")
            own[name].copy_(tensor)
