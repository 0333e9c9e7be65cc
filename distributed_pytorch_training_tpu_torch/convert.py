"""Convert parameters and BatchNorm statistics between the JAX package and
the port.

The input is a flax collection as nested dicts of numpy arrays
(``jax.device_get(variables["params"])``, ``variables["batch_stats"]``; no
flax import is needed here). The port keeps flax's layouts and leaf names,
so the conversion is a rename: the path ``block3/attn/qkv/kernel`` becomes
the PyTorch parameter name ``blocks.3.attn.qkv.kernel``, and the array is
copied unchanged. ``batch_stats`` leaves become the model's (persistent)
buffers: ``stem_bn/mean`` is the buffer ``stem_bn.mean``. ``torch_to_flax``
and ``batch_stats_to_flax`` go back, so that a trained port model can be
compared with a flax tree leaf by leaf.

``flax_ordered`` lists a model's parameters in flax ``tree_leaves`` order
(sorted keys at every level), the order of the JAX package's flat gradient.

Tensor parallelism: ``tp_local_params`` cuts the global parameters (a
flax tree, or ``{name: tensor}``) into model shard r's TP-local tensors
(``parallel.sharding.tp_slice``: each split leaf's contiguous slice along
its split dim, ``tp_split_dims``; replicated leaves whole),
``load_tp_params`` writes them into a TP-local model, and
``tp_global_params`` concatenates every shard's tensors back: the round
trip is bitwise. The same three carry the other split models, with the
split dims of their own rules: a pipelined GPT-2's stage-stacked block
leaves (P, L/P, ...) to stage p's (1, L/P, ...) slice over ``pipe``, a
``gpt2_moe``'s ``wi`` and ``wo`` (E, ...) to an expert rank's E/ep
experts over ``expert``. ``gpt2_to_pipe_params`` stacks a ``gpt2_*``
model's ``block{i}`` leaves into the pipelined model's global stacks,
``pipe_to_gpt2_params`` unstacks them; both round trips are bitwise.
"""

from __future__ import annotations

import re
from typing import (Any, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Tuple)

import numpy as np
import torch
from torch import nn

from .parallel.sharding import tp_join, tp_slice

_FLAX_BLOCK = re.compile(r"^block(\d+)$")
_TORCH_BLOCK = re.compile(r"^blocks\.(\d+)\.")


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


def _copy_into(own: Dict[str, torch.Tensor], tree: Mapping[str, Any],
               what: str) -> None:
    converted = flax_to_torch(tree)
    if set(converted) != set(own):
        raise ValueError(
            f"flax {what} and model disagree: missing "
            f"{sorted(set(own) - set(converted))}, extra "
            f"{sorted(set(converted) - set(own))}")
    with torch.no_grad():
        for name, tensor in converted.items():
            if own[name].shape != tensor.shape:
                raise ValueError(f"{name}: flax shape {tuple(tensor.shape)} "
                                 f"!= port shape {tuple(own[name].shape)}")
            own[name].copy_(tensor)


def load_flax_params(model: nn.Module, params: Mapping[str, Any],
                     batch_stats: Optional[Mapping[str, Any]] = None
                     ) -> None:
    """Copy a flax parameter tree, and its ``batch_stats`` tree when given,
    into ``model`` (shapes checked; a missing or extra leaf raises)."""
    _copy_into(dict(model.named_parameters()), params, "params")
    if batch_stats is not None:
        _copy_into(dict(model.named_buffers()), batch_stats, "batch_stats")


def flax_ordered(named: Iterable[Tuple[str, torch.Tensor]]
                 ) -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` pairs sorted by their flax path: the JAX package's
    ``tree_leaves`` order (tuple order is nested sorted-key order)."""
    return sorted(named, key=lambda item: name_to_flax_path(item[0]))


def name_to_flax_path(name: str) -> Tuple[str, ...]:
    """'blocks.3.attn.qkv.kernel' -> ('block3', 'attn', 'qkv', 'kernel')."""
    return tuple(_TORCH_BLOCK.sub(r"block\1.", name).split("."))


def _to_tree(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, t in named:
        *parents, leaf = name_to_flax_path(name)
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        # a copy: a CPU float32 tensor's numpy() shares its memory
        node[leaf] = t.detach().float().cpu().numpy().copy()
    return tree


def torch_to_flax(model: nn.Module) -> Dict[str, Any]:
    """The flax parameter tree (nested dicts of float32 numpy arrays) of
    ``model``'s parameters: the inverse of `load_flax_params`."""
    return _to_tree(model.named_parameters())


def batch_stats_to_flax(model: nn.Module) -> Dict[str, Any]:
    """The flax ``batch_stats`` tree of ``model``'s buffers ({} for a model
    without BatchNorm)."""
    return _to_tree(model.named_buffers())


def _named(params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a flax tree, or of a name-keyed mapping."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        return dict(params)
    return flax_to_torch(params)


def tp_local_params(params, split_dims: Mapping[str, Optional[int]],
                    model_n: int, index: int) -> Dict[str, torch.Tensor]:
    """Model shard ``index``'s TP-local tensors (new, contiguous) of the
    global ``params``: each split leaf's slice ``index`` of ``model_n``
    along its split dim, replicated leaves whole."""
    return {name: tp_slice(t, split_dims[name], model_n, index).detach()
            .clone(memory_format=torch.contiguous_format)
            for name, t in _named(params).items()}


def load_tp_params(model: nn.Module, params,
                   split_dims: Mapping[str, Optional[int]],
                   axis=None) -> None:
    """Write the local slices of the global ``params`` into a local
    ``model``: its shard on ``axis`` (a ``TpAxis``; the model's ``tp``
    when None), shapes checked. Tensor parallelism's shards, a pipeline
    stage (``axis`` the ``pipe`` axis) and an expert rank's experts
    (``expert``) load alike."""
    tp = model.tp if axis is None else axis
    local = tp_local_params(params, split_dims, tp.size, tp.index)
    own = dict(model.named_parameters())
    if set(local) != set(own):
        raise ValueError(
            f"params and TP-local model disagree: missing "
            f"{sorted(set(own) - set(local))}, extra "
            f"{sorted(set(local) - set(own))}")
    with torch.no_grad():
        for name, t in local.items():
            if own[name].shape != t.shape:
                raise ValueError(f"{name}: local shape {tuple(t.shape)} != "
                                 f"TP-local model's {tuple(own[name].shape)}")
            own[name].copy_(t)


def tp_global_params(shards, split_dims: Mapping[str, Optional[int]]
                     ) -> Dict[str, torch.Tensor]:
    """The global tensors from every model shard's TP-local ``{name:
    tensor}`` (in shard order): split leaves concatenated along their
    split dim, replicated leaves shard 0's."""
    shards = [_named(s) for s in shards]
    return {name: tp_join([s[name] for s in shards], split_dims[name])
            for name in shards[0]}


def gpt2_to_pipe_params(params, num_stages: int) -> Dict[str, torch.Tensor]:
    """The pipelined GPT-2's global parameters (``models/gpt2_pipe.py``:
    ``blocks.<path>`` of shape (P, L/P, ...), layer p L/P + j at [p, j])
    from a ``gpt2_*`` model's (a flax tree, or ``{name: tensor}``): each
    block leaf stacked over the layers, the embeddings and the final
    LayerNorm as they are. A pipe=P run and its pipe=1 yardstick start
    from the same weights so."""
    layers: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for name, t in _named(params).items():
        m = _TORCH_BLOCK.match(name)
        if m is None:
            out[name] = t
        else:
            layers.setdefault(name[m.end():], {})[int(m.group(1))] = t
    for leaf, by_layer in layers.items():
        stack = torch.stack([by_layer[i] for i in range(len(by_layer))])
        out[f"blocks.{leaf}"] = stack.reshape(
            num_stages, -1, *stack.shape[1:]).clone()
    return out


def pipe_to_gpt2_params(params) -> Dict[str, torch.Tensor]:
    """The inverse of `gpt2_to_pipe_params`: a ``gpt2_*`` model's
    ``blocks.<i>.<path>`` leaves from the pipelined model's stacks."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in _named(params).items():
        if not name.startswith("blocks."):
            out[name] = t
            continue
        for i, layer in enumerate(t.reshape(-1, *t.shape[2:]).unbind(0)):
            out[f"blocks.{i}.{name[len('blocks.'):]}"] = layer.clone()
    return out
