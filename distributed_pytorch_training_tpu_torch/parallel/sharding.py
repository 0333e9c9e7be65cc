"""The flat-padded layout of the sharded update (the JAX package's
parallel/sharding.py, its ZeRO-1 and explicit-FSDP part).

The sharded weight update partitions every parameter's flattened value
over the ranks: a leaf of ``size`` elements is zero-padded to a multiple
of the world size N and cut into N equal chunks, so tensor shapes never
constrain divisibility and the update is elementwise work on (padded/N,)
chunks. The padding carries zero gradient, so it stays zero through any
elementwise optimizer. Rank r holds chunk ``owner`` (r itself, or the
fast-major index of the ``int8_hier`` wire, ``grad_sync.HierSpec``).

Tensor parallelism reads the partition rules (``PartitionRules``: an
ordered table of (path regex, spec), a spec a tuple of mesh axis names or
None a dim) as its layout contract: ``tp_split_dims`` gives each leaf the
dim it splits on over the ``model`` axis, ``tp_local_struct`` the local
shapes, ``tp_slice`` a model shard's contiguous slice of a leaf and
``tp_join`` its inverse (the one slice rule of the weight carrier and the
checkpoints), ``tp_unflatten_leaf`` the leaf from the model-major
flat-padded layout of explicit TP x FSDP's checkpoints (each model
shard's slice flat-padded over the data ranks, the shards concatenated; a
rank holds `chunk_of` its shard's slice, ``fsdp_flat_params`` of the
TP-local leaves).
A template is a sequence of (parameter name, tensor or shape) pairs;
rules match the leaf's flax path (``block0/attn/qkv/kernel``), as in the
JAX package.

The same helpers lay out the other two axes a model splits over, with
``tp_split_dims(..., axis=...)``: the pipelined GPT-2's stage-stacked
block leaves on ``pipe`` (``models/gpt2_pipe.py``'s rule ``blocks/`` ->
``(PIPE,)``: dim 0 of a (P, L/P, ...) stack, stage p holding [p]) and
gpt2_moe's experts on ``expert`` (``models/moe.py``'s ``moe_rules``:
``moe/wi`` and ``moe/wo`` on dim 0 of (E, ...), an expert rank holding
E/ep of them); ``tp_slice`` cuts a rank's part of a global leaf and
``tp_join`` joins the parts back.

The ``fsdp`` axis (GSPMD's d_model sharding) reads the rules' ``fsdp``
entries: ``fsdp_split_dims`` gives each leaf its dim over ``fsdp`` (the
complement of its model dim in ``tp_fsdp_rules``), degraded to
replication as JAX's ``feasible_spec`` degrades an indivisible dim, with
its warning; ``fsdp_slice`` cuts along it and ``tp_join`` joins the
blocks back (the same contiguous rule as ``tp_slice``: rank f holds
block f).
``mesh_clip_weights`` weighs each leaf's squared sum for the global-norm
clip of a model split over one or several of these axes: 1/n for each
axis of n ranks a leaf is replicated over, 1 for one it is split on.
"""

from __future__ import annotations

import logging
import math
import re
from typing import (Dict, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]
Template = Iterable[Tuple[str, Union[torch.Tensor, Sequence[int]]]]

# degraded layouts warned about already (one warning per unique
# shape/spec)
_degraded_warned: set = set()


def reset_degradation_warnings() -> None:
    """Clear the warn-once state, so a new model setup warns afresh."""
    _degraded_warned.clear()


class PartitionRules:
    """Ordered (regex, spec) table; the first match on the '/'-joined
    flax path wins; no match is fully replicated."""

    def __init__(self, rules: Sequence[Tuple[str, Spec]] = ()):
        self._rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(self, path: str, ndim: Optional[int] = None) -> Spec:
        for pat, spec in self._rules:
            if pat.search(path):
                if ndim is not None and len(spec) > ndim:
                    raise ValueError(
                        f"rule {pat.pattern!r} spec {spec} has more axes "
                        f"than param {path!r} with ndim={ndim}")
                return spec
        return ()

    def __add__(self, other: "PartitionRules") -> "PartitionRules":
        out = PartitionRules()
        out._rules = self._rules + other._rules
        return out

    def axes_used(self) -> set:
        """Mesh axis names any rule can place a dim on (mesh validation:
        an axis no rule mentions cannot shard a parameter)."""
        axes = set()
        for _, spec in self._rules:
            for entry in spec:
                if entry is None:
                    continue
                axes.update((entry,) if isinstance(entry, str)
                            else tuple(entry))
        return axes


def spec_for_path(rules: Optional[PartitionRules], path: str,
                  ndim: int) -> Spec:
    if rules is None:
        return ()
    return rules.spec_for(path, ndim)


def flax_path(name: str) -> str:
    """'blocks.0.attn.qkv.kernel' -> 'block0/attn/qkv/kernel'."""
    from ..convert import name_to_flax_path  # convert imports this module

    return "/".join(name_to_flax_path(name))


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in (leaf.shape if hasattr(leaf, "shape")
                                  else leaf))


def flat_padded_size(size: int, n_shards: int) -> int:
    """``size`` rounded up to a multiple of ``n_shards`` (0-padding at the
    end)."""
    return size + (-size % n_shards)


def flatten_pad(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """1-D view of ``x``, zero-padded so it splits evenly into
    ``n_shards``."""
    flat = x.reshape(-1)
    pad = -flat.numel() % n_shards
    return F.pad(flat, (0, pad)) if pad else flat


def chunk_of(x: torch.Tensor, n_shards: int, index: int) -> torch.Tensor:
    """Chunk ``index`` of ``x``'s flat-padded layout (a new tensor)."""
    return flatten_pad(x, n_shards).reshape(n_shards, -1)[index].clone()


def fsdp_flat_params(leaves: Sequence[torch.Tensor], n_shards: int,
                     index: int) -> List[torch.Tensor]:
    """The explicit-FSDP at-rest layout of ``leaves`` on one rank: chunk
    ``index`` of every leaf's flat-padded vector (the JAX package keeps
    all N chunks in one global array sharded over the batch axes; each
    rank here holds its own)."""
    return [chunk_of(p.detach(), n_shards, index) for p in leaves]


def unflatten_padded(flat: torch.Tensor, shape: Sequence[int]
                     ) -> torch.Tensor:
    """A leaf of ``shape`` from its flat-padded vector (the padding
    dropped)."""
    size = 1
    for d in shape:
        size *= int(d)
    return flat[:size].reshape(tuple(shape))


# ---------------------------------------------------------------------------
# tensor parallelism's layout (the JAX package's tp_* helpers)
# ---------------------------------------------------------------------------


def tp_split_dims(template: Template, rules: Optional[PartitionRules],
                  model_n: int, axis: Optional[str] = None
                  ) -> Dict[str, Optional[int]]:
    """{name: the dim the leaf splits on over ``axis`` (``model`` when
    None), or None}: the first spec dim naming the axis, if it divides by
    ``model_n``; an indivisible dim leaves the leaf replicated over the
    axis, with a warning once (GPT-2's vocab without Megatron padding).
    The ``pipe`` axis (a stage-stacked leaf's dim 0) and the ``expert``
    axis (an expert-stacked leaf's dim 0) take the same rule."""
    from .mesh import MODEL

    axis = MODEL if axis is None else axis
    out: Dict[str, Optional[int]] = {}
    for name, leaf in template:
        shape = _shape_of(leaf)
        path = flax_path(name)
        spec = spec_for_path(rules, path, len(shape))
        out[name] = None
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            if axis not in names:
                continue
            if shape[dim] % model_n:
                key = (("tp", axis, spec), shape, model_n)
                if key not in _degraded_warned:
                    _degraded_warned.add(key)
                    logger.warning(
                        "explicit TP: %s dim %d (size %d) not divisible by "
                        "%s=%d — leaf stays %s-replicated (Megatron "
                        "vocab padding un-degrades embeddings)",
                        path, dim, shape[dim], axis, model_n, axis)
                break
            out[name] = dim
            break
    return out


def tp_local_struct(template: Template, split_dims: Dict[str, Optional[int]],
                    model_n: int) -> Dict[str, Tuple[int, ...]]:
    """{name: local shape}: split leaves shrink their split dim by 1/M,
    replicated leaves keep their shape (each model shard holds a copy)."""
    out = {}
    for name, leaf in template:
        shape = list(_shape_of(leaf))
        dim = split_dims[name]
        if dim is not None:
            shape[dim] //= model_n
        out[name] = tuple(shape)
    return out


def tp_slice(x: torch.Tensor, dim: Optional[int], model_n: int,
             shard: int) -> torch.Tensor:
    """Model shard ``shard``'s contiguous slice of one leaf (the whole
    leaf when ``dim`` is None): a view."""
    if dim is None:
        return x
    c = x.shape[dim] // model_n
    return x.narrow(dim, shard * c, c)


def tp_join(parts: Sequence[torch.Tensor],
            dim: Optional[int]) -> torch.Tensor:
    """The inverse of `tp_slice`: every model shard's slice in shard
    order, concatenated along ``dim`` (shard 0's copy when ``dim`` is
    None)."""
    return parts[0] if dim is None else torch.cat(list(parts), dim=dim)


def tp_unflatten_leaf(flat: torch.Tensor, full_shape: Sequence[int],
                      dim: Optional[int], model_n: int) -> torch.Tensor:
    """The model-shaped leaf from its model-major flat-padded vector:
    split leaves join their M local slices along the split dim,
    replicated leaves take copy 0."""
    full_shape = tuple(int(d) for d in full_shape)
    local_shape = list(full_shape)
    if dim is not None:
        local_shape[dim] //= model_n
    size = math.prod(local_shape)
    mat = flat.reshape(model_n, -1)[:, :size]
    return tp_join([row.reshape(local_shape) for row in mat], dim)


def feasible_spec(spec: Spec, shape: Sequence[int],
                  mesh_shape: Dict[str, int]) -> Spec:
    """The JAX package's ``feasible_spec``: spec entries whose mesh axes
    (sizes in ``mesh_shape``, 1 when absent) do not divide their dim are
    dropped to replication, per dim, with a warning once per unique
    (spec, shape, mesh)."""
    if not len(spec):
        return spec
    if len(spec) > len(shape):
        raise ValueError(
            f"PartitionSpec {spec} has more entries than tensor rank "
            f"{len(shape)} (shape {tuple(shape)})")
    entries = []
    changed = False
    for dim, entry in zip(shape, tuple(spec)
                          + (None,) * (len(shape) - len(spec))):
        if entry is None:
            entries.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        if dim % math.prod(mesh_shape.get(a, 1) for a in names):
            entries.append(None)
            changed = True
        else:
            entries.append(entry)
    if changed:
        key = (tuple(spec), tuple(shape), tuple(sorted(mesh_shape.items())))
        if key not in _degraded_warned:
            _degraded_warned.add(key)
            logger.warning(
                "sharding %s infeasible for shape %s (indivisible dims) — "
                "degraded to %s (replicating those dims)",
                _spec_str(spec), tuple(shape), _spec_str(tuple(entries)))
    return tuple(entries)


def _spec_str(spec: Spec) -> str:
    """A spec as jax's ``PartitionSpec`` prints it."""
    return "PartitionSpec(" + ", ".join(repr(e) for e in spec) + ")"


def fsdp_split_dims(template: Template, rules: Optional[PartitionRules],
                    fsdp_n: int, model_n: int = 1
                    ) -> Dict[str, Optional[int]]:
    """{name: the dim the leaf splits on over ``fsdp``, or None}: the
    spec's ``fsdp`` entry of its global shape after `feasible_spec` on a
    mesh of ``fsdp_n`` x ``model_n``, so an indivisible dim stays
    replicated with JAX's warning."""
    from .mesh import FSDP, MODEL

    mesh_shape = {FSDP: fsdp_n, MODEL: model_n}
    out: Dict[str, Optional[int]] = {}
    for name, leaf in template:
        shape = _shape_of(leaf)
        spec = feasible_spec(spec_for_path(rules, flax_path(name),
                                           len(shape)), shape, mesh_shape)
        out[name] = next(
            (d for d, e in enumerate(spec) if e is not None
             and FSDP in ((e,) if isinstance(e, str) else tuple(e))), None)
    return out


# the fsdp axis cuts as tensor parallelism does (``tp_join`` joins the
# blocks back): rank f holds the contiguous block f of the leaf's dim
fsdp_slice = tp_slice


def mesh_clip_weights(split_dims: Sequence[Sequence[Optional[int]]],
                      sizes: Sequence[int]) -> Tuple[float, ...]:
    """Each leaf's squared-norm weight for a clip whose squared sums are
    summed over several axes at once (``split_dims[a][i]``: leaf i's dim
    over axis a of ``sizes[a]`` ranks, None when replicated over it): the
    product of 1/n over the axes it is replicated on (exact in float32
    for powers of two)."""
    out = []
    for dims in zip(*split_dims):
        w = 1.0
        for d, n in zip(dims, sizes):
            if d is None:
                w /= n
        out.append(w)
    return tuple(out)
