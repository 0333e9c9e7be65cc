"""The device mesh (the JAX package's parallel/mesh.py) as a layout of
ranks: one process per device, each at coordinates on the named axes.

Axis naming is the JAX package's (``data``, ``fsdp``, ``model``, ``seq``,
``pipe``, ``expert``, ``slice``), and so are ``MeshSpec``, its parse and
resolve rules and messages, ``dcn_factors``, ``validate_mesh_usage``
(alias ``validate_mesh``), ``batch_shard_count`` and ``local_batch_size``.

``build_mesh`` lays the ranks out row-major over ``AXIS_ORDER`` (``slice``
outermost, ``model`` innermost, as the JAX mesh orders its devices): rank
r sits at the coordinates whose row-major index is r. It makes one process
group for each line over every set of axes above size 1 (the ranks that
differ from each other only on those axes: one axis's line, the batch
axes', the (data, fsdp) batch line beside seq and model, seq x model);
a line that holds every rank is the default group. The batch is sharded
over ``BATCH_AXES`` only: ranks that differ only in another coordinate
(``seq``) hold the same rows.

Left out, with no torch counterpart: ``_VirtualSliceDevice`` and
``with_virtual_slices`` (they dress ``jax.Device`` objects with a slice
index), ``_slice_count`` and ``_unwrap_devices``, and the hybrid ICI/DCN
device layout of ``mesh_utils``; ``--slices`` keeps its meaning on the
port's wire (``parallel/grad_sync.py::HierSpec``).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch.distributed as dist

from .collectives import SOLO, AxisGroup, AxisLoop, TpAxis

# Canonical axis names.
DATA = "data"
FSDP = "fsdp"
MODEL = "model"
SEQ = "seq"
PIPE = "pipe"
EXPERT = "expert"
SLICE = "slice"

# The order of the axes in the layout, outermost first.
AXIS_ORDER: Tuple[str, ...] = (SLICE, PIPE, DATA, FSDP, EXPERT, SEQ, MODEL)
AXIS_NAMES: frozenset = frozenset(AXIS_ORDER)

# Axes a batch dimension is sharded over.
BATCH_AXES: Tuple[str, ...] = (SLICE, DATA, FSDP)

# Axes whose ranks hold parts of one model (tensor parallelism's shards,
# the pipeline's stages, the experts) and compute the same loss.
SPLIT_AXES: Tuple[str, ...] = (MODEL, PIPE, EXPERT)

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``-1`` on exactly one axis means "all remaining
    devices". The default is pure data parallelism."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    slice: int = 1

    def resolved(self, n_devices: int) -> Dict[str, int]:
        sizes = {
            SLICE: self.slice,
            PIPE: self.pipe,
            DATA: self.data,
            FSDP: self.fsdp,
            EXPERT: self.expert,
            SEQ: self.seq,
            MODEL: self.model,
        }
        bad = {k: v for k, v in sizes.items() if v < 1 and v != -1}
        if bad:
            raise ValueError(
                f"axis sizes must be >= 1 (or -1 for 'all remaining'), got {bad}")
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but {n_devices} are present"
            )
        return sizes

    @staticmethod
    def parse(text: str) -> "MeshSpec":
        """Parse ``"data=4,model=2"`` (CLI ``--mesh`` flag)."""
        valid = {f.name for f in dataclasses.fields(MeshSpec)}
        kwargs = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            k, eq, v = part.partition("=")
            k = k.strip()
            if k not in valid:
                raise ValueError(
                    f"--mesh: unknown axis {k!r}; valid axes: {sorted(valid)}"
                )
            if not eq or not v.strip().lstrip("-").isdigit():
                raise ValueError(
                    f"--mesh: expected '<axis>=<int>' pairs, got {part!r} "
                    f"(e.g. 'data=4,model=2')"
                )
            size = int(v)
            if size < 1 and size != -1:
                raise ValueError(
                    f"--mesh: axis size must be >= 1 (or -1 for 'all "
                    f"remaining devices'), got {part!r}"
                )
            kwargs[k] = size
        return MeshSpec(**kwargs)


def dcn_factors(sizes: dict, n_slices: int) -> Tuple[dict, dict]:
    """Split a logical mesh shape into (per_slice, dcn) factors for a
    multi-slice layout: ``sizes[a] == per_slice[a] * dcn[a]`` and
    ``prod(dcn) == n_slices``. Only the ``slice``, ``data``, ``pipe`` and
    ``fsdp`` axes may span slices (in that order); ``model``, ``seq`` and
    ``expert`` collectives are per layer and stay inside a slice."""
    dcn = {a: 1 for a in AXIS_ORDER}
    rem = n_slices
    for a in (SLICE, DATA, PIPE, FSDP):
        g = math.gcd(sizes.get(a, 1), rem)
        dcn[a] = g
        rem //= g
    if rem != 1:
        raise ValueError(
            f"mesh {sizes} cannot span {n_slices} slices: the slice count "
            f"must divide into the slice/data/pipe/fsdp axes (model/seq/"
            f"expert stay within a slice — their collectives need ICI). "
            f"E.g. for {n_slices} slices use data={n_slices}*k.")
    per = {a: sizes.get(a, 1) // dcn[a] for a in AXIS_ORDER}
    return per, dcn


def _axes(axes: Axes) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = [a for a in names if a not in AXIS_NAMES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; valid axes: "
                         f"{sorted(AXIS_NAMES)}")
    return names


@dataclasses.dataclass
class Mesh:
    """Ranks on the named axes: ``shape`` holds every axis of AXIS_ORDER,
    in that order; rank r is at the coordinates whose row-major index is
    r. ``groups`` maps a line's ranks to its process group (None: the
    default group, or no group in one process)."""

    shape: Dict[str, int]
    rank: int = 0
    groups: Dict[Tuple[int, ...], Optional[dist.ProcessGroup]] = \
        dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The coordinates of ``rank`` (this rank when None)."""
        r = self.rank if rank is None else rank
        out = {}
        for a in reversed(AXIS_ORDER):
            r, out[a] = divmod(r, self.shape[a])
        return {a: out[a] for a in AXIS_ORDER}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in AXIS_ORDER:
            r = r * self.shape[a] + coords[a]
        return r

    def line(self, axes: Axes, rank: Optional[int] = None) -> List[int]:
        """The ranks that differ from ``rank`` only on ``axes``, in
        row-major order over them."""
        names = _axes(axes)
        base = self.coords(rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in names)):
            out.append(self.rank_of({**base, **dict(zip(names, idx))}))
        return sorted(out)

    def lines(self, axes: Axes) -> List[List[int]]:
        """Every line over ``axes``: a partition of the ranks."""
        seen, out = set(), []
        for r in range(self.size):
            ln = tuple(self.line(axes, r))
            if ln not in seen:
                seen.add(ln)
                out.append(list(ln))
        return out

    def axis_index(self, axes: Axes) -> int:
        """This rank's position in its line over ``axes``."""
        return self.line(axes).index(self.rank)

    def group(self, axes: Axes) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's line over ``axes``: None for
        the default group (a line of every rank), ``SOLO`` for a line of
        this rank alone."""
        ln = tuple(self.line(axes))
        if len(ln) == self.size:
            return None
        if len(ln) == 1:
            return SOLO
        if ln not in self.groups:
            raise ValueError(f"no process group for the line {list(ln)} "
                             f"over {_axes(axes)}: build the mesh with "
                             "build_mesh in every rank")
        return self.groups[ln]

    def axis(self, axes: Axes):
        """This rank's line over ``axes`` for the sequence-parallel
        collectives: an ``AxisGroup`` over its process group, or an
        ``AxisLoop`` of one shard for a line of one rank."""
        if len(self.line(axes)) == 1:
            return AxisLoop(1)
        return AxisGroup(self.group(axes))

    def axis_shard(self, axis: str) -> TpAxis:
        """The mesh axis ``axis`` as this rank sees it: its size, this
        rank's index on it and the process group of its line (the
        region operators of tensor parallelism, the pipeline's rotation
        and the expert region run over it)."""
        return TpAxis(self.shape[axis], self.coords()[axis],
                      self.group(axis))

    def line_shard(self, axes: Axes) -> TpAxis:
        """This rank's line over ``axes`` (several at once) as a
        `TpAxis`: its size, this rank's index in it and its group."""
        return TpAxis(len(self.line(axes)), self.axis_index(axes),
                      self.group(axes))

    def tp(self) -> TpAxis:
        """The ``model`` axis as this rank sees it (megatron tensor
        parallelism's region operators run over its group)."""
        return self.axis_shard(MODEL)

    @property
    def batch_index(self) -> int:
        """This rank's position on the batch axes: the shard of the global
        batch it holds."""
        return self.axis_index(BATCH_AXES)

    def active(self) -> Dict[str, int]:
        """The axes above size 1, with ``data`` always: the banner's
        mesh."""
        return {a: s for a, s in self.shape.items() if s > 1 or a == DATA}


def build_mesh(spec: Optional[MeshSpec] = None, world: Optional[int] = None,
               rank: Optional[int] = None) -> Mesh:
    """The rank layout of ``spec`` over ``world`` ranks (the process
    group's, or one), and, when a process group of several ranks exists,
    the process groups of its lines. Every rank must call it, in the same
    order as every other process group it makes."""
    spec = spec or MeshSpec()
    live = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    mesh = Mesh(spec.resolved(world), rank)
    if not live or world == 1:
        return mesh
    active = [a for a in AXIS_ORDER if mesh.shape[a] > 1]
    kinds = [axes for k in range(1, len(active) + 1)
             for axes in itertools.combinations(active, k)]
    for axes in kinds:
        for ln in mesh.lines(axes):
            key = tuple(ln)
            if 1 < len(key) < world and key not in mesh.groups:
                mesh.groups[key] = dist.new_group(list(key))
    return mesh


def validate_mesh_usage(mesh: Mesh, *, rules=None, attention: str = "xla",
                        is_moe: bool = False, pipelined: bool = False
                        ) -> None:
    """Reject meshes with axes the selected config cannot use (they would
    replicate work across ranks with no warning). ``rules`` is the model's
    partition rules (anything with ``axes_used()``) or None; an axis is
    usable for parameters only if some rule can place a dim on it."""
    rule_axes = rules.axes_used() if rules is not None else set()
    problems = []
    if mesh.shape[PIPE] > 1 and not pipelined:
        problems.append(
            f"pipe={mesh.shape[PIPE]} but the selected model does not run "
            "through the pipeline (use a pipelined model config, e.g. "
            "gpt2_*_pipe, or drop the pipe axis)")
    if mesh.shape[SEQ] > 1 and attention not in ("ring", "ulysses"):
        problems.append(
            f"seq={mesh.shape[SEQ]} but --attention {attention!r} does not "
            "shard the sequence (use --attention ring or ulysses)")
    if mesh.shape[EXPERT] > 1 and not is_moe:
        problems.append(
            f"expert={mesh.shape[EXPERT]} but the model has no MoE layers "
            "(use an *_moe model or drop the expert axis)")
    if mesh.shape[MODEL] > 1 and MODEL not in rule_axes:
        problems.append(
            f"model={mesh.shape[MODEL]} but the model's partition rules "
            "never use the tensor-parallel axis (ResNets ship replicated-"
            "only rules; transformers support TP)")
    if problems:
        raise ValueError(
            "mesh axes that would silently waste devices:\n  - "
            + "\n  - ".join(problems))
    if mesh.shape[FSDP] > 1 and FSDP not in rule_axes:
        logging.getLogger(__name__).warning(
            "fsdp=%d but the model's partition rules never shard params on "
            "the fsdp axis — running as plain data parallelism (no ZeRO "
            "memory win)", mesh.shape[FSDP])


validate_mesh = validate_mesh_usage


def batch_shard_count(mesh: Mesh) -> int:
    """Number of ways the global batch is split (product of batch axes)."""
    return math.prod(mesh.shape[a] for a in BATCH_AXES)


def local_batch_size(per_device_batch: int, mesh: Mesh) -> int:
    """The rows of the global batch (``per_device_batch`` x
    ``batch_shard_count``) that this rank holds: those of its batch
    coordinate. A port rank is one device, and ranks that differ only
    outside the batch axes hold the same rows, so it is
    ``per_device_batch`` on every mesh (the JAX function counts the
    devices of a host instead)."""
    del mesh
    return per_device_batch
