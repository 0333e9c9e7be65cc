"""The explicit bucketed gradient reducer (the JAX package's
parallel/grad_sync.py) on ``torch.distributed``.

Each rank flattens its local weight-scaled gradient sum into ONE float32
vector, cuts it into size-capped buckets (``bucket_cap_mb``, DDP's knob)
and reduces bucket by bucket at the chosen wire dtype:

* ``fp32``: one SUM all-reduce per bucket;
* ``bf16``: one SUM all-reduce of a bf16 copy of each bucket (the wire
  and the sum in bf16, half the bytes), cast back to float32; no state;
* ``int8``: per-bucket max-abs scale plus error feedback (the residual of
  this rank's quantization is added back at its next reduction); the s8
  codes and the scales are all-gathered, and every rank sums the
  dequantized rows in rank order (K2), so the result is replicated;
* ``int8_multihop``: each bucket padded to a multiple of the world size and
  quantized per destination chunk (K1, n rows) with error feedback; an s8
  all-to-all hands rank j every chunk j, which it dequant-sums (K2); the
  partial sum is requantized (K1, one row) and all-gathered as s8.

The flat layout is the JAX package's, element for element: leaves in
flax ``tree_leaves`` order (sorted keys at every level, as
``convert.iter_flax_leaves`` walks them) and in flax layout (conv kernels
HWIO). So bucket bounds, per-row scales, multihop destination chunks and
the error-feedback residual cover the same elements as the reference's.
``Trainer`` passes the parameters in that order (``flax_ordered``).

* ``int8_hier``: the two-tier wire of a world factored into slices
  (``HierSpec``): an exact fp32 reduce-scatter inside the slice, the
  ``int8_multihop`` codec across slices on that 1/n_inner partial (the one
  quantization, with error feedback), an exact all-gather back.

The sharded update (``Trainer``'s ZeRO-1 and explicit-FSDP steps) reduces
per leaf, or per layer group (``LayerPlan``), straight into this rank's
chunk of the flat-padded layout (``parallel/sharding.py``):
``compressed_psum_scatter`` at ``fp32``, ``bf16`` or ``int8`` (one scale a
leaf or group, an s8 all-to-all, K2 over the n received rows), or
``hier_psum_scatter``; the new parameters come back exactly
(``all_gather``), as s8 update codes (``quantized_delta_all_gather``,
``hier_delta_all_gather``) or, under FSDP, as s8 codes of the at-rest
rows (``quantized_shard_all_gather``, ``hier_shard_all_gather``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Set, Tuple

import torch
import torch.nn.functional as F

import torch.distributed as dist

from ..convert import name_to_flax_path
from ..ops.quantize import dequant_sum_rows, fma_f32, quantize_int8_rows
from .collectives import (Group, all_gather, all_to_all, psum,
                          psum_scatter)
from .mesh import BATCH_AXES
from .sharding import flat_padded_size

WIRE_DTYPES = ("fp32", "bf16", "int8", "int8_multihop", "int8_hier")

# Wire modes whose codec carries an error-feedback residual
EF_WIRE_DTYPES = ("int8", "int8_multihop", "int8_hier")


def check_wire(wire_dtype: str) -> None:
    """Raise for a wire dtype outside WIRE_DTYPES."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r} "
                         f"(choose from {WIRE_DTYPES})")


# ---------------------------------------------------------------------------
# Hierarchy spec (the int8_hier wire's topology)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HierSpec:
    """The two tiers of the ``int8_hier`` wire, seen from one rank.

    ``n_slices`` ranks share this rank's fast index across the slow tier
    (``slice_group``), ``n_inner`` share its slice (``fast_group``, None
    when n_inner is 1). Chunk ownership is FAST-MAJOR, as in the JAX
    package: the fast reduce-scatter hands fast rank j chunk j, the slow
    exchange hands slice s sub-chunk s of it, so this rank owns chunk
    ``owner = fast * n_slices + slow``; every hier gather runs across the
    slices first, then inside the slice."""

    slice_axis: str
    n_slices: int
    n_inner: int
    slow: int = 0
    fast: int = 0
    slice_group: Group = dataclasses.field(default=None, compare=False)
    fast_group: Group = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.n_slices < 2:
            raise ValueError(
                f"HierSpec needs >= 2 slices (got {self.n_slices}); a "
                "1-slice mesh has no slow tier — the trainer resolves "
                "int8_hier to the flat fp32 path there")
        if self.n_inner < 1:
            raise ValueError(f"n_inner must be >= 1, got {self.n_inner}")

    @property
    def owner(self) -> int:
        """The chunk of a flat-padded leaf this rank owns."""
        return self.fast * self.n_slices + self.slow


def axis_sizes(world: int, slices: int) -> dict:
    """The batch axes' sizes of ``world`` ranks in ``slices`` slices."""
    return {"slice": slices, "data": world // slices, "fsdp": 1}


def hier_coords(rank: int, world: int, slices: int,
                slice_axis: str = "slice") -> Tuple[int, int]:
    """(slow, fast) index of ``rank`` when the slow tier is
    ``slice_axis`` of the (slice, data, fsdp) mesh of ``world`` ranks in
    ``slices`` slices (slice outermost, as the JAX mesh lays it out): the
    coordinate on that axis, and the linear index over the other batch
    axes."""
    sizes = axis_sizes(world, slices)
    coords = {"slice": rank // sizes["data"], "data": rank % sizes["data"],
              "fsdp": 0}
    fast = 0
    for axis in BATCH_AXES:
        if axis != slice_axis:
            fast = fast * sizes[axis] + coords[axis]
    return coords[slice_axis], fast


def hier_owner(rank: int, world: int, slices: int,
               slice_axis: str = "slice") -> int:
    """The chunk ``rank`` owns under the fast-major ownership:
    fast * n_slices + slow."""
    n_slices = axis_sizes(world, slices)[slice_axis]
    slow, fast = hier_coords(rank, world, slices, slice_axis)
    return fast * n_slices + slow


def build_hier_spec(world: int, rank: int, slices: int,
                    slice_axis: str = "slice") -> HierSpec:
    """The HierSpec of ``rank`` with the slow tier on ``slice_axis``,
    creating the fast and slice process groups (every rank creates every
    group, in the same order: a collective over the default group). A
    group's ranks are in ascending order, which is the order of the
    coordinate it spans."""
    n_slices = axis_sizes(world, slices)[slice_axis]
    n_inner = world // n_slices
    by_rank = [hier_coords(r, world, slices, slice_axis)
               for r in range(world)]
    slow, fast = by_rank[rank]
    fast_group = slice_group = None
    if n_inner > 1:
        for s in range(n_slices):
            g = dist.new_group([r for r in range(world)
                                if by_rank[r][0] == s])
            if s == slow:
                fast_group = g
    for j in range(n_inner):
        g = dist.new_group([r for r in range(world) if by_rank[r][1] == j])
        if j == fast:
            slice_group = g
    return HierSpec(slice_axis=slice_axis, n_slices=n_slices,
                    n_inner=n_inner, slow=slow, fast=fast,
                    slice_group=slice_group, fast_group=fast_group)


# ---------------------------------------------------------------------------
# Bucket plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static layout of the flattened gradient vector: bucket k is
    ``flat[bounds[k]:bounds[k+1]]``. Built from shapes only, so it is the
    same on every rank."""

    total_size: int
    bounds: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.bounds) - 1

    @property
    def total_bytes(self) -> int:
        """float32 bytes of one full gradient (the bucket-cap currency)."""
        return self.total_size * 4

    def bucket_sizes(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.bounds, self.bounds[1:]))


def _numel(leaf) -> int:
    return int(math.prod(tuple(leaf.shape)) or 1)


def build_bucket_plan(leaves: Sequence, bucket_cap_mb: float) -> BucketPlan:
    """Cut the flattened gradient of ``leaves`` (anything with a
    ``.shape``) into buckets of at most ``bucket_cap_mb`` MB of float32;
    ``<= 0`` means one bucket. Exactly ``ceil(total_bytes / cap)`` buckets:
    the bounds cut the concatenated vector, not the leaf list."""
    total = sum(_numel(leaf) for leaf in leaves)
    if total == 0:
        return BucketPlan(total_size=0, bounds=(0, 0))
    cap_elems = int(bucket_cap_mb * (1024 ** 2) // 4)
    if bucket_cap_mb <= 0 or cap_elems >= total:
        return BucketPlan(total_size=total, bounds=(0, total))
    cap_elems = max(1, cap_elems)
    bounds = tuple(range(0, total, cap_elems)) + (total,)
    return BucketPlan(total_size=total, bounds=bounds)


def padded_bucket_bounds(plan: BucketPlan, n_shards: int) -> Tuple[int, ...]:
    """Cumulative offsets of the multihop layout: each bucket padded up to
    a multiple of ``n_shards`` (the layout of its error-feedback
    residual)."""
    bounds = [0]
    for size in plan.bucket_sizes():
        bounds.append(bounds[-1] + -(-size // n_shards) * n_shards)
    return tuple(bounds)


def padded_total_size(plan: BucketPlan, n_shards: int) -> int:
    """Elements of the multihop (padded-to-n) flat layout."""
    return padded_bucket_bounds(plan, n_shards)[-1]


def hier_wire_bytes(plan: BucketPlan, n_shards: int, n_slices: int) -> dict:
    """Per-replica bytes of one ``int8_hier`` sync, by tier: exact fp32
    inside the slice (8 S) and the multihop codec across slices on the
    1/n_inner partial."""
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if n_shards % n_slices:
        raise ValueError(
            f"int8_hier: {n_shards} batch shards do not factor into "
            f"{n_slices} slices (world % slices != 0)")
    s = plan.total_size
    if n_shards <= 1:
        return {"ici": 0, "dcn": 0}
    if n_slices == 1:
        return {"ici": 8 * s, "dcn": 0}
    n_inner = n_shards // n_slices
    return {"ici": 8 * s if n_inner > 1 else 0,
            "dcn": 2 * padded_total_size(plan, n_shards) // n_inner}


def wire_bytes_per_replica(plan: BucketPlan, wire_dtype: str,
                           n_shards: int, n_slices: int = 1) -> int:
    """Per-replica wire bytes of one full gradient sync (payload only; the
    O(n) float32 scales are left out): fp32 8 S and bf16 4 S (a ring
    all-reduce), int8 (n-1) S (every rank receives every peer's codes),
    int8_multihop 2 S_padded, int8_hier by tier (`hier_wire_bytes`)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r} "
                         f"(choose from {WIRE_DTYPES})")
    if n_shards <= 1:
        return 0
    s = plan.total_size
    if wire_dtype == "int8_hier":
        split = hier_wire_bytes(plan, n_shards, n_slices)
        return split["ici"] + split["dcn"]
    if wire_dtype == "fp32":
        return 8 * s
    if wire_dtype == "bf16":
        return 4 * s
    if wire_dtype == "int8":
        return (n_shards - 1) * s
    return 2 * padded_total_size(plan, n_shards)


# ---------------------------------------------------------------------------
# Flat layout
# ---------------------------------------------------------------------------


def flatten_tree(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate the leaves (ravelled, float32) in the given order: the
    flat gradient the buckets cut."""
    return torch.cat([leaf.reshape(-1).float() for leaf in leaves])


def unflatten_tree(flat: torch.Tensor, like: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """Split ``flat`` back into tensors shaped and typed like ``like``."""
    out, offset = [], 0
    for leaf in like:
        size = leaf.numel()
        out.append(flat[offset:offset + size].reshape(leaf.shape)
                   .to(leaf.dtype))
        offset += size
    return out


# ---------------------------------------------------------------------------
# The int8 codecs
# ---------------------------------------------------------------------------


def _quantize_int8_rows(rows: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric quantization of a (n, chunk) float32 matrix: one
    ``max(amax, 1e-30) * (1/127)`` scale per row, round-half-even codes
    clipped to +-127 (K1)."""
    return quantize_int8_rows(rows)


def _quantize_int8(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, 0-d scale) of one vector: the one-row case."""
    q, scales = _quantize_int8_rows(v.reshape(1, -1))
    return q[0], scales[0]


def _dequant_sum_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """SUM of dequantized rows, (n, chunk) s8 x (n,) -> (chunk,) (K2)."""
    return dequant_sum_rows(q, scales)


def _residual(carried: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """The error-feedback residual ``carried - q * scale``, with one
    rounding: XLA contracts the JAX codec's multiply and subtract into a
    fused multiply-add inside the compiled step."""
    return fma_f32(-q.float(), scale, carried)


def _int8_gather_sum(q: torch.Tensor, scale: torch.Tensor, n_shards: int,
                     group: Group = None) -> torch.Tensor:
    """Sum of every rank's dequantized codes via an s8 all-gather; the
    rows are summed in rank order on every rank, so the result is
    replicated and no int8 sum can overflow."""
    gathered = all_gather(q, group)
    scales = all_gather(scale.reshape(1), group)
    return _dequant_sum_rows(gathered.reshape(n_shards, -1), scales)


def _s8_all_gather_dequant(chunk: torch.Tensor, group: Group = None
                           ) -> torch.Tensor:
    """Quantize this rank's chunk with one scale, all-gather codes and
    scales, dequantize every rank's chunk: the (n x chunk,) float32
    reconstruction, the same on every rank."""
    q, scale = _quantize_int8(chunk)
    gathered = all_gather(q, group)
    scales = all_gather(scale.reshape(1), group)
    n = scales.shape[0]
    return (gathered.reshape(n, -1).float() * scales[:, None]).reshape(-1)


def _int8_multihop_sum(v: torch.Tensor, residual: torch.Tensor,
                       n_shards: int, group: Group = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-hop compressed SUM of one bucket: ``v`` is this rank's (S,)
    contribution, ``residual`` its (S_padded,) hop-1 error feedback.
    Returns (the (S,) global sum, the new residual)."""
    size = v.shape[0]
    padded = residual.shape[0]
    chunk = padded // n_shards
    carried = F.pad(v, (0, padded - size)) + residual
    rows = carried.reshape(n_shards, chunk)
    q, scales = _quantize_int8_rows(rows)
    new_residual = _residual(carried, q.reshape(-1),
                             scales.repeat_interleave(chunk))
    # hop 1: rank j receives every peer's chunk j and the scale of it
    recv_q = all_to_all(q.reshape(-1), group)
    recv_scales = all_to_all(scales, group)
    partial = _dequant_sum_rows(recv_q.reshape(n_shards, chunk), recv_scales)
    # hop 2: requantize the partial sum, gather codes and scales, dequant
    out = _s8_all_gather_dequant(partial, group)
    return out[:size], new_residual


def _int8_hier_sum(v: torch.Tensor, residual: torch.Tensor,
                   spec: HierSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-tier SUM of one bucket (the ``int8_hier`` wire): ``v`` is this
    rank's (S,) contribution, ``residual`` its (S_padded / n_inner,)
    slow-tier error feedback (S padded to a multiple of the world). An
    exact fp32 reduce-scatter inside the slice, `_int8_multihop_sum`
    across the slices on that partial (the one quantization), an exact
    all-gather inside the slice. Returns (the (S,) global sum, the new
    residual)."""
    size = v.shape[0]
    padded = residual.shape[0] * spec.n_inner
    carried = F.pad(v, (0, padded - size))
    part = (psum_scatter(carried, spec.fast_group) if spec.n_inner > 1
            else carried)
    summed, new_residual = _int8_multihop_sum(part, residual, spec.n_slices,
                                              spec.slice_group)
    if spec.n_inner > 1:
        summed = all_gather(summed, spec.fast_group)
    return summed[:size], new_residual


def _compressed_psum(v: torch.Tensor, n_shards: int, wire_dtype: str,
                     residual: Optional[torch.Tensor], group: Group = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One bucket's SUM at the ``fp32``, ``bf16`` or ``int8`` wire: (the
    float32 global sum, the new residual; None unless int8)."""
    if wire_dtype == "fp32":
        return psum(v, group), residual
    if wire_dtype == "bf16":
        return psum(v.to(torch.bfloat16), group).float(), residual
    if wire_dtype != "int8":
        raise ValueError(f"_compressed_psum reduces the fp32, bf16 and "
                         f"int8 wires, not {wire_dtype!r}")
    if residual is None:
        raise ValueError("int8 wire needs an error-feedback residual "
                         "(Trainer.init_state builds it)")
    carried = v + residual
    q, scale = _quantize_int8(carried)
    new_residual = _residual(carried, q, scale)
    return _int8_gather_sum(q, scale, n_shards, group), new_residual


def reduce_flat(flat: torch.Tensor, plan: BucketPlan, n_shards: int,
                wire_dtype: str, residual: Optional[torch.Tensor] = None,
                group: Group = None, hier: Optional[HierSpec] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Reduce this rank's (total_size,) float32 contribution bucket by
    bucket. Returns the globally summed vector and the updated residual
    (int8 wires; the flat layout for ``int8``, the `padded_bucket_bounds`
    layout for ``int8_multihop``, that layout's 1/n_inner slow-tier view
    for ``int8_hier``, which also needs the ``hier`` spec)."""
    check_wire(wire_dtype)
    multihop = wire_dtype == "int8_multihop"
    if wire_dtype == "int8_hier":
        if hier is None:
            raise ValueError("int8_hier wire needs a HierSpec (the trainer "
                             "builds it from the mesh's slice axis)")
        if residual is None:
            raise ValueError("int8_hier wire needs a slow-tier error-"
                             "feedback residual (Trainer.init_state "
                             "builds it)")
    elif multihop and residual is None:
        raise ValueError("int8_multihop wire needs a hop-1 error-feedback "
                         "residual (Trainer.init_state builds it)")
    pbounds = (padded_bucket_bounds(plan, n_shards)
               if multihop or wire_dtype == "int8_hier" else None)
    outs: List[torch.Tensor] = []
    res_outs: List[torch.Tensor] = []
    for k, (a, b) in enumerate(zip(plan.bounds, plan.bounds[1:])):
        v = flat[a:b]
        if wire_dtype == "int8_hier":
            r = residual[pbounds[k] // hier.n_inner:
                         pbounds[k + 1] // hier.n_inner]
            summed, new_r = _int8_hier_sum(v, r, hier)
        elif multihop:
            r = residual[pbounds[k]:pbounds[k + 1]]
            summed, new_r = _int8_multihop_sum(v, r, n_shards, group)
        else:
            r = residual[a:b] if residual is not None else None
            summed, new_r = _compressed_psum(v, n_shards, wire_dtype, r,
                                             group)
        outs.append(summed)
        if new_r is not None:
            res_outs.append(new_r)
    synced = torch.cat(outs) if len(outs) > 1 else outs[0]
    new_residual = ((torch.cat(res_outs) if len(res_outs) > 1
                     else res_outs[0]) if res_outs else None)
    return synced, new_residual


def ef_state_bucketed(leaves: Sequence, n_shards: int,
                      bucket_cap_mb: float = 0.0, wire_dtype: str = "int8",
                      device: torch.device = torch.device("cpu"),
                      n_slices: int = 1) -> dict:
    """This rank's zero error-feedback residual for the bucketed reducer:
    ``{"ef": (R,) float32}``, R the flat gradient size for ``int8``, the
    `padded_bucket_bounds` layout for ``int8_multihop`` and 1/n_inner of
    it for ``int8_hier`` (the JAX package keeps one such row per replica
    in an (n, R) array)."""
    check_wire(wire_dtype)
    plan = build_bucket_plan(leaves, bucket_cap_mb)
    if wire_dtype == "int8_multihop":
        total = padded_total_size(plan, n_shards)
    elif wire_dtype == "int8_hier":
        if n_slices < 2 or n_shards % n_slices:
            raise ValueError(
                f"int8_hier EF state needs a feasible factorization; got "
                f"{n_shards} shards over {n_slices} slices")
        total = padded_total_size(plan, n_shards) // (n_shards // n_slices)
    else:
        total = plan.total_size
    return {"ef": torch.zeros((total,), dtype=torch.float32, device=device)}


def ef_state_zero1(named: Sequence[Tuple[str, object]], n_shards: int,
                   n_inner: int = 1,
                   device: torch.device = torch.device("cpu")) -> dict:
    """This rank's zero residuals for the zero1 int8 scatter: one
    (flat_padded_size / n_inner,) float32 row per leaf, keyed by the
    leaf's name (``named``: (name, leaf) pairs in flax order). Under
    ``int8_hier`` the slow tier quantizes only the 1/n_inner partial."""
    return {"ef": {
        name: torch.zeros((flat_padded_size(_numel(leaf), n_shards)
                           // max(1, n_inner),), dtype=torch.float32,
                          device=device)
        for name, leaf in named}}


def ef_state_fsdp(named: Sequence[Tuple[str, object]], n_shards: int,
                  n_inner: int = 1,
                  device: torch.device = torch.device("cpu"),
                  replicated: Optional[Set[str]] = None) -> dict:
    """This rank's zero residuals for the explicit-FSDP int8 scatter: one
    (n_shards x row_size / n_inner,) float32 row per layer group
    (`build_layer_plan`, with its ``replicated``), keyed by the group's
    name: the residual covers every destination chunk, not just the kept
    one."""
    plan = build_layer_plan(named, n_shards, replicated=replicated)
    return {"ef": {
        g.name: torch.zeros((n_shards * g.row_size // max(1, n_inner),),
                            dtype=torch.float32, device=device)
        for g in plan.groups}}


# ---------------------------------------------------------------------------
# Layer plan (explicit FSDP): the per-layer cut of the parameter tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """One per-layer gather and scatter unit. ``leaf_slots`` index the
    leaves in flax order; ``chunk_sizes[i]`` is leaf ``leaf_slots[i]``'s
    chunk (flat-padded size / n_shards). The wire layout is
    destination-major: row j is every member leaf's chunk j, so one
    all-gather of this rank's row rebuilds every member leaf, and one
    reduce-scatter of the row stack lands each leaf's chunk on its
    owner."""

    name: str
    leaf_slots: Tuple[int, ...]
    chunk_sizes: Tuple[int, ...]

    @property
    def row_size(self) -> int:
        """Elements of this group on one rank (one gather/scatter row)."""
        return int(sum(self.chunk_sizes))


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One group per top-level module (``wte``, ``block0``, ...,
    ``ln_f``; ``stem_conv``, ``stage1_block0``, ..., ``fc``), built from
    shapes only, the same on every rank."""

    groups: Tuple[LayerGroup, ...]
    n_shards: int

    @property
    def total_padded(self) -> int:
        return self.n_shards * sum(g.row_size for g in self.groups)


def _top_level_key(name: str) -> str:
    return name_to_flax_path(name)[0]


def build_layer_plan(named: Sequence[Tuple[str, object]], n_shards: int,
                     per_leaf: bool = False,
                     replicated: Optional[Set[str]] = None) -> LayerPlan:
    """Group ``named`` ((name, leaf) pairs in flax order) into per-layer
    units by the flax path's top-level key, leaves in flax order inside a
    group. ``per_leaf`` makes every leaf its own group, named after it
    (zero1's per-leaf scatter). ``replicated`` (tensor parallelism: the
    leaves every model rank holds whole) puts those leaves of a key that
    also holds split leaves in a group of their own, ``<key>.replicated``:
    the int8 codecs take one scale a group row, and a row mixing a rank's
    own slices with the replicated leaves would quantize those on a
    different grid on each model rank, so that their copies drift
    apart."""
    replicated = replicated or set()
    mixed = {_top_level_key(n) for n, _ in named if n not in replicated} \
        & {_top_level_key(n) for n, _ in named if n in replicated}
    by_key: dict = {}
    order: List[str] = []
    for slot, (name, leaf) in enumerate(named):
        key = name if per_leaf else _top_level_key(name)
        if not per_leaf and key in mixed and name in replicated:
            key += ".replicated"
        if key not in by_key:
            by_key[key] = []
            order.append(key)
        by_key[key].append(
            (slot, flat_padded_size(_numel(leaf), n_shards) // n_shards))
    groups = tuple(
        LayerGroup(name=k, leaf_slots=tuple(s for s, _ in by_key[k]),
                   chunk_sizes=tuple(c for _, c in by_key[k]))
        for k in order)
    return LayerPlan(groups=groups, n_shards=n_shards)


# ---------------------------------------------------------------------------
# The sharded update's scatters and gathers
# ---------------------------------------------------------------------------


def compressed_psum_scatter(v: torch.Tensor, n_shards: int, wire_dtype: str,
                            residual: Optional[torch.Tensor] = None,
                            group: Group = None
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Reduce-scatter one flat-padded leaf (or layer-group row stack) at
    the wire dtype: ``v`` is this rank's (padded,) float32 contribution,
    padded divisible by ``n_shards``. Returns this rank's (padded/n,)
    chunk of the sum over ranks and the new residual (int8 only, the full
    padded size: it remembers what was dropped from every chunk). int8
    quantizes the whole vector with one scale (K1), sends chunk j of the
    s8 codes to rank j (all-to-all) beside a gather of the scales, and
    sums the n received rows dequantized (K2)."""
    if wire_dtype == "fp32":
        return psum_scatter(v, group), residual
    if wire_dtype == "bf16":
        return psum_scatter(v.to(torch.bfloat16), group).float(), residual
    if wire_dtype == "int8_multihop":
        raise ValueError(
            "the zero1 scatter half is ALREADY the n-independent s8 "
            "all-to-all: the zero1 step maps wire_dtype='int8_multihop' "
            "to the 'int8' scatter codec before calling here (what "
            "multihop adds on zero1 is the compressed param gather — "
            "quantized_delta_all_gather)")
    if wire_dtype != "int8":
        raise ValueError(f"unknown wire dtype {wire_dtype!r} "
                         f"(choose from {WIRE_DTYPES})")
    if residual is None:
        raise ValueError("int8 wire needs an error-feedback residual "
                         "(Trainer.init_state builds it)")
    carried = v + residual
    q, scale = _quantize_int8(carried)
    new_residual = _residual(carried, q, scale)
    received = all_to_all(q, group)
    scales = all_gather(scale.reshape(1), group)
    return (_dequant_sum_rows(received.reshape(n_shards, -1), scales),
            new_residual)


def quantized_delta_all_gather(new_shard: torch.Tensor,
                               old_shard: torch.Tensor,
                               old_flat: torch.Tensor,
                               group: Group = None) -> torch.Tensor:
    """The zero1 parameter gather of ``int8_multihop``: every rank's
    UPDATE chunk (new - old) as s8 codes with one scale a chunk, added to
    the replicated old flat-padded parameters. Every rank dequantizes the
    same codes, so the result is replicated."""
    return old_flat + _s8_all_gather_dequant(new_shard - old_shard, group)


def quantized_shard_all_gather(shard: torch.Tensor,
                               group: Group = None) -> torch.Tensor:
    """The explicit-FSDP parameter gather of ``int8_multihop``: s8 codes
    of every rank's at-rest row (one scale a row), dequantized the same on
    every rank; the at-rest rows stay exact."""
    return _s8_all_gather_dequant(shard, group)


def hier_psum_scatter(v: torch.Tensor, spec: HierSpec,
                      residual: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Two-tier reduce-scatter of one flat-padded leaf or row stack
    (``v`` padded divisible by the world): an exact fp32 reduce-scatter
    inside the slice, then the int8 scatter across the slices on that
    1/n_inner partial, with error feedback (``residual`` spans the whole
    partial). Returns chunk ``spec.owner`` of the sum and the new
    residual."""
    part = (psum_scatter(v, spec.fast_group) if spec.n_inner > 1 else v)
    return compressed_psum_scatter(part, spec.n_slices, "int8", residual,
                                   spec.slice_group)


def hier_delta_all_gather(new_shard: torch.Tensor, old_shard: torch.Tensor,
                          old_flat: torch.Tensor,
                          spec: HierSpec) -> torch.Tensor:
    """`quantized_delta_all_gather` on the two tiers: s8 update codes
    across the slices, then an exact gather inside the slice (the
    fast-major ownership's order)."""
    part = _s8_all_gather_dequant(new_shard - old_shard, spec.slice_group)
    if spec.n_inner > 1:
        part = all_gather(part, spec.fast_group)
    return old_flat + part


def hier_shard_all_gather(shard: torch.Tensor,
                          spec: HierSpec) -> torch.Tensor:
    """`quantized_shard_all_gather` on the two tiers: s8 codes of the
    at-rest rows across the slices, then an exact gather inside the
    slice."""
    part = _s8_all_gather_dequant(shard, spec.slice_group)
    if spec.n_inner > 1:
        part = all_gather(part, spec.fast_group)
    return part


# ---------------------------------------------------------------------------
# Wire accounting of the sharded update
# ---------------------------------------------------------------------------


def _flat_padded_total(leaves: Sequence, n_shards: int) -> int:
    """Sum of every leaf's flat-padded size: the elements on the FSDP
    wire."""
    return int(sum(flat_padded_size(_numel(leaf), n_shards)
                   for leaf in leaves))


def fsdp_gather_bytes(leaves: Sequence, wire_dtype: str, n_shards: int,
                      n_slices: int = 1) -> int:
    """Per-replica bytes of one full per-layer parameter gather pass under
    explicit FSDP (payload only): 4 a padded element exactly on the
    fp32, bf16 and int8 wires, 1 under ``int8_multihop`` (s8 codes);
    ``int8_hier`` moves total/n_inner s8 bytes across the slices and 4 a
    padded element inside the slice."""
    check_wire(wire_dtype)
    if n_shards <= 1:
        return 0
    total = _flat_padded_total(leaves, n_shards)
    if wire_dtype == "int8_hier":
        if n_slices <= 1:
            return 4 * total
        n_inner = n_shards // n_slices
        return (4 * total if n_inner > 1 else 0) + total // n_inner
    return total if wire_dtype == "int8_multihop" else 4 * total


def tp_psum_bytes_per_step(hidden: int, depth: int, local_batch: int,
                           seq: int, model_n: int, tp_vocab: bool = False
                           ) -> int:
    """This rank's model-axis bytes of one tensor-parallel training step
    (payload only, the JAX package's conventions): each megatron
    all-reduce of a (local_batch, seq, hidden) float32 activation counts
    ~8 bytes an element (a ring all-reduce); 4 a block (the forward sums
    at the residual joins, their mirrors at the regions' inputs) and 2
    more with the vocab-parallel embedding, which also adds the
    parallel-vocab cross-entropy's two (local_batch, seq, 2) stat
    collectives (32 bytes a position)."""
    if model_n <= 1:
        return 0
    act = local_batch * seq * hidden
    n_psums = 4 * depth + (2 if tp_vocab else 0)
    total = 8 * act * n_psums
    if tp_vocab:
        total += 32 * local_batch * seq
    return total


def wire_bytes_split_for_config(leaves: Sequence, cfg: Optional[dict],
                                n_shards: int) -> dict:
    """Per-replica wire bytes of one step's gradient sync from a
    TrainConfig-style dict (``wire_dtype``, ``bucket_cap_mb``,
    ``fsdp_explicit``, ``slices``), split by tier: ``{"ici": fast-tier
    bytes, "dcn": slow-tier bytes}``. Every flat wire is all fast tier;
    ``int8_hier`` puts the cross-slice s8 traffic in "dcn". Under
    ``fsdp_explicit`` it is the gradient scatter plus the parameter
    gather (`fsdp_gather_bytes`)."""
    cfg = dict(cfg or {})
    wire = cfg.get("wire_dtype", "fp32")
    check_wire(wire)
    n_slices = int(cfg.get("slices", 1))
    if n_slices >= 1 and n_shards > 1 and n_shards % n_slices:
        raise ValueError(
            f"int8_hier: {n_shards} batch shards do not factor into "
            f"{n_slices} slices (world % slices != 0)")
    hier = wire == "int8_hier" and n_slices > 1 and n_shards > 1
    if cfg.get("fsdp_explicit"):
        if n_shards <= 1:
            return {"ici": 0, "dcn": 0}
        total = _flat_padded_total(leaves, n_shards)
        if hier:
            n_inner = n_shards // n_slices
            fast = 8 * total if n_inner > 1 else 0
            return {"ici": fast, "dcn": 2 * (total // n_inner)}
        scatter = {"fp32": 4, "bf16": 2, "int8": 1, "int8_multihop": 1,
                   "int8_hier": 4}[wire] * total
        return {"ici": scatter + fsdp_gather_bytes(leaves, wire, n_shards),
                "dcn": 0}
    plan = build_bucket_plan(leaves, float(cfg.get("bucket_cap_mb", 0.0)))
    if hier:
        split = hier_wire_bytes(plan, n_shards, n_slices)
        return {"ici": split["ici"], "dcn": split["dcn"]}
    return {"ici": wire_bytes_per_replica(plan, wire, n_shards), "dcn": 0}


def emit_wire_accounting(leaves: Sequence, grad_sync_cfg: Optional[dict],
                         n_shards: int, tier: str = "ici",
                         **attrs: Any) -> dict:
    """Record the configured sync mode's per-replica wire accounting as
    telemetry counters (host-side, once at setup, from train.py) and
    return the numbers: THE one emission site, the JAX package's rows.
    ``leaves`` are the model-shaped parameters (anything with a
    ``.shape``, flax order; under tensor parallelism the TP-local ones).
    Extra ``attrs`` ride every emitted counter.

    One ``wire_bytes_per_replica`` row at ``tier``; ``int8_hier`` configs
    (``cfg["slices"]`` > 1) emit TWO, one per interconnect tier —
    (tier="ici", axis="data") for the exact intra-slice half and
    (tier="dcn", axis="slice") for the compressed cross-slice half — and
    ``fsdp_explicit`` adds the ``fsdp_gather_bytes`` row. Tensor
    parallelism (``cfg["model_shards"]`` > 1 with
    ``cfg["tp_psum_bytes"]``, `tp_psum_bytes_per_step`): the model-axis
    bytes get their own ``tp_psum_bytes_per_replica`` row (axis="model")
    and the data-axis rows are tagged axis="data"."""
    from .. import telemetry

    cfg = dict(grad_sync_cfg or {})
    wire = cfg.get("wire_dtype", "fp32")
    model_shards = int(cfg.get("model_shards", 1))
    n_slices = int(cfg.get("slices", 1))
    tp_bytes = int(cfg.get("tp_psum_bytes", 0)) if model_shards > 1 else 0
    hier = (wire == "int8_hier" and n_slices > 1 and n_shards > 1)
    split = wire_bytes_split_for_config(leaves, cfg, n_shards)
    out = {"tier": tier, "wire_dtype": wire, "n_shards": n_shards,
           "wire_bytes_per_replica": split["ici"] + split["dcn"]}
    axis_attr = {"axis": "data"} if model_shards > 1 else {}
    if hier:
        out["wire_bytes_ici"] = split["ici"]
        out["wire_bytes_dcn"] = split["dcn"]
        out["n_slices"] = n_slices
        telemetry.counter("wire_bytes_per_replica", split["ici"],
                          tier="ici", axis="data", wire_dtype=wire,
                          n_shards=n_shards, n_slices=n_slices, **attrs)
        telemetry.counter("wire_bytes_per_replica", split["dcn"],
                          tier="dcn", axis="slice", wire_dtype=wire,
                          n_shards=n_shards, n_slices=n_slices, **attrs)
    else:
        telemetry.counter("wire_bytes_per_replica",
                          out["wire_bytes_per_replica"], tier=tier,
                          wire_dtype=wire, n_shards=n_shards, **axis_attr,
                          **attrs)
    if cfg.get("fsdp_explicit"):
        out["fsdp_gather_bytes"] = fsdp_gather_bytes(leaves, wire, n_shards,
                                                     n_slices)
        telemetry.counter("fsdp_gather_bytes", out["fsdp_gather_bytes"],
                          tier=tier, wire_dtype=wire, n_shards=n_shards,
                          **axis_attr, **attrs)
    if tp_bytes:
        out["tp_psum_bytes_per_replica"] = tp_bytes
        telemetry.counter("tp_psum_bytes_per_replica", tp_bytes, tier=tier,
                          axis="model", model_shards=model_shards, **attrs)
    return out
