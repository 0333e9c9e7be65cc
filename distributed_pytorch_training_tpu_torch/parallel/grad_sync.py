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

The ``int8_hier`` wire raises, naming its slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.quantize import dequant_sum_rows, fma_f32, quantize_int8_rows
from ..runtime import not_ported
from .collectives import Group, all_gather, all_to_all, psum

WIRE_DTYPES = ("fp32", "bf16", "int8", "int8_multihop", "int8_hier")

# Wire modes whose codec carries an error-feedback residual
EF_WIRE_DTYPES = ("int8", "int8_multihop", "int8_hier")

# the wires this port reduces; the others raise in reduce_flat
PORTED_WIRES = ("fp32", "bf16", "int8", "int8_multihop")
_WIRE_SLICE = {"int8_hier": "the multi-slice (--slices) slice"}


def refuse_unported_wire(wire_dtype: str) -> None:
    """Raise for a wire of WIRE_DTYPES this port does not reduce yet."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r} "
                         f"(choose from {WIRE_DTYPES})")
    if wire_dtype not in PORTED_WIRES:
        raise not_ported(f"the {wire_dtype} gradient wire",
                         _WIRE_SLICE[wire_dtype])


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
                group: Group = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Reduce this rank's (total_size,) float32 contribution bucket by
    bucket. Returns the globally summed vector and the updated residual
    (int8 wires; the flat layout for ``int8``, the `padded_bucket_bounds`
    layout for ``int8_multihop``)."""
    refuse_unported_wire(wire_dtype)
    multihop = wire_dtype == "int8_multihop"
    if multihop and residual is None:
        raise ValueError("int8_multihop wire needs a hop-1 error-feedback "
                         "residual (Trainer.init_state builds it)")
    pbounds = padded_bucket_bounds(plan, n_shards) if multihop else None
    outs: List[torch.Tensor] = []
    res_outs: List[torch.Tensor] = []
    for k, (a, b) in enumerate(zip(plan.bounds, plan.bounds[1:])):
        v = flat[a:b]
        if multihop:
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
                      device: torch.device = torch.device("cpu")) -> dict:
    """This rank's zero error-feedback residual for the bucketed reducer:
    ``{"ef": (R,) float32}``, R the flat gradient size for ``int8`` and
    the `padded_bucket_bounds` layout for ``int8_multihop`` (the JAX
    package keeps one such row per replica in an (n, R) array)."""
    refuse_unported_wire(wire_dtype)
    plan = build_bucket_plan(leaves, bucket_cap_mb)
    if wire_dtype == "int8_multihop":
        total = padded_total_size(plan, n_shards)
    else:
        total = plan.total_size
    return {"ef": torch.zeros((total,), dtype=torch.float32, device=device)}
