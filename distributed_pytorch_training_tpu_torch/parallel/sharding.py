"""The flat-padded layout of the sharded update (the JAX package's
parallel/sharding.py, its ZeRO-1 and explicit-FSDP part).

The sharded weight update partitions every parameter's flattened value
over the ranks: a leaf of ``size`` elements is zero-padded to a multiple
of the world size N and cut into N equal chunks, so tensor shapes never
constrain divisibility and the update is elementwise work on (padded/N,)
chunks. The padding carries zero gradient, so it stays zero through any
elementwise optimizer. Rank r holds chunk ``owner`` (r itself, or the
fast-major index of the ``int8_hier`` wire, ``grad_sync.HierSpec``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F


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
