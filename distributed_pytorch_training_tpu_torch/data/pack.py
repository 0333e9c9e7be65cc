"""Online sequence packing: ragged request batches -> static bucket shapes
(copied from the JAX package's data/pack.py; numpy only).

The bucket ladder keeps the engine's shapes to a small static set, one per
rung: a request pays padding at most to the next rung.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= ``length`` from the (sorted-ascending) bucket
    ladder. A length above the top rung raises: silently truncating a
    request would serve logits for a prompt nobody sent."""
    if length <= 0:
        raise ValueError(f"sequence length must be >= 1, got {length}")
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    raise ValueError(
        f"sequence length {length} exceeds the largest bucket "
        f"{max(buckets)} — add a rung to the bucket ladder or reject the "
        "request upstream")


def pack_token_rows(
    seqs: Sequence[np.ndarray], bucket: int, rows: int, pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack ragged token sequences into one static (rows, bucket) batch.

    Returns ``(ids, lengths, weight)``: ``ids`` int32 right-padded with
    ``pad_id`` (positions 0..len-1 keep the eval forward's position
    embeddings), ``lengths`` int32 per-row real lengths (0 for the filler
    rows beyond ``len(seqs)``), and ``weight`` fp32 1.0/0.0 per row. Each
    request is its own row, so cross-request attention cannot exist; the
    causal mask keeps real positions from attending forward into pad.
    """
    if len(seqs) > rows:
        raise ValueError(f"{len(seqs)} sequences do not fit {rows} rows")
    ids = np.full((rows, bucket), pad_id, np.int32)
    lengths = np.zeros(rows, np.int32)
    weight = np.zeros(rows, np.float32)
    for i, s in enumerate(seqs):
        s = np.asarray(s)
        if s.ndim != 1:
            raise ValueError(f"sequence {i} is not 1-D (shape {s.shape})")
        if len(s) > bucket:
            raise ValueError(
                f"sequence {i} ({len(s)} tokens) exceeds bucket {bucket} — "
                "route it through bucket_for first")
        ids[i, : len(s)] = s
        lengths[i] = len(s)
        weight[i] = 1.0
    return ids, lengths, weight


def unpack_token_rows(outputs: np.ndarray, lengths: np.ndarray,
                      n_real: int) -> List[np.ndarray]:
    """Invert `pack_token_rows` on a per-position output (rows, bucket, ...):
    per-request arrays with every pad position dropped. ``n_real`` cuts the
    filler rows."""
    out = []
    for i in range(int(n_real)):
        out.append(np.asarray(outputs[i][: int(lengths[i])]))
    return out
