"""Sharded sampling (the JAX package's data/sampler.py, copied).

A global permutation seeded by ``seed + epoch``, padded up to a whole
number of global batches; a per-sample weight marks the padding with 0, and
the padding slots hold wrap-around repeats of the permutation, so every
batch has the same shape and loss and metrics stay exact. The index plan is
bitwise the JAX package's (``native.permutation``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from .. import native


@dataclasses.dataclass
class ShardedSampler:
    """Deterministic epoch sharding of ``n`` samples into fixed-size global
    batches, sliced per batch shard: ``process_index`` and
    ``process_count`` are a rank's position on the mesh's batch axes and
    their size (the rank and the world on a data-only mesh; ranks that
    differ only in ``seq`` take the same slice)."""

    n: int
    global_batch: int
    shuffle: bool = True
    seed: int = 42
    drop_last: bool = False
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if self.global_batch % self.process_count:
            raise ValueError(
                f"global batch {self.global_batch} not divisible by "
                f"{self.process_count} processes"
            )
        self.local_batch = self.global_batch // self.process_count

    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.n // self.global_batch
        return -(-self.n // self.global_batch)  # ceil

    def epoch_indices(self, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        """(indices, weights) for this process, shaped (steps,
        local_batch); weights are 0.0 on padding slots."""
        if self.shuffle:
            order = native.permutation(self.seed + epoch, self.n)
        else:
            order = np.arange(self.n)
        steps = self.steps_per_epoch()
        usable = steps * self.global_batch
        if self.drop_last:
            order = order[:usable]
            weights = np.ones(usable, np.float32)
        else:
            pad = usable - self.n
            weights = np.concatenate([np.ones(self.n, np.float32),
                                      np.zeros(pad, np.float32)])
            # wrap-around padding with real samples
            reps = np.resize(order, pad) if pad else order[:0]
            order = np.concatenate([order, reps])
        order = order.reshape(steps, self.process_count, self.local_batch)
        weights = weights.reshape(steps, self.process_count, self.local_batch)
        return order[:, self.process_index], weights[:, self.process_index]

    def iter_epoch(self, epoch: int, start_step: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The epoch's (indices, weights) per step, from ``start_step``."""
        idx, w = self.epoch_indices(epoch)
        for step in range(start_step, idx.shape[0]):
            yield idx[step], w[step]
