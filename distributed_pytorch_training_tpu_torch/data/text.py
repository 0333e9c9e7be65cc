"""Token datasets and the LM loader (the JAX package's data/text.py).

Corpora are synthetic token streams with Zipfian unigram statistics, drawn
with numpy's ``RandomState`` so that the tokens are bitwise the JAX
package's, or token files loaded from disk (.npy, or a flat .bin of uint16
ids). ``TokenLoader`` yields batches on the run's device.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .. import native
from .sampler import ShardedSampler


@dataclasses.dataclass
class TokenDataset:
    """Packed token ids (N, seq_len) int32, already chunked to sequences."""

    tokens: np.ndarray  # (N, S) int32
    vocab_size: int
    name: str = "tokens"
    synthetic: bool = False

    def __post_init__(self):
        if self.tokens.ndim != 2:
            raise ValueError(f"tokens must be (N, seq_len), got shape "
                             f"{self.tokens.shape}")
        self.tokens = self.tokens.astype(np.int32)

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]


def synthetic_token_dataset(n: int, seq_len: int, vocab_size: int,
                            seed: int = 0,
                            name: str = "synthetic-tokens") -> TokenDataset:
    """Zipfian token sequences, deterministic in ``seed``."""
    rng = np.random.RandomState(seed)
    # Zipf over the vocab (clipped to vocab_size); ids shuffled so frequent
    # tokens are spread over the id space like a real BPE vocab
    raw = rng.zipf(1.3, size=(n, seq_len))
    ids = np.minimum(raw, vocab_size) - 1
    perm = np.random.RandomState(1234).permutation(vocab_size)
    return TokenDataset(perm[ids], vocab_size, name=name, synthetic=True)


def load_token_file(path: str, seq_len: int, vocab_size: int) -> TokenDataset:
    """A packed token file (.npy, or a flat .bin of uint16) chunked into
    (N, seq_len)."""
    p = Path(path)
    if p.suffix == ".npy":
        flat = np.load(p, mmap_mode="r").ravel()
    else:
        flat = np.fromfile(p, dtype=np.uint16).astype(np.int64)
    n = len(flat) // seq_len
    return TokenDataset(flat[: n * seq_len].reshape(n, seq_len).astype(np.int32),
                        vocab_size, name=p.stem, synthetic=False)


def get_token_dataset(name: str, seq_len: int, data_dir: str = "./data",
                      train: bool = True,
                      synthetic_size: Optional[int] = None,
                      seed: int = 0) -> TokenDataset:
    """Keyed by config family: 'bert' (vocab 30522), 'gpt2' (50257). Reads
    ``<data_dir>/<name>_{train,val}.npy`` when present, else synthesizes."""
    vocabs = {"bert": 30522, "gpt2": 50257}
    if name not in vocabs:
        raise ValueError(f"unknown text dataset {name!r} ({sorted(vocabs)})")
    vocab = vocabs[name]
    fname = Path(data_dir) / f"{name}_{'train' if train else 'val'}.npy"
    if fname.exists():
        return load_token_file(str(fname), seq_len, vocab)
    n = synthetic_size or (4096 if train else 512)
    return TokenDataset(
        synthetic_token_dataset(n, seq_len, vocab,
                                seed=seed + (0 if train else 1)).tokens,
        vocab, name=f"{name}-synthetic", synthetic=True)


class TokenLoader:
    """This rank's LM batches {"input_ids": (B, S) int32, "weight": (B,)
    float32} on ``device``, ``per_device_batch`` rows each: its contiguous
    slice of every global batch of ``per_device_batch * process_count``
    rows, with the sampler's padding and weights (``data/loader.py``'s
    sharding). The slices follow the batch coordinate, not the rank: on a
    mesh with a ``seq`` axis the entry passes ``process_index`` = the
    rank's position on the batch axes and ``process_count`` =
    ``batch_shard_count`` (``parallel/mesh.py``), so every rank of a seq
    line holds the same full rows (each runs its own positions). On a CUDA device each batch is copied from pinned host
    memory with ``non_blocking``; the caching host allocator keeps the
    pinned block until its copy has run."""

    def __init__(self, dataset: TokenDataset, per_device_batch: int,
                 shuffle: bool, seed: int = 42, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1,
                 device: torch.device = torch.device("cpu"),
                 fault_hook: Optional[Callable[[int], None]] = None):
        # the loader_stall injection point: called with the step index
        # before that step's batch is produced (None: no chaos plan)
        self.fault_hook = fault_hook
        self.dataset = dataset
        self.device = torch.device(device)
        self.global_batch = per_device_batch * process_count
        self.sampler = ShardedSampler(
            n=len(dataset), global_batch=self.global_batch, shuffle=shuffle,
            seed=seed, drop_last=drop_last, process_index=process_index,
            process_count=process_count)

    def __len__(self) -> int:
        return self.sampler.steps_per_epoch()

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def epoch(self, epoch: int, start_step: int = 0
              ) -> Iterator[Dict[str, torch.Tensor]]:
        for k, (idx, w) in enumerate(self.sampler.iter_epoch(epoch,
                                                             start_step)):
            if self.fault_hook is not None:
                self.fault_hook(start_step + k)
            yield {
                "input_ids": self._to_device(
                    native.gather_rows(self.dataset.tokens, idx)),
                "weight": self._to_device(np.ascontiguousarray(w)),
            }
