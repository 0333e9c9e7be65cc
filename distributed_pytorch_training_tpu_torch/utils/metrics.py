"""Metrics persistence and throughput measurement (the JAX package's
``utils/metrics.py``): ``metrics_rank0.csv`` with the reference's schema,
written by process 0 only, and the windowed samples/s meter."""

from __future__ import annotations

import os
import time
from pathlib import Path

from .logging import is_main_process


class MetricsCSV:
    """Process-0 CSV writer with the reference's exact schema."""

    HEADER = "epoch,train_loss,train_acc,val_loss,val_acc,epoch_time_seconds\n"

    def __init__(self, output_dir: str, filename: str = "metrics_rank0.csv"):
        self.path = Path(output_dir) / filename
        if is_main_process():
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if not self.path.exists():  # append-only across runs
                self.path.write_text(self.HEADER)

    def append(self, epoch: int, train_loss: float, train_acc: float,
               val_loss: float, val_acc: float, epoch_time: float) -> None:
        """One row per epoch, flushed and fsynced before the handle
        closes, so a crash right after an epoch keeps its row."""
        if not is_main_process():
            return
        with self.path.open("a") as f:
            f.write(
                f"{epoch + 1},{train_loss:.4f},{train_acc:.2f},"
                f"{val_loss:.4f},{val_acc:.2f},{epoch_time:.4f}\n"
            )
            f.flush()
            os.fsync(f.fileno())


class ThroughputMeter:
    """Windowed samples/s: accumulate global sample counts, read and
    reset at print boundaries; timed with the monotonic perf_counter."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._samples = 0

    def update(self, n_global_samples: int) -> None:
        self._samples += n_global_samples

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._samples / dt if dt > 0 else 0.0
