"""Deterministic fault injection: a parsed ``FaultPlan`` and one-shot hooks
(the JAX package's resilience/faults.py: the same grammar, errors and
firing rules).

The plan is a comma-separated spec (``--chaos``) of faults pinned to
exact trigger points:

* ``crash@step=7`` — raise :class:`FaultError` at the step-7 fence
  (before the step executes; the optimizer never applies step 7);
* ``sigterm@step=12`` — deliver a real SIGTERM to this process at the
  step-12 fence (the preemption path through ``PreemptionGuard``);
  step 12 still executes, then the loop stops at the next boundary;
* ``torn_ckpt@save=2`` — truncate the largest file of the 2nd checkpoint
  save AFTER its manifest was written, so the manifest verification of
  ``training/checkpoint.py`` must catch and skip it;
* ``crash_during_save@save=3`` — raise :class:`FaultError` inside the 3rd
  save, between the files' commit and the manifest (the writer thread's
  crash: the pending marker marks the checkpoint torn);
* ``loader_stall@step=5:2.5s`` — sleep 2.5 s in the data loader before
  it produces the batch of step 5;
* ``replica_death@step=7`` and ``capacity_return@step=7`` parse as in the
  JAX package; ``train.main`` refuses them until the elastic slice.

Any spec may carry a repeat count (``crash@step=3x2`` fires twice). Step
indices are the absolute global step for ``crash`` and ``sigterm``; the
loaders call their hook with ``start_step + k``. ``save`` counts are
1-indexed: finalized saves for ``torn_ckpt``, save attempts reaching the
finalize window for ``crash_during_save``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

# kind -> the only trigger it accepts (a typo'd trigger must fail loudly)
FAULT_KINDS = {
    "crash": "step",
    "sigterm": "step",
    "loader_stall": "step",
    "torn_ckpt": "save",
    "crash_during_save": "save",
    "replica_death": "step",
    "capacity_return": "step",
}

# the kinds the fixed-world port refuses (train.main), and their slice
ELASTIC_KINDS = ("replica_death", "capacity_return")

_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<trigger>[a-z]+)=(?P<at>\d+)"
    r"(?::(?P<arg>\d+(?:\.\d+)?)s?)?(?:\s*x(?P<rep>\d+))?$")


class FaultError(RuntimeError):
    """An injected crash: the supervisor's restartable failure class."""


class ReplicaDeathError(FaultError):
    """An injected loss of a data-parallel replica
    (``replica_death@step=k``). ``survivors`` is filled by an elastic
    supervisor (the elastic slice)."""

    def __init__(self, message: str, survivors: Optional[int] = None):
        super().__init__(message)
        self.survivors = survivors


def _stderr_log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str        # crash | sigterm | loader_stall | torn_ckpt | ...
    trigger: str     # "step" or "save"
    at: int          # step index (0-based) or save count (1-based)
    seconds: float = 0.0  # loader_stall duration
    count: int = 1   # repeat count (the `xK` suffix): firings before spent

    def label(self, remaining: Optional[int] = None) -> str:
        """The label of one firing; with ``remaining`` > 1 the repeat
        suffix rides along (what ``unfired()`` reports)."""
        tail = f":{self.seconds:g}s" if self.kind == "loader_stall" else ""
        rep = (f"x{remaining}" if remaining is not None and remaining > 1
               else "")
        return f"{self.kind}@{self.trigger}={self.at}{tail}{rep}"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable parsed plan; arm it by building a :class:`FaultInjector`."""

    faults: Tuple[Fault, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.faults)

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultPlan":
        """``"crash@step=7,torn_ckpt@save=2,loader_stall@step=5:2.5s"``.
        An empty or None spec is the empty plan."""
        faults: List[Fault] = []
        for item in filter(None, (s.strip()
                                  for s in (spec or "").split(","))):
            m = _SPEC_RE.match(item)
            if not m:
                raise ValueError(
                    f"chaos fault {item!r} is not kind@trigger=N[:SECs] "
                    f"(kinds: {sorted(FAULT_KINDS)})")
            kind, trigger = m.group("kind"), m.group("trigger")
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown chaos fault kind {kind!r} "
                                 f"(kinds: {sorted(FAULT_KINDS)})")
            if trigger != FAULT_KINDS[kind]:
                raise ValueError(
                    f"chaos fault {kind!r} triggers on "
                    f"{FAULT_KINDS[kind]!r}, not {trigger!r}")
            seconds = float(m.group("arg") or 0.0)
            if kind == "loader_stall" and seconds <= 0:
                raise ValueError(
                    f"loader_stall needs a duration ({item!r}; e.g. "
                    "loader_stall@step=5:2.5s)")
            if kind != "loader_stall" and m.group("arg"):
                raise ValueError(
                    f"chaos fault {kind!r} takes no :SECs argument ({item!r})")
            count = int(m.group("rep") or 1)
            if count < 1:
                raise ValueError(
                    f"chaos fault repeat count must be >= 1 ({item!r}; "
                    "omit the x-suffix for a one-shot fault)")
            faults.append(Fault(kind=kind, trigger=trigger,
                                at=int(m.group("at")), seconds=seconds,
                                count=count))
        return cls(faults=tuple(faults))


def tear_checkpoint(step_dir: Path,
                    log: Callable[[str], None] = _stderr_log) -> Path:
    """Truncate the largest file under a finalized checkpoint directory to
    half its size: the canonical torn checkpoint. Returns the torn file's
    path; raises when the directory holds no file (tearing nothing would
    let a chaos run pass vacuously)."""
    files = sorted((p for p in Path(step_dir).rglob("*") if p.is_file()),
                   key=lambda p: p.stat().st_size, reverse=True)
    if not files:
        raise FileNotFoundError(f"no file to tear under {step_dir}")
    victim = files[0]
    size = victim.stat().st_size
    with open(victim, "r+b") as f:
        f.truncate(max(1, size // 2))
    log(f"chaos: TORE checkpoint file {victim} ({size} -> "
        f"{victim.stat().st_size} bytes)")
    return victim


class FaultInjector:
    """The armed, mutable state of one plan: each fault fires once (or its
    repeat count), and what fired is recorded (``fired``, ``unfired()``).

    The stack calls ``on_step(step)`` from the trainer's step fence,
    ``on_loader_batch(step)`` from the data loader, ``on_save(label,
    step_dir)`` after a save finalized and ``on_save_finalize(label)``
    between a save's commit and its manifest. The hooks may run on
    different threads (the checkpoint writer's), so one lock guards the
    pending list and the counters."""

    def __init__(self, plan: FaultPlan,
                 log: Callable[[str], None] = _stderr_log):
        self.plan = plan
        self.log = log
        # [fault, remaining firings]; a fault leaves the list once spent
        self._pending: List[list] = [[f, f.count] for f in plan.faults]
        self.fired: List[str] = []
        self.saves_seen = 0
        self.finalizes_seen = 0
        self._lock = threading.Lock()

    def unfired(self) -> List[str]:
        with self._lock:
            return [f.label(remaining=n) for f, n in self._pending]

    def _take(self, kind: str, at: int) -> Optional[Fault]:
        with self._lock:
            for entry in self._pending:
                f, remaining = entry
                if f.kind == kind and f.at == at:
                    if remaining <= 1:
                        self._pending.remove(entry)
                    else:
                        entry[1] = remaining - 1
                    self.fired.append(f.label())
                    return f
            return None

    def on_step(self, step: int) -> None:
        """Step fence, called BEFORE global step ``step`` executes."""
        if self._take("capacity_return", step) is not None:
            self.log(f"chaos: capacity returned at step {step} (no "
                     "capacity watch in a fixed-world run: nothing to "
                     "notify)")
        if self._take("sigterm", step) is not None:
            self.log(f"chaos: delivering SIGTERM at step {step}")
            os.kill(os.getpid(), signal.SIGTERM)
        if self._take("replica_death", step) is not None:
            self.log(f"chaos: injected replica death at step {step}")
            raise ReplicaDeathError(
                f"injected replica_death@step={step} (one data-parallel "
                "replica lost)")
        if self._take("crash", step) is not None:
            self.log(f"chaos: injected crash at step {step}")
            raise FaultError(f"injected crash@step={step}")

    def on_loader_batch(self, step: int) -> None:
        """Called by a loader before it produces the batch of ``step``."""
        f = self._take("loader_stall", step)
        if f is not None:
            self.log(f"chaos: stalling loader {f.seconds:g}s at step {step}")
            time.sleep(f.seconds)

    def on_save(self, label: int, step_dir: Path) -> None:
        """After save ``label`` finalized (its manifest is written, so a
        tear here must be caught by the verification at restore)."""
        with self._lock:
            self.saves_seen += 1
            count = self.saves_seen
        if self._take("torn_ckpt", count) is not None:
            tear_checkpoint(Path(step_dir), log=self.log)

    def on_save_finalize(self, label: int) -> None:
        """Between a save's commit and its manifest (on the writer thread
        under async saves): ``crash_during_save`` raises here, leaving a
        committed checkpoint with a pending marker and no manifest."""
        with self._lock:
            self.finalizes_seen += 1
            count = self.finalizes_seen
        if self._take("crash_during_save", count) is not None:
            self.log(f"chaos: injected crash during save {count} "
                     f"(checkpoint {label}, between commit and manifest)")
            raise FaultError(f"injected crash_during_save@save={count} "
                             f"(checkpoint {label})")
