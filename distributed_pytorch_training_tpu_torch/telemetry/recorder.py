"""Recorder: the process-local typed event stream.

Event model (``SCHEMA_VERSION`` stamps every line; the first line of every
JSONL is a ``meta`` event carrying the run context):

=========  ==============================================================
kind       meaning / required fields
=========  ==============================================================
meta       stream header: schema, run_id, pid, argv hint
span       one timed host-side region: ``name``, ``t0`` (wall seconds at
           entry), ``dur_ms``. Canonical names: ``data_wait``,
           ``step_dispatch``, ``device_sync``, ``eval``, ``save_blocked``,
           ``restore`` — free-form names are legal, the canonical set is
           what ``telemetry summary`` buckets into the step-time split.
counter    monotonic count/total: ``name``, ``value`` (summed by summary)
gauge      instantaneous level: ``name``, ``value`` (last-wins)
anomaly    watchdog detection: ``name`` + detection detail
event      anything else worth a timestamped line (probe failures,
           restarts, preemptions)
exit       the flight recorder's cause record (also the flight file body)
=========  ==============================================================

Durability: every emit appends one JSON line; the file handle is flushed
per line and ``os.fsync``'d on a cadence (``fsync_every_s``) plus at
``flush()``/``close()`` — a crash loses at most the last cadence window of
OS-buffered lines, and the flight recorder's explicitly-fsync'd
``flight_*.json`` carries the ring's tail regardless.

This module imports neither torch nor anything from the package that does:
arming telemetry must never initialize a backend, and the CLI must read
streams on machines with no accelerator
stack at all. Process-0 gating is therefore the CALLER's job — train.py
gates on :func:`should_stream` (rank 0 always; other ranks only under the
``--telemetry-all-ranks`` / ``DPT_TELEMETRY_ALL_RANKS`` opt-in, so the
default run's disk cost is one stream) and names the file
:func:`stream_filename` (``telemetry_rank<R>.jsonl``).

Rank identity: a recorder knows WHICH stream it is. The fleet
orchestrator (resilience/fleet.py) stamps ``DPT_FLEET_GENERATION`` /
``DPT_FLEET_RANK`` into every child's env; outside a fleet the caller
passes the ``torch.distributed`` rank as the fallback (this module
stays stdlib-only, so it can only receive it). Every event carries
``gen``/``rank`` fields — that is the v2 schema change — so N streams
merge attributably (telemetry/aggregate.py) even when generations share
one appended file.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, Optional

from ..utils.locktrace import named_lock

# v2: every event (meta included) carries `gen`/`rank`. Readers
# accept v1 streams — a missing gen/rank reads as 0/0 (the aggregator's
# normalization), and `summarize` never keyed on the version.
SCHEMA_VERSION = 2

# The fleet-context env names (the orchestrator is the writer, this module
# and the flight recorder are the readers — one definition, re-exported by
# telemetry/flight.py for the orchestrator's import).
FLEET_GENERATION_ENV = "DPT_FLEET_GENERATION"
FLEET_RANK_ENV = "DPT_FLEET_RANK"

# Non-zero-rank streaming opt-in: rank 0 always streams; other ranks only
# when this env (or the --telemetry-all-ranks flag feeding it) says so —
# the default run writes exactly one telemetry_rank0.jsonl, unchanged.
ALL_RANKS_ENV = "DPT_TELEMETRY_ALL_RANKS"

# Canonical span names `telemetry summary` buckets into the step-time
# split. Free-form names are legal; these are the contract.
SPAN_NAMES = ("data_wait", "step_dispatch", "device_sync", "eval",
              "save_blocked", "restore")

# The serving phases (serving/): how long a request queued, the prefill
# and decode dispatch walls, and the shutdown drain. `telemetry summary`
# buckets these exactly like the training phases — a serving stream's
# latency story decomposes instead of lumping into "unaccounted".
# The continuous-batching path adds two host-side phases:
# `slot_wait` (popped from the queue -> admitted into a slot — the
# pool/page-pressure share of latency, distinct from queue_wait's
# load share) and `router_dispatch` (the multi-replica router's pick +
# submit wall, including health probes). The speculative path
# adds three more: `draft_decode` (draft prefill + propose-round
# dispatch), `spec_verify` (the K+1-window target forward), and
# `prefill_skip` (a prefix-resident admission that dispatched NO
# prefill — its near-zero wall IS the TTFT win, and its count is the
# zero-dispatch census the skip test pins).
SERVING_SPAN_NAMES = ("queue_wait", "prefill", "decode", "drain",
                      "slot_wait", "router_dispatch", "draft_decode",
                      "spec_verify", "prefill_skip")

# The elastic phases: mesh re-planning after a replica
# death, the checkpoint reshard (N -> M re-slice), the grow-side live
# reshard when preempted capacity returns (`elastic_grow`), and the
# Supervisor's segment-boundary capacity polls (`capacity_watch`).
# Bucketed by `telemetry summary` like every other canonical phase
# instead of lumping into "unaccounted". The `compile` span (the serving
# engine's per-program AOT instrument — with the persistent compile cache
# on it collapses to cache-load time, the restart-downtime win) is
# deliberately NOT in this accounting list: a lazy compile runs INSIDE
# the prefill/decode/step_dispatch span that triggered it, so summing it
# as its own phase would double-count the same wall time; it stays
# visible in the summary's spans table under its own name.
ELASTIC_SPAN_NAMES = ("elastic_replan", "elastic_reshard", "elastic_grow",
                      "capacity_watch")

# Registered-but-unaccounted span names: visible in the spans table, never
# summed into the step-time split (the `compile` double-count rationale
# above). Together the five tuples are THE span-name registry, shared
# with the JAX package: `telemetry summary` silently buckets unknown
# names into "unaccounted", so a typo'd span name would vanish from the
# split instead of failing loudly.
AUX_SPAN_NAMES = ("compile",)

# The control-plane phases: `control_apply` wraps one
# `control.apply_decision` — the sole sanctioned entry from policy to the
# Supervisor's re-plan surface — and `control_retune` wraps the
# Supervisor's segment-boundary config re-plan (the online tuner's
# apply). Like `compile`, these run INSIDE the segment wall they act on,
# so they are registered-but-unaccounted: visible in the spans table,
# never summed into the step-time split.
CONTROL_SPAN_NAMES = ("control_apply", "control_retune")

REGISTERED_SPAN_NAMES = (SPAN_NAMES + SERVING_SPAN_NAMES
                         + ELASTIC_SPAN_NAMES + AUX_SPAN_NAMES
                         + CONTROL_SPAN_NAMES)

# Event kind of one ControlDecision record (control/decisions.py): the
# policy layer's typed decisions ride the same stream as every other
# instrument — `telemetry summary` renders them, metrics_http counts
# them as `dpt_control_decisions_total{action}`. Defined here (not in
# control/) so the stdlib-only telemetry readers never import the policy
# layer.
CONTROL_DECISION_KIND = "control_decision"


# ---------------------------------------------------------------------------
# Rank identity: which stream is this process?
# ---------------------------------------------------------------------------


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def generation_identity() -> int:
    """The fleet launch generation (``DPT_FLEET_GENERATION``), 0 outside a
    fleet — gen 0 IS the un-orchestrated run's identity, not a sentinel."""
    return _env_int(FLEET_GENERATION_ENV, 0)


def rank_identity(process_index: Optional[int] = None) -> int:
    """The stream rank: the fleet env stamp wins (``DPT_FLEET_RANK``),
    else the caller-provided process rank (this module cannot import
    torch to ask), else 0."""
    env_rank = os.environ.get(FLEET_RANK_ENV)
    if env_rank is not None:
        try:
            return int(env_rank)
        except ValueError:
            pass
    return int(process_index) if process_index is not None else 0


def stream_filename(rank: int = 0) -> str:
    """``telemetry_rank<R>.jsonl`` — rank 0 keeps the historical name, so
    every existing reader/doc/test path stays valid."""
    return f"telemetry_rank{int(rank)}.jsonl"


def all_ranks_enabled(flag: bool = False) -> bool:
    """The non-zero-rank streaming opt-in: an explicit CLI flag OR a
    truthy ``DPT_TELEMETRY_ALL_RANKS`` (the fleet orchestrator's way to
    arm children it cannot pass flags to)."""
    if flag:
        return True
    raw = os.environ.get(ALL_RANKS_ENV, "").strip().lower()
    return raw not in ("", "0", "false", "no", "off")


def should_stream(rank: int, all_ranks: bool = False) -> bool:
    """Rank 0 always streams; other ranks only under the opt-in — the
    default run's disk cost (one JSONL) is unchanged by construction."""
    return rank == 0 or all_ranks_enabled(all_ranks)


class Recorder:
    """Append-only JSONL + bounded ring buffer of typed events.

    ``path=None`` keeps a ring-only recorder (tests; flight-only use).
    All emit paths are thread-safe: the checkpoint writer thread, the
    loader producer thread, and the deathwatch thread all emit into the
    same stream as the main loop.
    """

    def __init__(self, path: Optional[str] = None, ring_size: int = 512,
                 fsync_every_s: float = 2.0, run_id: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 gen: Optional[int] = None, rank: Optional[int] = None):
        self.path = Path(path) if path is not None else None
        self.ring: Deque[dict] = collections.deque(maxlen=max(1, ring_size))  # guarded-by: _lock
        self.run_id = run_id or f"run-{os.getpid()}-{int(time.time())}"
        # stream identity (v2): env stamps win, explicit args override —
        # stamped on EVERY event so merged/append-shared files stay
        # attributable line by line
        self.gen = int(gen) if gen is not None else generation_identity()
        self.rank = int(rank) if rank is not None else rank_identity()
        self._fsync_every_s = fsync_every_s
        self._last_fsync = time.monotonic()   # guarded-by: _lock
        self._lock = named_lock("Recorder._lock")
        self._fh = None                       # guarded-by: _lock
        # observers (telemetry/metrics_http.py): called with each event
        # AFTER it is recorded, outside the stream lock (an observer
        # taking its own lock must never be able to deadlock an emit).
        # Empty on every run without a live surface — one list check.
        self._observers: List[Callable[[dict], None]] = []  # guarded-by: _lock
        self.n_events = 0                     # guarded-by: _lock
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self.emit("meta", "stream", schema=SCHEMA_VERSION,
                  run_id=self.run_id, pid=os.getpid(),
                  **(meta or {}))

    # -- core ------------------------------------------------------------

    def emit(self, kind: str, name: str, **fields: Any) -> dict:
        """Append one event to the ring (always) and the JSONL (if open)."""
        ev = {"v": SCHEMA_VERSION, "ts": time.time(), "kind": kind,
              "name": name, "gen": self.gen, "rank": self.rank}
        ev.update(fields)
        with self._lock:
            self.ring.append(ev)
            self.n_events += 1
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(ev, sort_keys=True,
                                              default=str) + "\n")
                    self._fh.flush()
                    now = time.monotonic()
                    if now - self._last_fsync >= self._fsync_every_s:
                        os.fsync(self._fh.fileno())
                        self._last_fsync = now
                except (OSError, ValueError):
                    # a full/readonly disk (or a handle closed under us)
                    # must never take the training run down with it
                    pass
            observers = list(self._observers) if self._observers else None
        if observers:
            for obs in observers:
                try:
                    obs(ev)
                except Exception:  # noqa: BLE001 — a broken live surface
                    pass           # must never take the run down with it
        return ev

    # -- observers (the live /metrics surface) ----------------------------

    def add_observer(self, fn: Callable[[dict], None]) -> None:
        """Register a per-event callback (metrics_http's state feed).
        Observers run outside the stream lock and MUST NOT emit."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def remove_observer(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    # -- typed helpers ----------------------------------------------------

    def span_event(self, name: str, dur_s: float, **attrs: Any) -> dict:
        """A span whose duration the CALLER measured (the hot-loop form:
        one perf_counter pair at the call site, no context-manager
        overhead). ``t0`` is reconstructed as now - dur."""
        return self.emit("span", name, t0=time.time() - dur_s,
                         dur_ms=round(dur_s * 1e3, 4), **attrs)

    def span(self, name: str, **attrs: Any) -> "_Span":
        return _Span(self, name, attrs)

    def counter(self, name: str, value: float, **attrs: Any) -> dict:
        return self.emit("counter", name, value=value, **attrs)

    def gauge(self, name: str, value: float, **attrs: Any) -> dict:
        return self.emit("gauge", name, value=value, **attrs)

    def anomaly(self, name: str, **fields: Any) -> dict:
        return self.emit("anomaly", name, **fields)

    # -- lifecycle ---------------------------------------------------------

    def tail(self, n: int = 50) -> List[dict]:
        with self._lock:
            return list(self.ring)[-n:]

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._last_fsync = time.monotonic()
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except (OSError, ValueError):
                    pass
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    @property
    def directory(self) -> Optional[Path]:
        """Where flight files land (the JSONL's directory), or None for a
        ring-only recorder (flights then need an explicit directory)."""
        return self.path.parent if self.path is not None else None


class _Span:
    """Context manager measuring one host-side region with perf_counter
    (monotonic — an NTP step mid-span cannot corrupt the duration; the
    event's wall ``t0`` is for cross-log alignment only)."""

    def __init__(self, recorder: Recorder, name: str, attrs: Dict[str, Any]):
        self._rec = recorder
        self._name = name
        self._attrs = attrs
        self._t0_wall = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0_wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        dur = time.perf_counter() - self._t0
        self._rec.emit("span", self._name, t0=self._t0_wall,
                       dur_ms=round(dur * 1e3, 4),
                       **({"error": f"{exc_type.__name__}"}
                          if exc_type is not None else {}),
                       **self._attrs)


class NullSpan:
    """The unconfigured path's span: enters and exits for free."""

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = NullSpan()

# ---------------------------------------------------------------------------
# The process-global recorder: one stream per process, installed by the
# entry point (train.py / the serving CLI), consumed by every
# instrumented layer through the no-op-when-unconfigured helpers below.
# ---------------------------------------------------------------------------

_RECORDER: Optional[Recorder] = None


def configure(path: Optional[str] = None, **kwargs: Any) -> Recorder:
    """Install the process-global recorder (closing any previous one)."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.close()
    _RECORDER = Recorder(path, **kwargs)
    return _RECORDER


def reset() -> None:
    """Drop the global recorder (tests; end-of-run cleanup)."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.close()
    _RECORDER = None


def get() -> Optional[Recorder]:
    return _RECORDER


def is_configured() -> bool:
    return _RECORDER is not None


def emit(kind: str, name: str, **fields: Any) -> None:
    if _RECORDER is not None:
        _RECORDER.emit(kind, name, **fields)


def span(name: str, **attrs: Any):
    """Context-manager span on the global recorder; free when off."""
    if _RECORDER is None:
        return _NULL_SPAN
    return _RECORDER.span(name, **attrs)


def span_event(name: str, dur_s: float, **attrs: Any) -> None:
    if _RECORDER is not None:
        _RECORDER.span_event(name, dur_s, **attrs)


def counter(name: str, value: float, **attrs: Any) -> None:
    if _RECORDER is not None:
        _RECORDER.counter(name, value, **attrs)


def gauge(name: str, value: float, **attrs: Any) -> None:
    if _RECORDER is not None:
        _RECORDER.gauge(name, value, **attrs)
