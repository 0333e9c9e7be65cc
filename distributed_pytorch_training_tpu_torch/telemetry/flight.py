"""Flight recorder: the crash-surviving postmortem artifact.

On any abnormal exit the ring buffer's last N events + the exit cause are
written to ``flight_<ts>_<seq>.json`` in the telemetry directory —
explicitly fsync'd, so it survives the process dying immediately after.
Every rc=70 / rc!=0 path in the stack flushes one:

* ``resilience/supervisor.py`` — every restart (cause = the caught step/
  save failure, so an injected ``crash@step=3`` reads back verbatim),
  torn-checkpoint skips, the preemption (SIGTERM) drain, and retry
  exhaustion;
* ``train.py`` — unhandled exceptions, via the explicit ``except
  BaseException`` clause in ``main()`` (NOT :func:`install_excepthook`:
  the flush must run BEFORE ``finally: telemetry.reset()`` closes the
  recorder, and ``sys.excepthook`` fires after the function's finally
  blocks — the hook would find no recorder and write an empty flight).
  ``install_excepthook`` exists for entry points with no such wrapper
  (one-off scripts driving the library directly); never combine both in
  one process or a crash writes two flights.

A flight flush is best-effort by contract: it runs on paths that are
already dying, so it must never raise, never import torch, and never block
unboundedly (one open/write/fsync/rename).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

from . import recorder as _recorder

_SEQ = itertools.count()

# Fleet context: the cross-process orchestrator
# (resilience/fleet.py) stamps every child it launches with its launch
# generation and rank. A postmortem that cannot say WHICH launch of a
# relaunch sequence died is half a postmortem — the context rides in the
# flight's cause (and as structured fields), read straight from the env
# so no plumbing crosses the library. The names live in recorder.py (the
# recorder stamps the same identity on every stream event); re-exported
# here for the orchestrator's import.
FLEET_GENERATION_ENV = _recorder.FLEET_GENERATION_ENV
FLEET_RANK_ENV = _recorder.FLEET_RANK_ENV


def _fleet_context() -> dict:
    ctx = {}
    gen = os.environ.get(FLEET_GENERATION_ENV)
    rank = os.environ.get(FLEET_RANK_ENV)
    if gen is not None:
        ctx["fleet_generation"] = gen
    if rank is not None:
        ctx["fleet_rank"] = rank
    return ctx


def flush_flight(cause: str, detail: str = "", rc: Optional[int] = None,
                 directory: Optional[str] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Optional[Path]:
    """Write ``flight_<ms>_<seq>.json`` with the exit cause + the ring's
    tail. Returns the path, or None when there is nowhere to write (no
    recorder configured and no explicit ``directory``). Never raises."""
    try:
        rec = _recorder.get()
        out_dir = Path(directory) if directory is not None else (
            rec.directory if rec is not None else None)
        if out_dir is None:
            return None
        fleet = _fleet_context()
        if fleet:
            # a fleet-launched child names its launch generation + rank in
            # the cause itself (the first thing anyone reads), so a
            # relaunch sequence's postmortems are attributable at a glance
            cause = (f"{cause} [fleet gen="
                     f"{fleet.get('fleet_generation', '?')} rank="
                     f"{fleet.get('fleet_rank', '?')}]")
        events = rec.tail(rec.ring.maxlen) if rec is not None else []
        body = {
            "schema": _recorder.SCHEMA_VERSION,
            "kind": "flight",
            "cause": cause,
            "detail": detail,
            "rc": rc,
            "ts": time.time(),
            "pid": os.getpid(),
            "run_id": rec.run_id if rec is not None else None,
            "n_events": len(events),
            "events": events,
            **fleet,
        }
        if extra:
            body.update(extra)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / (f"flight_{int(time.time() * 1000)}_"
                          f"{next(_SEQ)}.json")
        tmp = path.with_suffix(".json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(body, f, sort_keys=True, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: never a half-written flight
        if rec is not None:
            # the exit record also lands in the JSONL stream (tail loss
            # there is exactly what the flight file compensates for)
            rec.emit("exit", "flight", cause=cause, detail=detail, rc=rc,
                     flight_path=str(path))
            rec.flush()
        return path
    except Exception:  # noqa: BLE001 — a dying process owes no cleanup here
        return None


def install_excepthook() -> None:
    """Chain a flight flush into ``sys.excepthook``: an unhandled exception
    (train.py's crash path) leaves a postmortem before the traceback
    prints. Idempotent; SystemExit/KeyboardInterrupt never reach the hook
    (Python's contract), so clean exits stay flight-free."""
    prev = sys.excepthook
    if getattr(prev, "_telemetry_flight_hook", False):
        return

    def hook(exc_type, exc, tb):
        flush_flight(cause=f"{exc_type.__name__}: {exc}",
                     detail="unhandled exception", rc=1)
        prev(exc_type, exc, tb)

    hook._telemetry_flight_hook = True
    sys.excepthook = hook
