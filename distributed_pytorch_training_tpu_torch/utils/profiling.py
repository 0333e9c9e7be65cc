"""Profiling — ``torch.profiler`` trace capture (the JAX package's
``utils/profiling.py`` on ``torch.profiler`` in place of ``jax.profiler``).

A step-windowed trace: the card's kernels, copies and memsets (CUPTI) and
the host's operators, written as a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``) that ``experiments/trace_analysis.py``
reads. The collective time of a step is read off that timeline.

:meth:`StepProfiler.request_capture` arms a short window at RUNTIME (the
``POST /profile`` endpoint and the anomaly watchdog's capture hook both
land here); each armed capture lands in its own subdirectory and fires an
``on_capture`` callback (telemetry/device.py ingests the trace into a typed
``device_profile`` event). Every profiler session of the port routes
through this module's session guard: CUPTI allows one session a process,
and a second ``torch.profiler.profile`` started while one is open raises
inside torch; here it is refused-and-logged with a ``profiler_busy``
counter.

Synchronisation: a window on a CUDA device opens and closes with
``torch.cuda.synchronize(device)`` (PyTorch returns before the card has
run what it was given, so a window closed without one would lose its last
step's kernels, and one opened without one would hold the step before
it). These are the only syncs profiling adds; a step outside a window
gets none.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from .locktrace import named_lock
from .logging import log_main

# ---------------------------------------------------------------------------
# The process-wide session guard. CUPTI holds ONE profiling session per
# process; opening a second raises from inside torch. Every start/stop in
# this package acquires here first, so a conflict is a refused capture + a
# counter, never a crash mid-training-run.
# ---------------------------------------------------------------------------

_SESSION_LOCK = named_lock("profiling._SESSION_LOCK")
# read without the lock by session_owner(): a racy diagnostic HINT (the
# busy-counter label); every decision-making read sits under the lock
_SESSION_OWNER: Optional[str] = None


def _acquire_session(owner: str) -> bool:
    global _SESSION_OWNER
    with _SESSION_LOCK:
        if _SESSION_OWNER is not None:
            return False
        _SESSION_OWNER = owner
        return True


def _release_session() -> None:
    global _SESSION_OWNER
    with _SESSION_LOCK:
        _SESSION_OWNER = None


def session_owner() -> Optional[str]:
    """Who holds the process's profiler session (None = free)."""
    return _SESSION_OWNER


def _note_busy(owner: str, wanted: str) -> None:
    """A refused capture is observability, not an error: one counter on the
    stream (no-op when telemetry is off) + one log line."""
    from .. import telemetry

    telemetry.counter("profiler_busy", 1, holder=owner, wanted=wanted)
    log_main(f"Profiler: capture {wanted!r} refused — session held by "
             f"{owner!r} (profiler_busy)")


def _process_index() -> int:
    """This process's rank (0 outside ``torch.distributed``)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _on_cuda(device: Optional[torch.device]) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _start(device: Optional[torch.device]) -> torch.profiler.profile:
    """Open a profiler session: host operators always, the card's
    activity (CUPTI) when ``device`` is CUDA."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _on_cuda(device):
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, device: Optional[torch.device],
          trace_dir: str) -> Path:
    """Close the session (after the card has finished the window's work)
    and write its Chrome trace into ``trace_dir``."""
    if _on_cuda(device):
        torch.cuda.synchronize(device)
    prof.stop()
    path = Path(trace_dir) / (f"{socket.gethostname()}_{os.getpid()}."
                              f"{int(time.time() * 1e3)}.pt.trace.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace_session(log_dir: str, owner: str = "trace_session",
                  device: Optional[torch.device] = None):
    """The sanctioned raw-session form (experiments/trace_analysis.py's
    ``capture_step_trace`` rides it): start a torch.profiler trace into
    ``log_dir`` under the process-wide guard, yield True; if another
    session is open, yield False WITHOUT touching the profiler (the caller
    decides whether a missing trace is fatal). Always balanced: the stop
    (and the trace's export) runs on every exit path."""
    if not _acquire_session(owner):
        _note_busy(_SESSION_OWNER or "?", owner)
        yield False
        return
    try:
        prof = _start(device)
    except BaseException:
        _release_session()
        raise
    try:
        yield True
    finally:
        try:
            _stop(prof, device, log_dir)
        finally:
            _release_session()


class StepProfiler:
    """Step-windowed + on-demand torch.profiler capture.

    Three ways a trace starts, all sharing one session guard:

    * the **static window** (``start``/``stop`` constructor args — the
      ``--profile-dir``/``--profile-steps`` CLI contract): opens when
      entering step ``start`` and closes entering step ``stop``, once per
      run, into ``log_dir`` itself;
    * an **armed capture** (:meth:`request_capture`, thread-safe — the
      ``POST /profile`` handler and the watchdog's anomaly hook call it
      from other threads/contexts): the next ``__call__`` opens a window
      of K steps into ``log_dir/capture_<pid>_<n>/``;
    * an **immediate capture** (:meth:`capture`, a context manager for
      mid-run host code): opens right now, closes at block exit.

    Use as the Trainer's ``step_hook``: rank 0 only (one trace per job).
    ``device`` is the trainer's device: a CUDA device adds the card's
    activity to the host's and synchronizes it at each window's edges.
    When a window closes, ``on_capture(trace_dir, info)`` fires with the
    window's step range / reason / trigger — exceptions there are
    contained (a broken ingestor must never take the training run down).
    """

    def __init__(self, log_dir: str, start: Optional[int] = None,
                 stop: Optional[int] = None,
                 on_capture: Optional[Callable[[str, Dict[str, Any]],
                                               None]] = None,
                 max_captures: int = 16,
                 device: Optional[torch.device] = None):
        if (start is None) != (stop is None):
            raise ValueError("profile window needs both start and stop "
                             f"(or neither), got {start},{stop}")
        if start is not None and stop <= start:
            raise ValueError(f"profile window needs stop > start, got "
                             f"{start},{stop}")
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self.on_capture = on_capture
        self.max_captures = int(max_captures)
        self.device = device
        # _prof/_done/_seen/_window are STEP-THREAD state by design:
        # only __call__/close (the trainer's hook thread) touch them, so
        # they need no lock — cross-thread traffic comes in through
        # _pending only
        self._prof: Optional[torch.profiler.profile] = None  # static window
        self._done = False            # the static window fired already
        self._seen = 0
        self._lock = named_lock("StepProfiler._lock")
        self._pending: Optional[Dict[str, Any]] = None   # guarded-by: _lock
        self._window: Optional[Dict[str, Any]] = None  # armed, in flight
        self._n_captures = 0          # guarded-by: _lock
        self.busy_refused = 0         # guarded-by: _lock

    @property
    def _active(self) -> bool:
        """The static window's session is open."""
        return self._prof is not None

    # -- on-demand arming (thread-safe: HTTP/watchdog callers) -----------

    def request_capture(self, steps: int, reason: str = "http",
                        trigger_step: Optional[int] = None) -> bool:
        """Arm a capture of the next ``steps`` steps. Returns False —
        with a ``profiler_busy`` counter — when a window is already armed
        or in flight, the static window is open, another component holds
        the profiler session, or the per-run capture budget is spent (the
        ``/profile`` 409 contract: refuse, never clobber)."""
        try:
            steps = int(steps)
        except (TypeError, ValueError):
            return False
        if steps < 1:
            return False
        if _process_index() != 0:
            # other ranks never open windows (__call__ returns before the
            # armed logic) — accepting the arm would wedge this rank's
            # profiler on a pending that can never fire
            return False
        with self._lock:
            if (self._pending is not None or self._window is not None
                    or self._active or session_owner() is not None
                    or self._n_captures >= self.max_captures):
                self.busy_refused += 1
                holder = session_owner() or (
                    "capture budget spent"
                    if self._n_captures >= self.max_captures
                    else "StepProfiler")
                _note_busy(holder, reason)
                return False
            self._pending = {"steps": steps, "reason": reason,
                             "trigger_step": trigger_step}
            return True

    def _capture_dir(self) -> str:   # lock-held: _lock
        # pid-qualified: processes of successive launches share one
        # profiles directory, and trace parsing globs recursively — two
        # captures must never mix sessions under one subdir
        d = Path(self.log_dir) / f"capture_{os.getpid()}_{self._n_captures:03d}"
        self._n_captures += 1
        return str(d)

    def _fire_on_capture(self, trace_dir: str, info: Dict[str, Any]) -> None:
        if self.on_capture is None:
            return
        try:
            self.on_capture(trace_dir, info)
        except Exception as e:  # noqa: BLE001 — ingestion is observability
            log_main(f"Profiler: on_capture ingestion failed ({e}) — "
                     "trace kept on disk, run continues")

    def _close_armed_window(self, elapsed: int) -> None:
        """Stop the armed window's session and fire ingestion.
        ``elapsed`` is the number of step-hook calls the window actually
        spanned (from the ``_seen`` counter) — the honest step count
        even when the run ended before the requested K, and even when
        the epoch-local step labels reset across an epoch boundary.
        Caller holds no lock; only the step thread opens/closes
        windows."""
        window = self._window
        self._window = None
        if window is None:
            return
        try:
            _stop(window["prof"], self.device, window["dir"])
        finally:
            _release_session()
        elapsed = max(0, int(elapsed))
        stop_step = window["start_step"] + elapsed
        info = {"start_step": window["start_step"], "stop_step": stop_step,
                "steps": elapsed,
                "reason": window["reason"],
                "trigger_step": window["trigger_step"]}
        log_main(f"Profiler: on-demand trace (steps "
                 f"{info['start_step']}-{stop_step}, {info['reason']}) "
                 f"written to {window['dir']}")
        self._fire_on_capture(window["dir"], info)

    # -- immediate mid-run capture ---------------------------------------

    @contextlib.contextmanager
    def capture(self, reason: str = "capture"):
        """Immediate capture: yields the trace directory, or None when a
        window/session is already open (refused-and-logged, the block
        still runs — a busy profiler must never change control flow)."""
        with self._lock:
            busy = (self._pending is not None or self._window is not None
                    or self._active
                    or self._n_captures >= self.max_captures)
        if busy or not _acquire_session(f"StepProfiler.capture:{reason}"):
            with self._lock:
                self.busy_refused += 1
            _note_busy(session_owner() or "StepProfiler", reason)
            yield None
            return
        with self._lock:
            # allocate the capture-budget slot only once the session is
            # actually ours — refusals must not burn budget
            trace_dir = self._capture_dir()
        try:
            prof = _start(self.device)
        except BaseException:
            _release_session()
            raise
        try:
            yield trace_dir
        finally:
            try:
                _stop(prof, self.device, trace_dir)
            finally:
                _release_session()
            self._fire_on_capture(trace_dir,
                                  {"start_step": None, "stop_step": None,
                                   "steps": None, "reason": reason,
                                   "trigger_step": None})

    # -- the step hook ----------------------------------------------------

    def __call__(self, step_in_epoch: int) -> None:
        step = self._seen
        self._seen += 1
        if _process_index() != 0:
            return
        # armed window close (K calls after it opened)
        if self._window is not None and \
                step >= self._window["start_seen"] + self._window["steps"]:
            self._close_armed_window(step - self._window["start_seen"])
        # armed window open (a pending request from /profile or the
        # watchdog): one capture at a time, never while the static
        # window's session is open
        if self._window is None and not self._active:
            with self._lock:
                pending, self._pending = self._pending, None
            if pending is not None:
                # under the lock: _capture_dir draws from the shared
                # capture budget, and a concurrent capture() drawing at
                # the same instant would mint the same directory name
                with self._lock:
                    trace_dir = self._capture_dir()
                if _acquire_session("StepProfiler.armed"):
                    try:
                        prof = _start(self.device)
                    except BaseException:
                        _release_session()
                        raise
                    self._window = {"dir": trace_dir, "prof": prof,
                                    "steps": pending["steps"],
                                    "start_seen": step,
                                    "start_step": int(step_in_epoch),
                                    "reason": pending["reason"],
                                    "trigger_step": pending["trigger_step"]}
                else:   # raced by another holder between arm and open
                    with self._lock:
                        self.busy_refused += 1
                    _note_busy(session_owner() or "?", pending["reason"])
        # the static --profile-steps window (_seen indices, one window per
        # run, replay-safe via _active/_done)
        if self._done or self.start is None:
            return
        if not self._active and self.start <= step < self.stop:
            if self._window is not None:
                return   # an armed capture is mid-flight; retry next step
            if not _acquire_session("StepProfiler.window"):
                _note_busy(session_owner() or "?", "window")
                return
            try:
                self._prof = _start(self.device)
            except BaseException:
                _release_session()
                raise
        elif self._active and step >= self.stop:
            self._close_static()
            log_main(f"Profiler trace (steps {self.start}-{self.stop}) "
                     f"written to {self.log_dir}")
            self._fire_on_capture(
                self.log_dir, {"start_step": self.start,
                               "stop_step": self.stop,
                               "steps": self.stop - self.start,
                               "reason": "window", "trigger_step": None})

    def _close_static(self) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        try:
            _stop(prof, self.device, self.log_dir)
        finally:
            _release_session()

    def close(self) -> None:
        """Stop any open trace if the run ended inside a window."""
        if self._window is not None:
            # honest truncation: count the hook calls actually spanned,
            # not the K the request asked for
            self._close_armed_window(self._seen
                                     - self._window["start_seen"])
        if self._active:
            self._close_static()
            log_main(f"Profiler trace written to {self.log_dir}")
            self._fire_on_capture(
                self.log_dir, {"start_step": self.start,
                               "stop_step": self._seen,
                               "steps": max(0, self._seen
                                            - (self.start or 0)),
                               "reason": "window", "trigger_step": None})

    # Context-manager protocol: an aborted profiled run (exception mid-
    # epoch) must not leave the profiler session open — a leaked session
    # makes every later capture in the process fail and drops the partial
    # trace on the floor. `with StepProfiler(...) as p:` closes on ANY
    # exit path.
    def __enter__(self) -> "StepProfiler":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()
