"""Anomaly watchdog: detections fed off the same host-side stream.

Three detectors, each emitting a structured ``anomaly`` event into the
recorder (and, with ``abort=True``, raising :class:`AnomalyAbort` — which
under the restart Supervisor is a restartable failure like any other, so
"abort" means checkpoint-restore-replay, not data loss):

* **non-finite loss** — fed at print boundaries (the loop's only host
  fetch; the watchdog must not add device syncs);
* **step-time spike** — host wall per step vs a rolling median. Honest
  scope: with async dispatch the host observes device time only through
  donation backpressure once the pipeline fills, so the detector warms up
  (``min_samples``) before judging and compares against the rolling
  median, not the mean (compile steps would poison a mean forever);
* **loader stall** — data-wait exceeding both an absolute floor and a
  multiple of its own rolling median (the chaos ``loader_stall`` fault's
  signature).

Anomaly-triggered capture: with a ``capture_hook`` installed
(train.py wires it to ``StepProfiler.request_capture``), a step-time
spike or loader stall ARMS a short on-demand trace capture the moment it
is detected — the straggling behaviour is recorded while it is still
happening instead of being unreproducible after the fact. The hook fires
on detection regardless of the abort flag (and BEFORE an abort raise),
is contained (a failing hook never takes the run down), and arming is
refuse-not-clobber when the profiler is busy — so the hook has no
``--telemetry-abort``-like side effects on control flow.

The watchdog holds no device state and is stdlib-only. The detector knobs
read env overrides via :func:`kwargs_from_env` (``DPT_WATCHDOG_*``) so
an orchestrator can tune warm-up/floors on children it cannot pass
flags to (the fleet's capture story needs a short warm-up on short
runs).
"""

from __future__ import annotations

import collections
import math
import os
import statistics
from typing import Callable, Deque, Optional

from . import recorder as _recorder

# env-name -> (ctor kwarg, cast): the orchestrator-facing tuning surface
WATCHDOG_ENV_KNOBS = {
    "DPT_WATCHDOG_MIN_SAMPLES": ("min_samples", int),
    "DPT_WATCHDOG_SPIKE_FACTOR": ("spike_factor", float),
    "DPT_WATCHDOG_STALL_FACTOR": ("stall_factor", float),
    "DPT_WATCHDOG_STALL_MIN_S": ("stall_min_s", float),
    "DPT_WATCHDOG_STALL_ABS_S": ("stall_abs_s", float),
}


def kwargs_from_env() -> dict:
    """AnomalyWatchdog constructor overrides from ``DPT_WATCHDOG_*`` env
    (unset/unparseable names are simply absent — defaults hold)."""
    out = {}
    for env, (kwarg, cast) in WATCHDOG_ENV_KNOBS.items():
        raw = os.environ.get(env)
        if raw is None:
            continue
        try:
            out[kwarg] = cast(raw)
        except ValueError:
            pass
    return out


class AnomalyAbort(RuntimeError):
    """Raised by an ``abort=True`` watchdog on detection — under the
    Supervisor this is a restartable step failure (restore + replay)."""


class AnomalyWatchdog:
    """Rolling-median anomaly detection over per-step host timings.

    ``spike_factor``: a step slower than factor x median (after
    ``min_samples`` warm-up steps) is a ``step_time_spike``.
    ``stall_factor`` / ``stall_min_s``: a data wait above BOTH
    ``stall_min_s`` and factor x its median is a ``loader_stall``.
    ``stall_abs_s`` (default None = off): an UNCONDITIONAL absolute
    stall bound — a data wait above it is a ``loader_stall`` with no
    warm-up and no median (a stall on the FIRST post-resume step is
    otherwise invisible: the rolling median has nothing to compare
    against; the fleet's anomaly-capture story needs exactly that step).
    The caller owns the bound's sanity — None keeps the median-only
    detector bit-for-bit.
    ``abort``: raise :class:`AnomalyAbort` on detection (default: observe
    only). ``capture_hook(name, step)``: arm an on-demand trace capture
    on a timing anomaly (spike/stall — not the non-finite-loss detector,
    whose damage a device trace cannot show). Detections are also
    counted on the instance for tests/reports.
    """

    def __init__(self, spike_factor: float = 5.0, min_samples: int = 20,
                 stall_factor: float = 10.0, stall_min_s: float = 1.0,
                 window: int = 128, abort: bool = False,
                 capture_hook: Optional[Callable[[str, int],
                                                 object]] = None,
                 stall_abs_s: Optional[float] = None):
        if spike_factor <= 1.0 or stall_factor <= 1.0:
            raise ValueError("spike/stall factors must be > 1")
        if stall_abs_s is not None and stall_abs_s <= 0:
            raise ValueError("stall_abs_s must be > 0 (or None = off)")
        self.spike_factor = spike_factor
        self.min_samples = max(2, min_samples)
        self.stall_factor = stall_factor
        self.stall_min_s = stall_min_s
        self.stall_abs_s = stall_abs_s
        self.abort = abort
        self.capture_hook = capture_hook
        self._step_s: Deque[float] = collections.deque(maxlen=window)
        self._wait_s: Deque[float] = collections.deque(maxlen=window)
        self.anomalies: list = []

    # -- detections --------------------------------------------------------

    # the timing anomalies a device trace can explain; non_finite_loss is
    # a numerics problem, not a schedule one — no capture armed for it
    _CAPTURE_ANOMALIES = ("step_time_spike", "loader_stall")

    def _fire(self, name: str, **fields) -> None:
        self.anomalies.append((name, fields))
        _recorder.emit("anomaly", name, **fields)
        if self.capture_hook is not None and name in self._CAPTURE_ANOMALIES:
            # BEFORE a potential abort-raise: the capture of the
            # anomalous behaviour is the point, and it must arm whether
            # or not the abort hook then turns this into a restart
            try:
                self.capture_hook(name, fields.get("step", -1))
            except Exception:  # noqa: BLE001 — observability never takes
                pass           # the run down
        if self.abort:
            raise AnomalyAbort(
                f"anomaly watchdog: {name} "
                + " ".join(f"{k}={v}" for k, v in fields.items()))

    def observe_step(self, step: int, step_s: float,
                     data_wait_s: Optional[float] = None) -> None:
        """Feed one step's host wall time (+ its data wait). Samples are
        recorded AFTER the check so a spike never judges itself normal.

        Attribution: the stall detector runs FIRST and the spike detector
        judges the BUSY time (step minus data wait) — a step made slow by
        its loader is a loader_stall, never additionally a
        step_time_spike (the stall's shadow would otherwise fire first
        under abort=True and misname the cause)."""
        busy_s = max(0.0, step_s - (data_wait_s or 0.0))
        if data_wait_s is not None and self.stall_abs_s is not None \
                and data_wait_s > self.stall_abs_s:
            # the unconditional absolute bound: no warm-up, no median —
            # samples still recorded first so a replayed step re-enters
            # a warmed-up detector (the relative path's convention)
            self._step_s.append(busy_s)
            self._wait_s.append(data_wait_s)
            self._fire("loader_stall", step=step,
                       data_wait_s=round(data_wait_s, 4),
                       absolute_bound_s=self.stall_abs_s)
            return
        if data_wait_s is not None and len(self._wait_s) >= self.min_samples:
            med_w = statistics.median(self._wait_s)
            if data_wait_s > self.stall_min_s and \
                    data_wait_s > self.stall_factor * max(med_w, 1e-9):
                # record the samples before a potential abort-raise so a
                # replayed step re-enters a warmed-up detector
                self._step_s.append(busy_s)
                self._wait_s.append(data_wait_s)
                self._fire("loader_stall", step=step,
                           data_wait_s=round(data_wait_s, 4),
                           median_wait_s=round(med_w, 6))
                return
        if len(self._step_s) >= self.min_samples:
            med = statistics.median(self._step_s)
            if med > 0 and busy_s > self.spike_factor * med:
                self._step_s.append(busy_s)
                if data_wait_s is not None:
                    self._wait_s.append(data_wait_s)
                self._fire("step_time_spike", step=step,
                           step_s=round(busy_s, 4),
                           median_s=round(med, 4),
                           factor=round(busy_s / med, 2))
                return
        self._step_s.append(busy_s)
        if data_wait_s is not None:
            self._wait_s.append(data_wait_s)

    def observe_loss(self, step: int, loss: float) -> None:
        """Feed a host-fetched loss (print boundaries — never a new sync)."""
        if not math.isfinite(loss):
            self._fire("non_finite_loss", step=step, loss=str(loss))
