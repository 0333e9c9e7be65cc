"""Preemption: SIGTERM becomes a graceful stop (the JAX package's
training/preemption.py).

The guard turns SIGTERM and SIGINT into a stop flag; the training loop
finishes the step in flight, writes a checkpoint and exits 0, and a
relaunch with ``--resume`` continues from it. The first signal also arms a
hard deadline: a process whose graceful path stalls exits 143 instead of
lingering with its device.

Under ``torchrun`` every rank gets the signal, but not necessarily at the
same step, and a rank that stops while the others enter the next
all-reduce hangs them all. :class:`RankAgreedStop` agrees on the flag: one
MAX reduction of one scalar over the ranks, which every rank reads at the
same step (the loops poll it every ``print_freq`` steps, well inside the
grace period).
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

from ..parallel.collectives import reduce_scalar, world_size
from ..utils.logging import log_main

_GRACE_ENV = "DPT_PREEMPT_GRACE_SECONDS"
_GRACE_DEFAULT = 600.0


def hard_exit(code: int) -> None:
    """The one abrupt process exit (``os._exit``): only for a process
    whose graceful stop did not complete within the grace period."""
    os._exit(code)


class PreemptionGuard:
    """SIGTERM/SIGINT handlers that request a graceful stop.

    Handlers chain to any previously installed one; ``should_stop`` is a
    plain flag. A second signal falls through to the previous handler
    (a second Ctrl-C still kills). The first signal arms a hard deadline
    (``DPT_PREEMPT_GRACE_SECONDS``, default 600): if the process has not
    called ``disarm()`` by then, it exits with status 143."""

    _installed: Optional["PreemptionGuard"] = None

    def __init__(self):
        self._stop = threading.Event()
        self._prev = {}
        self._deadline: Optional[threading.Timer] = None
        # test seam: replaced to observe the forced exit without dying
        self._force_exit = lambda: hard_exit(143)

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def request_stop(self) -> None:
        self._stop.set()

    def _handler(self, signum, frame):
        if self._stop.is_set():
            # second signal: the previous behaviour (a hard exit)
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signum, prev or signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        # never raise inside a signal handler: a malformed value must not
        # turn SIGTERM into a crash without a checkpoint
        try:
            grace = float(os.environ.get(_GRACE_ENV, _GRACE_DEFAULT))
        except (TypeError, ValueError):
            grace = _GRACE_DEFAULT
        log_main(f"Received signal {signum}: will checkpoint and stop at the "
                 f"next step boundary (hard exit in {grace:.0f}s if the "
                 "graceful path stalls)")
        self._stop.set()
        self._arm_deadline(grace)

    def _arm_deadline(self, grace: float) -> None:
        def expire():
            log_main(f"Graceful stop did not complete within {grace:.0f}s "
                     "of the signal; force-exiting (143)")
            self._force_exit()

        self._deadline = threading.Timer(grace, expire)
        self._deadline.daemon = True
        self._deadline.start()

    def disarm(self) -> None:
        """Cancel the hard-exit deadline: the graceful path completed."""
        if self._deadline is not None:
            self._deadline.cancel()
            self._deadline = None

    def reset(self) -> None:
        """Clear the stop flag and the deadline (a new run starts)."""
        self._stop.clear()
        self.disarm()

    @classmethod
    def install(cls, reset: bool = True) -> "PreemptionGuard":
        """Idempotent: repeated calls return the same guard, by default
        with a stale stop flag of an earlier run in this process
        cleared."""
        if cls._installed is not None:
            if reset:
                cls._installed.reset()
            return cls._installed
        guard = cls()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                guard._prev[sig] = signal.signal(sig, guard._handler)
            except (ValueError, OSError):
                # not the main thread: only request_stop() stops the run
                pass
        cls._installed = guard
        return guard

    @classmethod
    def uninstall(cls) -> None:
        """Put back the handlers the guard replaced and forget it: for an
        embedder that runs ``train.main`` in-process and must not keep a
        handler that turns its own SIGTERM into a stop flag."""
        guard, cls._installed = cls._installed, None
        if guard is None:
            return
        guard.disarm()
        for sig, prev in guard._prev.items():
            signal.signal(sig, prev)


class RankAgreedStop:
    """A guard's stop flag agreed over the ranks: ``should_stop`` is True
    on every rank once any rank's guard is set. On several ranks reading
    it is a collective, so every rank must read it at the same step; in
    one process it is the guard's flag."""

    def __init__(self, guard: PreemptionGuard):
        self.guard = guard

    @property
    def should_stop(self) -> bool:
        local = self.guard.should_stop
        if world_size() == 1:
            return local
        return reduce_scalar(float(local), "max") > 0
