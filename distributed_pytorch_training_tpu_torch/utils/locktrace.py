"""Runtime lock tracing (a copy of the JAX package's, without its
``cross_check`` against the JAX package's static concurrency rules).

A static pass reads lexical ``with`` nesting — it cannot see an
acquisition reached through a method call in another class. This module
closes that gap at TEST time: every lock the telemetry plane constructs
goes through
:func:`named_lock` / :func:`named_condition`, and under ``DPT_LOCKCHECK=1``
those return instrumented locks that record

* the per-thread nested acquisition order (``(outer, inner)`` edges,
  same ``ClassName.attr`` identities the static graph uses), and
* hold-while-blocking events (a probed blocking call — ``time.sleep``,
  ``socket.create_connection`` — entered while the thread holds any
  traced lock).

**Zero cost when off**: with ``DPT_LOCKCHECK`` unset, ``named_lock``
returns a plain ``threading.Lock`` and ``named_condition`` a plain
``threading.Condition`` — no wrapper object, no recording, no threads —
so telemetry streams are bit-identical either way. This module is
stdlib-only.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


def enabled() -> bool:
    return os.environ.get("DPT_LOCKCHECK", "") == "1"


class LockTrace:
    """The global recorder: per-thread held stacks, acquisition-order
    edges, hold-while-blocking events. One instance (module-level
    ``_TRACE``); its own bookkeeping lock is never exposed."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._held: Dict[int, List[str]] = {}
        self.acquisitions: List[Tuple[str, ...]] = []
        self.edges: Dict[Tuple[str, str], int] = {}
        self.blocking_events: List[Tuple[str, Tuple[str, ...]]] = []

    def reset(self) -> None:
        with self._mu:
            self._held.clear()
            self.acquisitions.clear()
            self.edges.clear()
            self.blocking_events.clear()

    def note_acquire(self, name: str) -> None:
        tid = threading.get_ident()
        with self._mu:
            stack = self._held.setdefault(tid, [])
            for outer in stack:
                if outer != name:
                    key = (outer, name)
                    self.edges[key] = self.edges.get(key, 0) + 1
            stack.append(name)
            self.acquisitions.append(tuple(stack))

    def note_release(self, name: str) -> None:
        tid = threading.get_ident()
        with self._mu:
            stack = self._held.get(tid, [])
            # remove the innermost occurrence (re-entrant RLocks release
            # in LIFO order; a plain Lock has exactly one)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    break
            if not stack:
                self._held.pop(tid, None)

    def held_by_current_thread(self) -> Tuple[str, ...]:
        with self._mu:
            return tuple(self._held.get(threading.get_ident(), ()))

    def note_blocking(self, desc: str) -> None:
        """Record `desc` as a blocking operation IF the calling thread
        holds any traced lock (otherwise it is uninteresting)."""
        held = self.held_by_current_thread()
        if held:
            with self._mu:
                self.blocking_events.append((desc, held))

    def order_edges(self) -> Set[Tuple[str, str]]:
        with self._mu:
            return set(self.edges)


_TRACE = LockTrace()


def trace() -> LockTrace:
    """The process-wide trace (meaningful only under DPT_LOCKCHECK=1)."""
    return _TRACE


class TracedLock:
    """A named, recording stand-in for ``threading.Lock``. Duck-typed
    (not a subclass — stdlib locks are C objects): acquire / release /
    locked / context manager, plus the private ``_release_save`` trio
    ``threading.Condition`` falls back to for non-stdlib locks, so
    ``named_condition`` can wrap one."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str,
                 inner: Optional[threading.Lock] = None) -> None:
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _TRACE.note_acquire(self.name)
        return got

    def release(self) -> None:
        _TRACE.note_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TracedLock({self.name!r}, locked={self.locked()})"


def named_lock(name: str) -> "threading.Lock | TracedLock":
    """A lock whose acquisitions are traced under DPT_LOCKCHECK=1, and a
    plain ``threading.Lock`` (zero overhead, no wrapper) otherwise.
    ``name`` must match the static graph identity — ``ClassName.attr``
    for instance locks, ``module._NAME`` for module-level ones."""
    if enabled():
        return TracedLock(name)
    return threading.Lock()


def named_condition(name: str) -> threading.Condition:
    """A Condition over a traced lock under DPT_LOCKCHECK=1 (CPython's
    Condition duck-types non-stdlib locks through acquire/release), else
    a plain ``threading.Condition``. ``wait()`` releases the lock — the
    trace sees that as release + re-acquire, exactly the runtime truth."""
    if enabled():
        return threading.Condition(TracedLock(name))  # type: ignore[arg-type]
    return threading.Condition()


# ---------------------------------------------------------------------------
# Blocking-call probes (hold-while-blocking detection)
# ---------------------------------------------------------------------------

_PROBED: Dict[str, Tuple[object, str, Callable]] = {}


def install_probes() -> None:
    """Patch a small set of blocking entry points (``time.sleep``,
    ``socket.create_connection``) to record a hold-while-blocking event
    when called with any traced lock held. No-op unless DPT_LOCKCHECK=1;
    idempotent; undone by :func:`uninstall_probes`. Test-harness wiring
    — never called on import."""
    if not enabled() or _PROBED:
        return

    def wrap(owner: object, attr: str, desc: str) -> None:
        orig = getattr(owner, attr)

        def probed(*args, **kwargs):
            _TRACE.note_blocking(desc)
            return orig(*args, **kwargs)

        _PROBED[desc] = (owner, attr, orig)
        setattr(owner, attr, probed)

    wrap(time, "sleep", "time.sleep")
    wrap(socket, "create_connection", "socket.create_connection")


def uninstall_probes() -> None:
    for owner, attr, orig in _PROBED.values():
        setattr(owner, attr, orig)
    _PROBED.clear()
