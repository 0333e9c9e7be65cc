"""Multi-replica request router: offered load -> N serving replicas (the
JAX package's serving/router.py; standard library and numpy only).

One continuous-batching replica saturates at its slot pool; the fleet
answer is N REPLICAS of the same engine behind one stdlib router:

* **Replica handles** hide where the engine lives. `InProcessReplica`
  wraps a `SlotEngine` + `ContinuousScheduler` on a worker thread (tests,
  single-process fleets); `HttpReplica` fronts a ``serving serve``
  process over its ``POST /generate`` endpoint, with liveness read from
  the replica's OWN ``/healthz`` step-fence and load from its
  ``/metrics`` queue-depth gauge (telemetry/metrics_http.py) — the
  router consumes the observability surface the fleet already exports,
  it does not invent a private protocol.
* **Dispatch** picks the healthy replica with the smallest queue depth
  (ties: round-robin order), under a ``router_dispatch`` telemetry span
  — queue-depth skew across replicas is readable straight off the
  span's attrs.
* **Failure = resubmit**: a `RouterRequest` that dies with its replica
  (the injected replica death) is resubmitted to the surviving replicas
  — every request completes while at least one replica lives, and the
  resubmission count rides the result. Sampling determinism makes the
  retry invisible: the same request seed emits the same tokens on ANY
  replica (serving/continuous.py).

The JAX package's `resilience.fleet.ServingFleet` supervises the replica
PROCESSES (relaunch-on-death, SIGTERM drain, one federated /metrics
page); the port has no fleet yet, and this module only routes.
"""

from __future__ import annotations

import http.client
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import telemetry
from ..utils.locktrace import named_lock
from .batching import Request, RequestQueue, Result

_GAUGE_RE = re.compile(
    r'dpt_gauge\{name="serving_queue_depth"[^}]*\}\s+([0-9.eE+-]+)')


class ReplicaDead(RuntimeError):
    """A replica failed a request (process death, scheduler kill, refused
    connection) — the router's cue to resubmit elsewhere."""


class InProcessReplica:
    """One continuous-batching engine + scheduler on a worker thread.

    The unit the router tests compose: `kill` is the chaos hook (the
    scheduler fails everything in flight with `ReplicaDead`, the router
    resubmits), `stop` is the drain path."""

    def __init__(self, name: str, engine, start: bool = True,
                 scheduler_cls=None):
        from .continuous import ContinuousScheduler

        if scheduler_cls is None:
            # a SpeculativeEngine under the plain scheduler would decode
            # token-at-a-time and never touch the draft — auto-pair the
            # engine with the scheduler that drives its verify loop
            from .speculative import SpeculativeEngine, SpeculativeScheduler
            scheduler_cls = (SpeculativeScheduler
                             if isinstance(engine, SpeculativeEngine)
                             else ContinuousScheduler)
        self.name = name
        self.engine = engine
        self.queue = RequestQueue(engine.config.buckets)
        self.scheduler = scheduler_cls(engine, self.queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self.scheduler.run, args=(self._stop,),
            name=f"replica-{name}", daemon=True)
        if start:
            self._thread.start()

    def submit(self, tokens: np.ndarray, **kw) -> Request:
        if not self.healthy():
            raise ReplicaDead(f"replica {self.name} is down")
        try:
            return self.queue.submit(tokens, **kw)
        except RuntimeError as e:  # closed (draining/dead) queue
            raise ReplicaDead(f"replica {self.name}: {e}") from e

    def healthy(self) -> bool:
        return self._thread.is_alive() and not self.scheduler.killed

    def queue_depth(self) -> int:
        # racy snapshot of another thread's collections, by design: the
        # router wants a cheap load estimate, not a fenced truth
        return (len(self.queue) + len(self.scheduler.pending)
                + len(self.scheduler.running))

    def kill(self) -> List[Request]:
        """Inject a replica death: fail everything in flight, stop the
        worker. Returns the failed requests (the router resubmits its
        own; direct submitters see `ReplicaDead`)."""
        failed = self.scheduler.kill(ReplicaDead(
            f"replica {self.name} died"))
        self._stop.set()
        self._thread.join(timeout=30.0)
        return failed

    def stop(self) -> None:
        """Drain and stop: accepted work completes, then the worker
        exits (the SIGTERM contract, in-process form)."""
        self._stop.set()
        self._thread.join(timeout=600.0)


class HttpReplica:
    """A ``serving serve`` process, fronted over stdlib HTTP.

    ``port`` is the /generate endpoint; ``metrics_port`` (when given) is
    the SAME replica's /healthz + /metrics surface — liveness is the
    step-fence verdict, load is the ``serving_queue_depth`` gauge. With
    no metrics port, health degrades to 'the last request worked'."""

    def __init__(self, name: str, port: int,
                 metrics_port: Optional[int] = None,
                 host: str = "127.0.0.1", timeout_s: float = 600.0):
        self.name = name
        self.host = host
        self.port = int(port)
        self.metrics_port = metrics_port
        self.timeout_s = float(timeout_s)
        # deliberately unguarded: a monotonic-ish health HINT written by
        # whichever request finished last — a stale read only delays the
        # router's next probe, it cannot corrupt anything
        self._last_ok = True

    def _url(self, path: str, port: int) -> str:
        return f"http://{self.host}:{port}{path}"

    def submit(self, tokens: np.ndarray, **kw) -> "_HttpPending":
        body = {"tokens": np.asarray(tokens, np.int32).tolist(), **{
            k: v for k, v in kw.items() if v is not None}}
        return _HttpPending(self, body)

    def healthy(self) -> bool:
        if self.metrics_port:
            try:
                with urllib.request.urlopen(
                        self._url("/healthz", self.metrics_port),
                        timeout=2.0) as resp:
                    return resp.status == 200
            except (OSError, urllib.error.URLError):
                return False
        return self._last_ok

    def queue_depth(self) -> int:
        if not self.metrics_port:
            return 0
        from ..telemetry.metrics_http import scrape_metrics

        page = scrape_metrics(self.metrics_port) or ""
        m = _GAUGE_RE.search(page)
        return int(float(m.group(1))) if m else 0


class _HttpPending:
    """A lazily-POSTed HTTP request: the POST happens (and blocks) inside
    ``result()``, on the caller's thread — same waitable surface as
    `Request`, and a connection failure surfaces as `ReplicaDead` so the
    router's retry loop treats processes and threads alike."""

    def __init__(self, replica: HttpReplica, body: dict):
        self.replica = replica
        self.body = body

    def result(self, timeout: Optional[float] = None) -> Result:
        data = json.dumps(self.body).encode()
        req = urllib.request.Request(
            self.replica._url("/generate", self.replica.port), data=data,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.replica.timeout_s) as resp:
                # read INCREMENTALLY: a replica dying mid-response must
                # surface now, as a death, not at the request timeout.
                # A chunk-boundary reset raises (IncompleteRead /
                # ConnectionResetError — both handled below); a clean
                # close short of Content-Length is the same half-response
                # and is promoted to IncompleteRead here, because
                # json.loads on a truncated body would misreport a dead
                # replica as a protocol bug
                want = resp.headers.get("Content-Length")
                chunks = []
                while True:
                    chunk = resp.read(65536)
                    if not chunk:
                        break
                    chunks.append(chunk)
                raw = b"".join(chunks)
                if want is not None and len(raw) < int(want):
                    raise http.client.IncompleteRead(
                        raw, int(want) - len(raw))
                out = json.loads(raw.decode())
        except (TimeoutError, socket.timeout) as e:
            # a slow read is NOT a death: the replica is healthy but
            # busy, and resubmitting would stack a duplicate in-flight
            # copy on it — surface the timeout to the caller instead
            raise TimeoutError(
                f"replica {self.replica.name}: no response within "
                f"{timeout or self.replica.timeout_s}s") from e
        except http.client.HTTPException as e:
            # half-response (IncompleteRead) or a torn status line: the
            # process died mid-POST — resubmit elsewhere immediately
            # (the route-time-pinned seed makes the retry emit the
            # identical stream)
            self.replica._last_ok = False
            raise ReplicaDead(
                f"replica {self.replica.name}: died mid-response "
                f"({type(e).__name__}: {e})") from e
        except (OSError, urllib.error.URLError) as e:
            reason = getattr(e, "reason", None)
            if isinstance(reason, (TimeoutError, socket.timeout)):
                raise TimeoutError(
                    f"replica {self.replica.name}: no response within "
                    f"{timeout or self.replica.timeout_s}s") from e
            # connection refused/reset: the process is actually gone
            self.replica._last_ok = False
            raise ReplicaDead(
                f"replica {self.replica.name}: {e}") from e
        self.replica._last_ok = True
        return Result(
            tokens=np.asarray(out.get("tokens", []), np.int32),
            last_logits=np.asarray(out.get("last_logits", []), np.float32),
            bucket=int(out.get("bucket", 0)))


class RouterRequest:
    """One routed request: dispatched to a replica at submit time,
    RESUBMITTED to survivors if that replica dies before completing.
    ``replica_deaths`` counts the retries the caller never saw."""

    _seeds = iter(range(1, 1 << 62))   # guarded-by: _seeds_lock
    _seeds_lock = named_lock("RouterRequest._seeds_lock")

    def __init__(self, router: "Router", tokens: np.ndarray, kw: dict):
        self.router = router
        self.tokens = np.asarray(tokens, np.int32)
        self.kw = dict(kw)
        if self.kw.get("seed") is None:
            # pin the seed at ROUTE time, not engine time: a resubmitted
            # request must sample the identical stream on its new replica
            with RouterRequest._seeds_lock:
                self.kw["seed"] = next(RouterRequest._seeds)
        self.replica_deaths = 0
        self.replica_name: Optional[str] = None
        # completion stamp (perf_counter): the WORKER's set_result time
        # when the replica exposes one, else when result() returned here.
        # Latency instruments must read this, not their own clock after
        # result() — a caller collecting results in submission order
        # observes early completions late and inflates every percentile.
        self.t_done: Optional[float] = None
        self._inner = None
        self._dispatch(exclude=())

    def _dispatch(self, exclude: Sequence[str]) -> None:
        t0 = time.perf_counter()
        replica = self.router._pick(exclude=exclude)
        self._inner = replica.submit(self.tokens, **self.kw)
        self.replica_name = replica.name
        telemetry.span_event(
            "router_dispatch", time.perf_counter() - t0,
            replica=replica.name, depth=replica.queue_depth(),
            retry=self.replica_deaths)

    def result(self, timeout: Optional[float] = None) -> Result:
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        while True:
            left = None
            if deadline is not None:
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise TimeoutError(
                        f"routed request timed out after {timeout}s "
                        f"({self.replica_deaths} replica deaths)")
            try:
                res = self._inner.result(timeout=left)
                self.t_done = getattr(self._inner, "t_done", None) \
                    or time.perf_counter()
                return res
            except ReplicaDead as e:
                # the replica died with our request in flight: resubmit
                # to the survivors (same seed -> same tokens, so the
                # retry is invisible in the output stream) — but only
                # while the caller's deadline still has room; a spent
                # deadline must raise, not spin resubmitting forever.
                # A plain slow read raises TimeoutError (not
                # ReplicaDead) and propagates: slow is not dead.
                if deadline is not None and \
                        time.perf_counter() >= deadline:
                    raise TimeoutError(
                        f"routed request timed out after {timeout}s "
                        f"({self.replica_deaths} replica deaths)") from e
                self.replica_deaths += 1
                dead = self.replica_name
                self._dispatch(exclude=(dead,) if dead else ())


class Router:
    """Spread offered load over replica handles: least-depth healthy
    replica wins, requests orphaned by a death are resubmitted. Pure
    host-side stdlib — the router never touches a device."""

    def __init__(self, replicas: Sequence):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.replicas: Dict[str, object] = {r.name: r for r in replicas}
        self._rr = 0   # guarded-by: _lock
        self._lock = named_lock("Router._lock")

    def _pick(self, exclude: Sequence[str] = ()):
        # snapshot under the lock, PROBE outside it: healthy() and
        # queue_depth() are HTTP round trips for HttpReplica (2s timeout
        # each), and holding the router lock across them would let one
        # unreachable replica serialize every dispatch on every thread
        with self._lock:
            self._rr += 1
            rr = self._rr
            replicas = list(self.replicas.values())
        live = [r for r in replicas
                if r.name not in exclude and r.healthy()]
        if not live:
            # second chance for the excluded (a lone restarted
            # replica beats failing the request outright)
            live = [r for r in replicas if r.healthy()]
        if not live:
            raise ReplicaDead("no healthy replicas")
        depths = [(r.queue_depth(), i) for i, r in enumerate(live)]
        best = min(d for d, _ in depths)
        candidates = [i for d, i in depths if d == best]
        return live[candidates[rr % len(candidates)]]

    def submit(self, tokens: np.ndarray, **kw) -> RouterRequest:
        return RouterRequest(self, tokens, kw)

    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas.values() if r.healthy())

    def stop(self) -> None:
        for r in self.replicas.values():
            stop = getattr(r, "stop", None)
            if stop is not None:
                stop()
