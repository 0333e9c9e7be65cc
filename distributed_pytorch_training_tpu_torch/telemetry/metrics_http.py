"""Live metrics surface: a stdlib-only background HTTP thread.

``/metrics`` serves Prometheus text-format gauges/counters/histograms
aggregated from the SAME event stream the recorder writes — the server
registers an observer on the :class:`~.recorder.Recorder` and folds each
event into thread-safe counters as it is emitted, so the scrape handler
never touches the JSONL and never blocks an emit:

* ``dpt_steps_total`` / ``dpt_last_step`` — the step fence, observed
  through ``step_dispatch`` spans;
* ``dpt_epoch`` — the last completed epoch (``epoch_time_s`` counters);
* ``dpt_phase_seconds`` — one histogram per canonical phase
  (data_wait / step_dispatch / ... / prefill / decode), fixed buckets;
* ``dpt_wire_bytes_total{name,tier,axis}`` — the per-tier wire counters
  (grad_sync's emit_wire_accounting rows; the DCN tier is one more
  label value, not new code);
* ``dpt_anomalies_total{name}`` — watchdog detections;
* ``dpt_gauge{name}`` — every gauge last-value (world_size, capacity,
  queue depth, EF norm);
* ``dpt_last_progress_age_seconds`` — seconds since the step fence last
  ADVANCED (a new high-water `step`, a `steps` counter, or a serving
  prefill/decode span).

``/healthz`` is the progress-fence liveness probe: 200 while the last
step advance is younger than ``stale_after_s`` (the server's start time
seeds the fence, so a compiling run gets its grace), 503 once the fence
stops advancing — a wedged dispatch, a dead loader, a hung collective
all flip it without any in-band cooperation from the training loop.

Costs, by construction: OFF means this module is never imported by the
hot path and zero threads exist (train.py/serving gate on a nonzero
port). ON means one listener thread + per-event dict updates on the
host side only — nothing here touches the device or the step's
numerics.

Stdlib-only, like every module in this package.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.locktrace import named_lock
from .device import DEVICE_PROFILE_KIND, split_of_event
from .recorder import (
    CONTROL_DECISION_KIND,
    CONTROL_SPAN_NAMES,
    ELASTIC_SPAN_NAMES,
    Recorder,
    SCHEMA_VERSION,
    SERVING_SPAN_NAMES,
    SPAN_NAMES,
)

METRICS_PORT_ENV = "DPT_METRICS_PORT"
METRICS_STALE_S_ENV = "DPT_METRICS_STALE_S"

_PHASES = (SPAN_NAMES + SERVING_SPAN_NAMES + ELASTIC_SPAN_NAMES
           + CONTROL_SPAN_NAMES)

# seconds; the +Inf bucket is implicit. Spans range from ~100us CPU-mesh
# dispatches to multi-second compiles/stalls.
_BUCKETS_S = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
              1.0, 2.5, 5.0, 10.0, 30.0)

# step_dispatch feeds the fence only when its `step` ADVANCES (or is
# unstamped); the serving phases always count — see _MetricsState.observe.
_PROGRESS_SPANS = ("step_dispatch", "prefill", "decode")


def resolve_metrics_port(cli_port: Optional[int], rank: int = 0) -> int:
    """The effective port: an explicit CLI value wins, else the
    ``DPT_METRICS_PORT`` env (the fleet orchestrator's stamp), else off.
    A nonzero base is offset by the rank so co-hosted ranks under
    ``--telemetry-all-ranks`` each get their own listener. 0 = off."""
    base = cli_port
    if base is None:
        try:
            base = int(os.environ.get(METRICS_PORT_ENV, "0"))
        except ValueError:
            base = 0
    base = int(base)
    return base + int(rank) if base > 0 else 0


def _escape_label(value: Any) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


class _MetricsState:
    """The scrape-side aggregate, fed one event at a time. ``identity``
    carries the serving (gen, rank, schema, backend) — the satellite that
    lets a federated scrape trace every series back to the rank that
    produced it (``dpt_build_info`` + the /healthz body fields)."""

    def __init__(self, identity: Optional[Dict[str, Any]] = None):
        self._lock = named_lock("_MetricsState._lock")
        self._t0 = time.monotonic()
        self.identity = {"gen": 0, "rank": 0,
                         "schema_version": SCHEMA_VERSION, "backend": "",
                         **(identity or {})}
        self.events_total = 0        # guarded-by: _lock
        self.steps_total = 0         # guarded-by: _lock
        self.last_step = -1          # guarded-by: _lock
        self.epoch = -1              # guarded-by: _lock
        self.last_progress = self._t0   # guarded-by: _lock
        # phase -> (bucket counts, sum_s, count)
        self.phases: Dict[str, Tuple[List[int], float, int]] = {}  # guarded-by: _lock
        self.wire: Dict[Tuple[str, str, str], float] = {}          # guarded-by: _lock
        self.anomalies: Dict[str, int] = {}                        # guarded-by: _lock
        self.gauges: Dict[str, float] = {}                         # guarded-by: _lock
        # device-time attribution: per-phase device seconds +
        # the latest exposed-comm ratio, fed by device_profile events
        self.device_seconds: Dict[str, float] = {}                 # guarded-by: _lock
        self.device_profiles = 0                                   # guarded-by: _lock
        self.exposed_comm_ratio: Optional[float] = None            # guarded-by: _lock
        # control-plane decisions: action -> count, fed by
        # control_decision events (name = the action)
        self.control_decisions: Dict[str, int] = {}                # guarded-by: _lock

    # -- the observer ---------------------------------------------------

    def observe(self, ev: dict) -> None:
        kind = ev.get("kind")
        name = ev.get("name", "?")
        with self._lock:
            self.events_total += 1
            if kind == "span":
                dur_s = float(ev.get("dur_ms", 0.0)) / 1e3
                if name in _PHASES:
                    buckets, total, count = self.phases.get(
                        name, ([0] * (len(_BUCKETS_S) + 1), 0.0, 0))
                    for i, le in enumerate(_BUCKETS_S):
                        if dur_s <= le:
                            buckets[i] += 1
                            break
                    else:
                        buckets[-1] += 1
                    self.phases[name] = (buckets, total + dur_s, count + 1)
                if name == "step_dispatch":
                    self.steps_total += 1
                    step = ev.get("step")
                    if step is None:
                        # an unstamped dispatch carries no fence to
                        # compare — count it as progress
                        self.last_progress = time.monotonic()
                    elif isinstance(step, (int, float)) \
                            and step > self.last_step:
                        self.last_step = int(step)
                        self.last_progress = time.monotonic()
                    # a re-dispatch of an already-seen step (a restart
                    # loop replaying from a checkpoint) is NOT progress:
                    # the fence must ADVANCE to keep /healthz green
                elif name in ("prefill", "decode"):
                    # serving progress: every served phase counts
                    self.last_progress = time.monotonic()
            elif kind == "counter":
                if name == "epoch_time_s":
                    epoch = ev.get("epoch")
                    if isinstance(epoch, (int, float)):
                        self.epoch = max(self.epoch, int(epoch))
                elif name == "steps":
                    self.last_progress = time.monotonic()
                if "tier" in ev or "axis" in ev:
                    key = (name, str(ev.get("tier", "")),
                           str(ev.get("axis", "")))
                    self.wire[key] = (self.wire.get(key, 0.0)
                                      + float(ev.get("value", 0.0)))
            elif kind == "anomaly":
                self.anomalies[name] = self.anomalies.get(name, 0) + 1
            elif kind == "gauge":
                try:
                    self.gauges[name] = float(ev.get("value", 0.0))
                except (TypeError, ValueError):
                    pass
            elif kind == CONTROL_DECISION_KIND:
                self.control_decisions[name] = (
                    self.control_decisions.get(name, 0) + 1)
            elif kind == DEVICE_PROFILE_KIND:
                for phase, ms in split_of_event(ev).items():
                    self.device_seconds[phase] = (
                        self.device_seconds.get(phase, 0.0) + ms / 1e3)
                self.device_profiles += 1
                try:
                    self.exposed_comm_ratio = float(
                        ev.get("exposed_comm_ratio", 0.0))
                except (TypeError, ValueError):
                    pass

    # -- the scrape views -----------------------------------------------

    def render(self) -> str:
        with self._lock:
            age = time.monotonic() - self.last_progress
            ident = ",".join(
                f'{k}="{_escape_label(v)}"'
                for k, v in (("gen", self.identity["gen"]),
                             ("rank", self.identity["rank"]),
                             ("schema_version",
                              self.identity["schema_version"]),
                             ("backend", self.identity["backend"])))
            lines = [
                "# TYPE dpt_build_info gauge",
                f"dpt_build_info{{{ident}}} 1",
                "# TYPE dpt_events_total counter",
                f"dpt_events_total {self.events_total}",
                "# TYPE dpt_steps_total counter",
                f"dpt_steps_total {self.steps_total}",
                "# TYPE dpt_last_step gauge",
                f"dpt_last_step {self.last_step}",
                "# TYPE dpt_epoch gauge",
                f"dpt_epoch {self.epoch}",
                "# TYPE dpt_last_progress_age_seconds gauge",
                f"dpt_last_progress_age_seconds {age:.3f}",
            ]
            if self.phases:
                lines.append("# TYPE dpt_phase_seconds histogram")
                for phase in sorted(self.phases):
                    buckets, total, count = self.phases[phase]
                    cum = 0
                    label = _escape_label(phase)
                    for le, n in zip(_BUCKETS_S, buckets):
                        cum += n
                        lines.append(
                            f'dpt_phase_seconds_bucket{{phase="{label}",'
                            f'le="{le:g}"}} {cum}')
                    cum += buckets[-1]
                    lines.append(
                        f'dpt_phase_seconds_bucket{{phase="{label}",'
                        f'le="+Inf"}} {cum}')
                    lines.append(f'dpt_phase_seconds_sum{{phase="{label}"}}'
                                 f' {total:.6f}')
                    lines.append(f'dpt_phase_seconds_count{{phase='
                                 f'"{label}"}} {count}')
            if self.wire:
                lines.append("# TYPE dpt_wire_bytes_total counter")
                for (name, tier, axis), v in sorted(self.wire.items()):
                    lines.append(
                        f'dpt_wire_bytes_total{{name="{_escape_label(name)}'
                        f'",tier="{_escape_label(tier)}",axis='
                        f'"{_escape_label(axis)}"}} {v:g}')
            if self.anomalies:
                lines.append("# TYPE dpt_anomalies_total counter")
                for name, n in sorted(self.anomalies.items()):
                    lines.append(f'dpt_anomalies_total{{name='
                                 f'"{_escape_label(name)}"}} {n}')
            if self.gauges:
                lines.append("# TYPE dpt_gauge gauge")
                for name, v in sorted(self.gauges.items()):
                    lines.append(
                        f'dpt_gauge{{name="{_escape_label(name)}"}} {v:g}')
            if self.control_decisions:
                lines.append("# TYPE dpt_control_decisions_total counter")
                for action, n in sorted(self.control_decisions.items()):
                    lines.append(
                        f'dpt_control_decisions_total{{action='
                        f'"{_escape_label(action)}"}} {n}')
            if self.device_profiles:
                lines.append("# TYPE dpt_device_profiles_total counter")
                lines.append(
                    f"dpt_device_profiles_total {self.device_profiles}")
                lines.append("# TYPE dpt_device_seconds counter")
                for phase, secs in sorted(self.device_seconds.items()):
                    lines.append(
                        f'dpt_device_seconds{{phase="{_escape_label(phase)}'
                        f'"}} {secs:.6f}')
                if self.exposed_comm_ratio is not None:
                    lines.append("# TYPE dpt_exposed_comm_ratio gauge")
                    lines.append(f"dpt_exposed_comm_ratio "
                                 f"{self.exposed_comm_ratio:g}")
            return "\n".join(lines) + "\n"

    def health(self, stale_after_s: float) -> Tuple[bool, dict]:
        with self._lock:
            age = time.monotonic() - self.last_progress
            healthy = age < stale_after_s
            return healthy, {
                "healthy": healthy,
                "last_progress_age_s": round(age, 3),
                "stale_after_s": stale_after_s,
                "last_step": self.last_step,
                "steps_total": self.steps_total,
                # serving identity: a federated probe
                # can trace this answer back to the rank that produced it
                "gen": self.identity["gen"],
                "rank": self.identity["rank"],
                "schema_version": self.identity["schema_version"],
                "backend": self.identity["backend"],
            }


class _Handler(http.server.BaseHTTPRequestHandler):
    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's contract
        server: "_Server" = self.server  # type: ignore[assignment]
        if self.path.split("?")[0] == "/metrics":
            self._reply(200, server.state.render().encode("utf-8"),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif self.path.split("?")[0] == "/healthz":
            healthy, detail = server.state.health(server.stale_after_s)
            self._reply(200 if healthy else 503,
                        (json.dumps(detail, sort_keys=True) + "\n")
                        .encode("utf-8"), "application/json")
        else:
            self._reply(404, b"telemetry metrics: /metrics or /healthz\n",
                        "text/plain")

    def do_POST(self):  # noqa: N802 — the on-demand profiling trigger
        """``POST /profile?steps=K``: arm a K-step trace
        capture on the running process. 202 armed; 409 profiler busy
        (refuse-not-clobber); 400 bad steps; 404 when this process has
        no profiler wired (metrics on a run without the capture plane —
        the supervised loop, or a server outside train.py/serving)."""
        path, _, query = self.path.partition("?")
        if path != "/profile":
            self._reply(404, b'{"error": "POST /profile?steps=K"}\n',
                        "application/json")
            return
        server: "_Server" = self.server  # type: ignore[assignment]
        owner = server.owner
        handler = getattr(owner, "profile_handler", None)
        if handler is None:
            self._reply(404, b'{"error": "no profiler wired on this '
                             b'process"}\n', "application/json")
            return
        params = dict(p.partition("=")[::2] for p in query.split("&") if p)
        try:
            steps = int(params.get("steps", "2"))
            if steps < 1:
                raise ValueError
        except ValueError:
            self._reply(400, b'{"error": "steps must be a positive '
                             b'integer"}\n', "application/json")
            return
        try:
            armed = bool(handler(steps))
        except Exception:  # noqa: BLE001 — the trigger never crashes
            armed = False  # the serving thread
        if armed:
            body = json.dumps({"armed": True, "steps": steps}) + "\n"
            self._reply(202, body.encode("utf-8"), "application/json")
        else:
            self._reply(409, b'{"error": "profiler busy (a window is '
                             b'armed or in flight)"}\n',
                        "application/json")

    def log_message(self, fmt, *args):  # scrapes must not spam stdout
        return


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, state: _MetricsState, stale_after_s: float,
                 owner: Optional["MetricsServer"] = None):
        super().__init__(addr, _Handler)
        self.state = state
        self.stale_after_s = stale_after_s
        self.owner = owner


class MetricsServer:
    """The background `/metrics` + `/healthz` listener.

    ``port=0`` binds an ephemeral port (tests); :meth:`start` returns the
    bound port. ``recorder`` is the stream to observe (its observer is
    removed again on :meth:`stop`; its gen/rank stamp the serving
    identity). ``stale_after_s`` is the healthz fence: default from
    ``DPT_METRICS_STALE_S``, else 300s — generous because a first-step
    compile is legitimate silence. ``backend`` labels
    ``dpt_build_info`` (this module stays stdlib-only: the caller names its
    backend). ``profile_handler`` (settable after start — train.py wires
    it once the profiler exists) is the ``POST /profile`` target:
    ``handler(steps) -> bool`` (armed)."""

    def __init__(self, port: int, recorder: Optional[Recorder] = None,
                 host: str = "0.0.0.0",
                 stale_after_s: Optional[float] = None,
                 backend: str = "",
                 profile_handler: Optional[Any] = None):
        if stale_after_s is None:
            try:
                stale_after_s = float(
                    os.environ.get(METRICS_STALE_S_ENV, "300"))
            except ValueError:
                stale_after_s = 300.0
        self.state = _MetricsState(identity={
            "gen": getattr(recorder, "gen", 0),
            "rank": getattr(recorder, "rank", 0),
            "backend": backend})
        self._host = host
        self._want_port = int(port)
        self._recorder = recorder
        self.stale_after_s = float(stale_after_s)
        self.profile_handler = profile_handler
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return (self._httpd.server_address[1]
                if self._httpd is not None else None)

    def start(self) -> int:
        if self._httpd is not None:
            return self.port  # type: ignore[return-value]
        self._httpd = _Server((self._host, self._want_port), self.state,
                              self.stale_after_s, owner=self)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name=f"dpt-metrics-{self.port}", daemon=True)
        self._thread.start()
        if self._recorder is not None:
            self._recorder.add_observer(self.state.observe)
        return self.port  # type: ignore[return-value]

    def stop(self) -> None:
        if self._recorder is not None:
            self._recorder.remove_observer(self.state.observe)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# module-global lifecycle (the train.py / serving wiring): one server per
# process, started only when a port resolves nonzero — off means this
# function is the only thing that ran, and it started nothing.
# ---------------------------------------------------------------------------

_SERVER: Optional[MetricsServer] = None


def start_metrics_server(port: int, recorder: Optional[Recorder] = None,
                         **kwargs: Any) -> Optional[MetricsServer]:
    """Start (or replace) the process-global metrics server. ``port <= 0``
    is a no-op returning None — the off path creates zero threads. A bind
    failure (the port is taken) also returns None, with a stderr note:
    the live surface shares the recorder's contract — a broken
    observability convenience must never take the training run down."""
    import sys

    global _SERVER
    if port <= 0:
        return None
    stop_metrics_server()
    server = MetricsServer(port, recorder=recorder, **kwargs)
    try:
        server.start()
    except OSError as e:
        print(f"telemetry: /metrics server could not bind port {port} "
              f"({e}) — continuing without the live surface",
              file=sys.stderr, flush=True)
        return None
    _SERVER = server
    return _SERVER


def stop_metrics_server() -> None:
    global _SERVER
    if _SERVER is not None:
        _SERVER.stop()
        _SERVER = None


def get_metrics_server() -> Optional[MetricsServer]:
    return _SERVER


# ---------------------------------------------------------------------------
# Federation: ONE /metrics endpoint over the per-rank ports.
# ---------------------------------------------------------------------------


def scrape_metrics(port: int, timeout_s: float = 0.8,
                   host: str = "127.0.0.1") -> Optional[str]:
    """One best-effort /metrics scrape of a local listener, or None
    (a target mid-compile simply has no listener yet; not an error).
    THE scrape helper — the federation proxy and the fleet
    orchestrator's smoke both route through it, so a future fix
    (retries, remote hosts, wider exception set) lands once."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://{host}:{int(port)}/metrics",
                timeout=timeout_s) as resp:
            return resp.read().decode("utf-8", errors="replace")
    except (urllib.error.URLError, OSError, ValueError):
        return None


_IDENTITY_RE = None  # compiled lazily (keeps the import section stdlib-thin)


def _parse_identity(body: str) -> Optional[Tuple[str, str]]:
    """(gen, rank) from a scraped page's ``dpt_build_info`` line — the
    self-describing satellite: the proxy never has to be told which
    identity sits behind a port."""
    global _IDENTITY_RE
    if _IDENTITY_RE is None:
        import re
        _IDENTITY_RE = re.compile(
            r'^dpt_build_info\{[^}]*gen="([^"]*)"[^}]*rank="([^"]*)"')
    for line in body.splitlines():
        m = _IDENTITY_RE.match(line)
        if m:
            return m.group(1), m.group(2)
    return None


def _relabel_line(line: str, gen: str, rank: str) -> Optional[str]:
    """One Prometheus sample line with ``gen``/``rank`` labels injected
    (None for comment/blank lines — the merger re-derives TYPE lines).
    Lines already carrying a gen label (dpt_build_info) pass through."""
    line = line.rstrip()
    if not line or line.startswith("#"):
        return None
    if 'gen="' in line.split("}")[0]:
        return line
    name, brace, rest = line.partition("{")
    if brace:
        return f'{name}{{gen="{gen}",rank="{rank}",{rest}'
    name, _, value = line.partition(" ")
    return f'{name}{{gen="{gen}",rank="{rank}"}} {value}'


class FederationServer:
    """The fan-in proxy: scrape N per-rank ``/metrics`` ports, merge into
    ONE Prometheus page with every series ``gen``/``rank``-labelled.

    ``targets`` is a list of ports (or a callable returning one — the
    orchestrator's live-children feed). Identities are read from each
    target's own ``dpt_build_info`` line, so the proxy needs no mapping.
    Pages are CACHED per identity: a child that exited (a finished fleet
    generation) keeps its last page in the merge, marked
    ``dpt_federation_up{gen,rank} 0`` — the final federated page carries
    every generation that ever answered, which is the fleet story the
    ROADMAP's missing-proxy item asked for. ``refresh_s`` arms a
    background poll (the orchestrator's mode: children live shorter than
    the gap between external scrapes); without it every GET scrapes
    inline. stdlib-only, like everything in this package."""

    def __init__(self, port: int, targets, host: str = "0.0.0.0",
                 timeout_s: float = 0.8,
                 refresh_s: Optional[float] = None):
        self._want_port = int(port)
        self._host = host
        self._targets = targets if callable(targets) \
            else (lambda t=list(targets): t)
        self.timeout_s = float(timeout_s)
        self.refresh_s = refresh_s
        self._lock = named_lock("FederationServer._lock")
        # identity -> {"body": str, "up": bool, "port": int}; scrapes
        # happen OUTSIDE the lock (refresh), only the cache swap is under
        self._cache: Dict[Tuple[str, str], Dict[str, Any]] = {}  # guarded-by: _lock
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self._refresher: Optional[threading.Thread] = None
        self._stop_refresh = threading.Event()
        # the handler duck-types against _MetricsState: render()/health()
        self.state = self
        self.stale_after_s = 0.0

    # -- scraping ---------------------------------------------------------

    def _scrape(self, port: int) -> Optional[str]:
        return scrape_metrics(port, timeout_s=self.timeout_s)

    def refresh(self) -> int:
        """Scrape every current target once; returns how many answered.
        Identities that did not answer (exited children) stay cached,
        marked down."""
        answered = 0
        live: set = set()
        for port in list(self._targets()):
            body = self._scrape(int(port))
            if body is None:
                continue
            answered += 1
            identity = _parse_identity(body) or ("?", str(port))
            live.add(identity)
            with self._lock:
                self._cache[identity] = {"body": body, "up": True,
                                         "port": int(port)}
        with self._lock:
            for identity, entry in self._cache.items():
                if identity not in live:
                    entry["up"] = False
        return answered

    # -- the merged page (duck-typed _MetricsState surface) ---------------

    def render(self) -> str:
        if self.refresh_s is None:
            self.refresh()   # inline mode: every GET is a fresh fan-out
        with self._lock:
            cache = {k: dict(v) for k, v in self._cache.items()}
        types: Dict[str, str] = {}
        samples: List[str] = []
        up_lines: List[str] = []
        for (gen, rank) in sorted(cache):
            entry = cache[(gen, rank)]
            up_lines.append(
                f'dpt_federation_up{{gen="{_escape_label(gen)}",rank='
                f'"{_escape_label(rank)}"}} {1 if entry["up"] else 0}')
            for line in entry["body"].splitlines():
                if line.startswith("# TYPE "):
                    parts = line.split()
                    if len(parts) == 4:
                        types.setdefault(parts[2], parts[3])
                    continue
                out = _relabel_line(line, gen, rank)
                if out is not None:
                    samples.append(out)
        lines = ["# TYPE dpt_federation_targets gauge",
                 f"dpt_federation_targets {len(cache)}",
                 "# TYPE dpt_federation_up gauge", *up_lines]
        for name, kind in sorted(types.items()):
            lines.append(f"# TYPE {name} {kind}")
        lines.extend(samples)
        return "\n".join(lines) + "\n"

    def health(self, stale_after_s: float) -> Tuple[bool, dict]:
        if self.refresh_s is None:
            self.refresh()
        with self._lock:
            detail = {
                "healthy": any(e["up"] for e in self._cache.values()),
                "targets": {
                    f"gen{g}/rank{r}": {"up": e["up"], "port": e["port"]}
                    for (g, r), e in sorted(self._cache.items())},
            }
        return bool(detail["healthy"]), detail

    # -- lifecycle --------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return (self._httpd.server_address[1]
                if self._httpd is not None else None)

    def start(self) -> int:
        if self._httpd is not None:
            return self.port  # type: ignore[return-value]
        self._httpd = _Server((self._host, self._want_port), self,
                              self.stale_after_s, owner=None)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name=f"dpt-metrics-federation-{self.port}", daemon=True)
        self._thread.start()
        if self.refresh_s is not None:
            self._stop_refresh.clear()
            self._refresher = threading.Thread(
                target=self._refresh_loop, name="dpt-federation-refresh",
                daemon=True)
            self._refresher.start()
        return self.port  # type: ignore[return-value]

    def _refresh_loop(self) -> None:
        while not self._stop_refresh.wait(self.refresh_s):
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 — the poll must outlive any
                pass           # one bad scrape

    def stop(self) -> None:
        self._stop_refresh.set()
        if self._refresher is not None:
            self._refresher.join(timeout=5.0)
            self._refresher = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
