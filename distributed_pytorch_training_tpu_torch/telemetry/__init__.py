"""telemetry/ — unified structured run telemetry with a crash-surviving
flight recorder: the JAX package's ``telemetry/`` copied into the port
(same event schema, stream file names, flight file format, Prometheus
text and ``DPT_*`` environment names, so either package's CLI reads the
other's streams). Every instrument feeds ONE stream:

* :class:`~.recorder.Recorder` — process-local typed events (host-side
  spans, counters, gauges, anomalies) appended to a schema-versioned JSONL
  (``telemetry_rank0.jsonl``, fsync'd on a cadence) AND kept in a bounded
  in-memory ring buffer;
* the **flight recorder** (:mod:`.flight`) — on any abnormal exit
  (Supervisor retry/abort, chaos crash/sigterm, unhandled exception)
  the ring's last N events + the exit cause are flushed to
  ``flight_<ts>.json``, so every rc=70 / rc!=0 leaves a
  postmortem artifact even when the JSONL's tail was lost;
* the **anomaly watchdog** (:mod:`.watchdog`) — non-finite loss,
  step-time spikes vs a rolling median, loader-stall detection, each an
  ``anomaly`` event with an optional abort hook (off by default);
* the ``telemetry`` CLI (:mod:`.__main__`) — ``summary`` (per-phase time
  split + throughput + wire-byte totals, with crash-truncated partial
  epochs reported explicitly), ``tail`` (``-f`` follows a live stream
  through rotation), ``aggregate`` (the fleet summary), and
  ``export --perfetto`` (host spans as Chrome trace-event JSON that loads
  alongside a ``torch.profiler`` trace in Perfetto; multiple streams
  stitch into one timeline with a stable pid per (gen, rank));
* the **fleet plane**: per-rank streams
  (``telemetry_rank<R>.jsonl``, rank 0 by default, every rank under the
  ``--telemetry-all-ranks`` opt-in; every event stamped with its
  gen/rank identity), cross-stream aggregation with a straggler
  detector that rank- AND phase-attributes divergence
  (:mod:`.aggregate`), and a stdlib-only live ``/metrics`` +
  ``/healthz`` HTTP surface fed by an observer on the recorder
  (:mod:`.metrics_http`; zero threads when off).

Design constraints (enforced, not aspirational):

* **Host-side only.** Instrumentation lives around dispatched steps and
  reads host clocks; it adds no device synchronization (the profiler's
  window edges are the only syncs, ``utils/profiling.py``) and never
  changes training numerics.
* **Zero cost when unconfigured.** The module-level emit helpers check one
  global and return; no file, no ring, no timestamps.
* **Stdlib only.** The package imports neither torch nor a backend, so the
  CLI reads streams on machines with no accelerator stack.
"""

from __future__ import annotations

from .recorder import (  # noqa: F401
    ALL_RANKS_ENV,
    CONTROL_DECISION_KIND,
    FLEET_GENERATION_ENV,
    FLEET_RANK_ENV,
    REGISTERED_SPAN_NAMES,
    SCHEMA_VERSION,
    NullSpan,
    Recorder,
    all_ranks_enabled,
    configure,
    counter,
    emit,
    gauge,
    generation_identity,
    get,
    is_configured,
    rank_identity,
    reset,
    should_stream,
    span,
    span_event,
    stream_filename,
)
from .flight import flush_flight, install_excepthook  # noqa: F401
from .watchdog import AnomalyAbort, AnomalyWatchdog  # noqa: F401

# The live-surface names resolve lazily (PEP 562): metrics_http's cost
# contract is that the OFF path never even imports it — the recorder,
# flight recorder, and every stdlib-only CLI reader import this package
# without paying for http.server, and the first actual use (train.py's
# port wiring, a test) triggers the real import.
_METRICS_EXPORTS = frozenset({
    "METRICS_PORT_ENV", "MetricsServer", "FederationServer",
    "get_metrics_server", "resolve_metrics_port",
    "start_metrics_server", "stop_metrics_server",
})


def __getattr__(name: str):
    if name in _METRICS_EXPORTS:
        from . import metrics_http

        return getattr(metrics_http, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
