"""The port's telemetry package against the JAX package's (the port's is
a copy; these hold it to the original on the same inputs).

* ``summarize`` and ``to_perfetto`` of one hand-made event list (a whole
  epoch, and a crash-truncated one) give the same dicts;
* ``_MetricsState`` fed the same events renders the same Prometheus text;
* ``aggregate_streams`` and ``stitch_perfetto`` over two rank streams give
  the same dicts;
* the anomaly watchdog fires the same anomalies on the same step-time,
  data-wait and loss series;
* a stream the port's recorder writes is read by the JAX ``read_stream``
  (and the other way), and every CLI command prints the same text.

All comparisons are exact: the code is the same, only the package paths
differ.
"""

import json
import math

import pytest

from distributed_pytorch_training_tpu import telemetry as jt
from distributed_pytorch_training_tpu.telemetry import (
    __main__ as jcli,
    aggregate as jagg,
    metrics_http as jhttp,
)
from distributed_pytorch_training_tpu_torch import telemetry as pt
from distributed_pytorch_training_tpu_torch.telemetry import (
    __main__ as pcli,
    aggregate as pagg,
    metrics_http as phttp,
)
from _torch_rig import port_process_state  # noqa: F401


@pytest.fixture(autouse=True)
def _no_jax_recorder():
    yield
    jt.reset()


def _events(partial: bool = False):
    """One rank's stream as dicts: meta, the training spans of 6 steps,
    wire rows, a gauge, an anomaly, a device profile, a control decision,
    and (unless ``partial``) the epoch's counters and an eval span."""
    t = 1_000.0
    evs = [{"v": 2, "ts": t, "kind": "meta", "name": "stream", "gen": 0,
            "rank": 0, "schema": 2, "run_id": "r", "pid": 7}]

    def add(kind, name, **f):
        evs.append({"v": 2, "ts": t + len(evs) * 0.01, "kind": kind,
                    "name": name, "gen": 0, "rank": 0, **f})

    for step in range(6):
        add("span", "data_wait", t0=t, dur_ms=1.5 + step, step=step,
            epoch=0)
        add("span", "step_dispatch", t0=t, dur_ms=40.0 + 3 * step,
            step=step, epoch=0)
    add("counter", "wire_bytes_per_replica", value=89453136, tier="ici",
        axis="data", wire_dtype="int8_hier", n_shards=4, n_slices=2)
    add("counter", "wire_bytes_per_replica", value=22363284, tier="dcn",
        axis="slice", wire_dtype="int8_hier", n_shards=4, n_slices=2)
    add("counter", "fsdp_gather_bytes", value=1000, tier="ici",
        wire_dtype="int8", n_shards=2)
    add("gauge", "world_size", value=2)
    add("anomaly", "step_time_spike", step=4, step_s=0.5, median_s=0.04)
    add("device_profile", "device_profile", start_step=2, stop_step=5,
        steps=3, reason="window", trigger_step=None, window_ms=120.5,
        compute_ms=80.25, comm_hidden_ms=10.0, comm_exposed_ms=20.0,
        host_gap_ms=10.25, exposed_comm_ratio=0.6667, comm_share_pct=24.9,
        by_op_ms={"all-reduce": 30.0}, n_device_lanes=1)
    add("control_decision", "evict", applied=False, reason="slow")
    add("counter", "profiler_busy", value=1, holder="x", wanted="http")
    add("span", "save_blocked", t0=t, dur_ms=12.0, label=6, phase="save",
        async_save=True)
    add("span", "queue_wait", t0=t, dur_ms=0.4, request=1, bucket=16)
    add("span", "prefill", t0=t, dur_ms=3.0, bucket=16, rows=1)
    add("span", "decode", t0=t, dur_ms=9.0, bucket=16, steps=7, rows=1)
    add("event", "torn_checkpoint_skipped", label=3, problem="sha")
    if not partial:
        add("span", "device_sync", t0=t, dur_ms=2.0, epoch=0)
        add("counter", "epoch_time_s", value=0.4, epoch=0)
        add("counter", "steps", value=6, epoch=0)
        add("counter", "samples", value=48, epoch=0)
        add("span", "eval", t0=t, dur_ms=30.0)
    return evs


@pytest.mark.parametrize("partial", [False, True],
                         ids=["whole_epoch", "crash_truncated"])
def test_summary_and_perfetto_equal_jax(partial):
    evs = _events(partial)
    assert pcli.summarize(evs) == jcli.summarize(evs)
    assert pcli.to_perfetto(evs) == jcli.to_perfetto(evs)


def test_metrics_render_equal_jax(monkeypatch):
    # the render prints ages from time.monotonic(); one frozen clock for
    # both states, so the two texts compare exactly, the age lines too
    for mod in (phttp, jhttp):
        monkeypatch.setattr(mod.time, "monotonic", lambda: 1000.0)
    ident = {"gen": 0, "rank": 0, "backend": "cuda"}
    ps, js = phttp._MetricsState(dict(ident)), jhttp._MetricsState(
        dict(ident))
    for ev in _events():
        ps.observe(dict(ev))
        js.observe(dict(ev))
    text = ps.render()
    assert text == js.render()
    assert "dpt_exposed_comm_ratio" in text and "dpt_steps_total" in text
    assert "dpt_last_progress_age_seconds 0.000" in text


def _rank_stream(path, rank, stall_at=None):
    with open(path, "w", encoding="utf-8") as f:
        def emit(kind, name, **fields):
            f.write(json.dumps({"v": 2, "ts": 1000.0 + rank, "kind": kind,
                                "name": name, "gen": 0, "rank": rank,
                                **fields}) + "\n")

        emit("meta", "stream", schema=2, run_id=f"r{rank}", pid=10 + rank)
        for step in range(10):
            wait = 1.5 if step == stall_at else 0.004
            emit("span", "data_wait", dur_ms=wait * 1e3, step=step)
            emit("span", "step_dispatch", dur_ms=4.0 + rank, step=step)
        emit("device_profile", "device_profile", start_step=4,
             stop_step=6, steps=2, reason="http", trigger_step=None,
             window_ms=100.0, compute_ms=85.0 - 30 * rank,
             comm_hidden_ms=5.0, comm_exposed_ms=10.0 + 30 * rank,
             host_gap_ms=0.0, by_op_ms={"all-reduce": 15.0 + 30 * rank})
        emit("counter", "epoch_time_s", value=2.0, epoch=0)
    return str(path)


def test_aggregate_and_stitch_equal_jax(tmp_path):
    paths = [_rank_stream(tmp_path / "telemetry_rank0.jsonl", 0),
             _rank_stream(tmp_path / "telemetry_rank1.jsonl", 1,
                          stall_at=5)]
    agg = pagg.aggregate_streams(paths)
    assert agg == jagg.aggregate_streams(paths)
    assert any(s["rank"] == 1 for s in agg["stragglers"])
    assert pagg.stitch_perfetto(pagg.split_streams(paths)) == \
        jagg.stitch_perfetto(jagg.split_streams(paths))


def test_watchdog_anomalies_equal_jax():
    """Steady steps, a spike, a loader stall, an absolute stall and a
    non-finite loss: both watchdogs fire the same anomalies, with the
    same fields, on their streams and on the instance."""
    series = [(0.05 + 0.001 * (i % 3), 0.002) for i in range(30)]
    series[24] = (0.9, 0.002)        # a step-time spike
    series[27] = (0.05, 2.5)         # a loader stall
    streams = []
    for pkg in (pt, jt):
        rec = pkg.configure(None)
        wd = pkg.AnomalyWatchdog(min_samples=20, stall_abs_s=2.0)
        for step, (step_s, wait_s) in enumerate(series):
            wd.observe_step(step, step_s + wait_s, data_wait_s=wait_s)
        for step, loss in ((9, 2.5), (19, math.nan), (29, math.inf)):
            wd.observe_loss(step, loss)
        streams.append((wd.anomalies,
                        [{k: v for k, v in ev.items() if k != "ts"}
                         for ev in rec.tail(100) if ev["kind"] == "anomaly"]))
        pkg.reset()
    assert streams[0] == streams[1]
    names = [name for name, _ in streams[0][0]]
    assert {"step_time_spike", "loader_stall", "non_finite_loss"} <= \
        set(names)


def test_port_stream_reads_in_jax_and_back(tmp_path):
    port_path = tmp_path / "port" / pt.stream_filename(0)
    rec = pt.configure(str(port_path), rank=0, gen=0,
                       meta={"entry": "train.py"})
    for step in range(3):
        pt.span_event("data_wait", 0.001, step=step, epoch=0)
        pt.span_event("step_dispatch", 0.02, step=step, epoch=0)
    with pt.span("device_sync", epoch=0):
        pass
    pt.counter("epoch_time_s", 0.1, epoch=0)
    pt.counter("steps", 3, epoch=0)
    pt.gauge("world_size", 1)
    assert rec.n_events == 11  # meta + 10
    pt.reset()
    evs, bad = jcli.read_stream(str(port_path))
    assert bad == 0 and evs == pcli.read_stream(str(port_path))[0]
    assert [e["name"] for e in evs][:3] == ["stream", "data_wait",
                                            "step_dispatch"]
    assert jcli.summarize(evs) == pcli.summarize(evs)

    jax_path = tmp_path / "jax" / jt.stream_filename(1)
    jt.configure(str(jax_path), rank=1, gen=0)
    jt.span_event("step_dispatch", 0.02, step=0, epoch=0)
    jt.reset()
    evs, bad = pcli.read_stream(str(jax_path))
    assert bad == 0 and [e["rank"] for e in evs] == [1, 1]


@pytest.mark.parametrize("argv", [
    ["summary"], ["summary", "--json"], ["tail", "-n", "4"],
    ["tail", "-n", "3", "-f", "--poll-s", "0.01", "--follow-timeout",
     "0.05"],
    ["export", "--perfetto"], ["aggregate"], ["aggregate", "--json"],
], ids=lambda a: "-".join(x.strip("-") for x in a[:2]))
def test_cli_prints_what_jax_prints(tmp_path, capsys, argv):
    paths = [_rank_stream(tmp_path / "telemetry_rank0.jsonl", 0),
             _rank_stream(tmp_path / "telemetry_rank1.jsonl", 1,
                          stall_at=5)]
    streams = paths if argv[0] == "aggregate" else paths[:1]
    full = [argv[0], *streams, *argv[1:]]
    assert pcli.main(full) == 0
    ours = capsys.readouterr().out
    assert jcli.main(full) == 0
    assert ours == capsys.readouterr().out and ours


# leaf shapes in flax order (a small conv net): the wire rows depend on
# the sizes and their order only
WIRE_LEAVES = [(3, 3, 3, 16), (16,), (16,), (3, 3, 16, 32), (32,), (32,),
               (512, 10), (10,), (1000,), (7, 11)]


@pytest.mark.parametrize("cfg,n", [
    (dict(wire_dtype="fp32"), 2),
    (dict(wire_dtype="int8", bucket_cap_mb=0.01), 2),
    (dict(wire_dtype="bf16", bucket_cap_mb=25), 8),
    (dict(wire_dtype="int8_multihop"), 4),
    (dict(wire_dtype="int8_hier", slices=2), 4),
    (dict(wire_dtype="int8", fsdp_explicit=True), 2),
    (dict(wire_dtype="int8_hier", fsdp_explicit=True, slices=2), 4),
], ids=lambda x: x if isinstance(x, int) else "-".join(
    f"{k}={v}" for k, v in x.items()))
def test_wire_accounting_rows_equal_jax(cfg, n):
    """`emit_wire_accounting`: the same numbers and the same counter rows
    (tier, axis, bytes) as the JAX package's on the same leaf shapes."""
    import numpy as np

    from distributed_pytorch_training_tpu.parallel import (
        grad_sync as jax_grad_sync,
    )
    from distributed_pytorch_training_tpu_torch.parallel import grad_sync

    leaves = [np.zeros(shape, np.float32) for shape in WIRE_LEAVES]
    rows = []
    for pkg, emit in ((pt, grad_sync.emit_wire_accounting),
                      (jt, jax_grad_sync.emit_wire_accounting)):
        rec = pkg.configure(None)
        out = emit(leaves, dict(cfg), n)
        rows.append((out, [{k: v for k, v in ev.items() if k != "ts"}
                           for ev in rec.tail(10)
                           if ev["kind"] == "counter"]))
        pkg.reset()
    assert rows[0] == rows[1]
    assert rows[0][0]["wire_bytes_per_replica"] > 0


def test_federation_page_merges_two_ranks(tmp_path):
    """`FederationServer` over two ranks' /metrics listeners (port 0: the
    OS picks each): one page, every sample labelled with its gen and
    rank."""
    import urllib.request

    servers = []
    try:
        for rank in (0, 1):
            rec = pt.Recorder(str(tmp_path / f"r{rank}.jsonl"), gen=0,
                              rank=rank)
            servers.append(phttp.MetricsServer(0, recorder=rec))
            servers[-1].start()
            rec.span_event("step_dispatch", 0.01, step=rank)
        fed = phttp.FederationServer(0, [s.port for s in servers],
                                     refresh_s=0.05)
        servers.append(fed)
        fed.start()
        assert fed.refresh() == 2
        with urllib.request.urlopen(f"http://127.0.0.1:{fed.port}/metrics",
                                    timeout=5) as resp:
            page = resp.read().decode()
    finally:
        for s in servers:
            s.stop()
    for rank in (0, 1):
        assert f'dpt_steps_total{{gen="0",rank="{rank}"}} 1' in page
