"""``python -m distributed_pytorch_training_tpu_torch.telemetry`` — read one
telemetry JSONL stream (``telemetry_rank0.jsonl``) and report. A copy of
the JAX package's CLI: either reads the other's streams.

Commands:
  summary <stream.jsonl> [--json]
      Per-phase step-time split (data_wait / step_dispatch / device_sync /
      save_blocked / eval / restore, the serving phases queue_wait /
      prefill / decode / drain, and the elastic phases elastic_replan /
      elastic_reshard; `compile` spans show in the spans table but are
      not summed — a lazy compile nests inside the span that triggered
      it), throughput, wire-byte totals, and
      anomaly counts — the "gradient sync share of step" table the
      reference promised, computed from the stream's OWN recorded totals
      (the split is checked against the recorded epoch seconds; the
      unaccounted remainder is printed, never hidden). A crash-truncated
      stream — per-step spans with no enclosing ``epoch_time_s`` total —
      reports those steps as an explicit PARTIAL EPOCH block instead of
      folding them into a misleading split.
  aggregate <stream.jsonl> [<stream.jsonl> ...] [--json]
      The FLEET summary (telemetry/aggregate.py): merge N per-rank
      streams (across ranks AND fleet generations; generations appended
      into one file split at their meta headers) into per-(gen, rank)
      phase splits side by side, wire rollups by tier/axis, anomaly
      rollup, and the cross-rank straggler table (slowest rank, with the
      phase and step that made it slow).
  tail <stream.jsonl> [-n N] [-f [--poll-s S] [--follow-timeout S]]
      Last N events, one per line. With ``-f``, keep polling the file for
      new events (surviving rotation to a new stream file) — the
      watch-a-live-run mode that needs no HTTP endpoint.
  export <stream.jsonl> [<stream.jsonl> ...] --perfetto -o trace.json
      Host spans as Chrome trace-event JSON — loads in Perfetto/
      chrome://tracing alongside the torch.profiler trace captured by
      utils/profiling.StepProfiler. One stream exports on the wall
      clock; multiple streams STITCH into one timeline with a stable
      pid per (gen, rank) and gauge counter tracks, skew-normalized to
      each stream's own meta anchor.

Exit codes: 0 ok, 1 unreadable/empty stream, 2 usage error.

Stdlib only: postmortems are read on machines with no accelerator
stack (the same constraint as the recorder's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import List, Optional, Tuple

from .recorder import (
    CONTROL_DECISION_KIND,
    CONTROL_SPAN_NAMES,
    ELASTIC_SPAN_NAMES,
    SERVING_SPAN_NAMES,
    SPAN_NAMES,
)

# The per-step phases: spans that belong INSIDE an epoch's recorded wall.
# Trailing instances with no epoch_time_s after them are a crash-truncated
# partial epoch (the summary's explicit PARTIAL block, not split filler).
IN_EPOCH_SPAN_NAMES = ("data_wait", "step_dispatch", "device_sync")


def read_stream(path: str) -> Tuple[List[dict], int]:
    """(events, n_malformed). Malformed lines are counted, not fatal — a
    stream torn mid-line by a crash must still summarize."""
    events: List[dict] = []
    bad = 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
                if not isinstance(ev, dict):
                    raise ValueError("not an object")
                events.append(ev)
            except ValueError:
                bad += 1
    return events, bad


def summarize(events: List[dict]) -> dict:
    """The summary body: span totals, counter sums, gauge last-values,
    the step-time split, and the self-consistency line.

    Crash truncation: per-step spans are folded into
    the split only once their enclosing ``epoch_time_s`` total arrives. A
    mid-epoch crash (or a new ``meta`` header — an appended relaunch)
    leaves trailing in-epoch spans with NO such total; they are reported
    as an explicit ``partial_epoch`` block instead of being mixed into
    the completed epochs' percentages, where they used to force the
    adaptive denominator and claim a self-consistent 100% split over an
    epoch that never finished."""
    spans: dict = defaultdict(lambda: {"total_ms": 0.0, "count": 0,
                                       "max_ms": 0.0})
    counters: dict = defaultdict(float)
    gauges: dict = {}
    anomalies: List[dict] = []
    device_profiles: List[dict] = []
    control_decisions: List[dict] = []
    meta: Optional[dict] = None
    # in-epoch spans seen since the last epoch_time_s counter: folded into
    # the accounted split by that counter's arrival, or into the PARTIAL
    # block by a meta boundary / end of stream
    pending_ms: dict = defaultdict(float)
    pending_steps = 0
    partial_ms: dict = defaultdict(float)
    partial_steps = 0

    def _fold_pending_into_partial():
        nonlocal pending_ms, pending_steps, partial_steps
        for n, v in pending_ms.items():
            partial_ms[n] += v
        partial_steps += pending_steps
        pending_ms = defaultdict(float)
        pending_steps = 0

    for ev in events:
        kind = ev.get("kind")
        name = ev.get("name", "?")
        if kind == "span":
            dur = float(ev.get("dur_ms", 0.0))
            s = spans[name]
            s["total_ms"] += dur
            s["count"] += 1
            s["max_ms"] = max(s["max_ms"], dur)
            if name in IN_EPOCH_SPAN_NAMES:
                pending_ms[name] += dur
                if name == "step_dispatch":
                    pending_steps += 1
        elif kind == "counter":
            counters[name] += float(ev.get("value", 0.0))
            if name == "epoch_time_s":
                # the enclosing total arrived: the pending spans belong to
                # a COMPLETED epoch
                pending_ms = defaultdict(float)
                pending_steps = 0
        elif kind == "gauge":
            gauges[name] = ev.get("value")
        elif kind == "anomaly":
            anomalies.append(ev)
        elif kind == "device_profile":
            device_profiles.append(ev)
        elif kind == CONTROL_DECISION_KIND:
            control_decisions.append(ev)
        elif kind == "meta":
            # a relaunch appended to the same stream: whatever the
            # previous run left pending was truncated, not completed
            _fold_pending_into_partial()
            if meta is None:
                meta = ev
    _fold_pending_into_partial()

    # the step-time split over the canonical phases, against the stream's
    # own recorded wall total (the `epoch_time_s` counter the train loop
    # emits per epoch) — phases are measured independently of the total,
    # so the unaccounted remainder is an honesty check, not filler. Some
    # phases legitimately sit OUTSIDE the epoch wall (eval, epoch-boundary
    # save stalls), so when accounted spans exceed it the denominator is
    # the accounted total instead — percentages always close to 100.
    # Partial-epoch span time is EXCLUDED here (reported in its own
    # block); the spans table above still shows every span.
    wall_ms = counters.get("epoch_time_s", 0.0) * 1e3
    accounted = {n: spans[n]["total_ms"] - partial_ms.get(n, 0.0)
                 for n in SPAN_NAMES + SERVING_SPAN_NAMES
                 + ELASTIC_SPAN_NAMES + CONTROL_SPAN_NAMES if n in spans}
    accounted = {n: v for n, v in accounted.items() if v > 0.0}
    accounted_ms = sum(accounted.values())
    split = {}
    base = max(wall_ms, accounted_ms)
    if base > 0:
        split = {n: round(100.0 * v / base, 2)
                 for n, v in accounted.items()}
        if wall_ms > accounted_ms:
            split["unaccounted"] = round(
                100.0 * (wall_ms - accounted_ms) / base, 2)

    # device-time attribution: the profiled windows' device
    # split, rendered BESIDE the wall-clock split — summed over every
    # device_profile event on the stream (the on-demand/anomaly captures
    # plus the static window), with the per-window step ranges kept so a
    # reader can line a window up against the straggler table
    device = None
    if device_profiles:
        from .device import DEVICE_PHASES, split_of_event

        split_ms = {p: 0.0 for p in DEVICE_PHASES}
        window_ms = coll_ms = exposed_ms = 0.0
        by_op: dict = defaultdict(float)
        windows = []
        for ev in device_profiles:
            for phase, ms in split_of_event(ev).items():
                split_ms[phase] += ms
            window_ms += float(ev.get("window_ms", 0.0))
            exposed_ms += float(ev.get("comm_exposed_ms", 0.0))
            coll_ms += (float(ev.get("comm_exposed_ms", 0.0))
                        + float(ev.get("comm_hidden_ms", 0.0)))
            for op, ms in (ev.get("by_op_ms") or {}).items():
                by_op[op] += float(ms)
            windows.append({k: ev.get(k) for k in
                            ("start_step", "stop_step", "steps", "reason",
                             "trigger_step", "measured_mfu_pct")
                            if ev.get(k) is not None})
        device = {
            "profiles": len(device_profiles),
            "window_ms": round(window_ms, 3),
            "split_ms": {p: round(v, 3) for p, v in split_ms.items()},
            "split_pct": {p: round(100.0 * v / window_ms, 2)
                          for p, v in split_ms.items()} if window_ms
            else {},
            "exposed_comm_ratio": round(exposed_ms / coll_ms, 4)
            if coll_ms else 0.0,
            "by_op_ms": {op: round(v, 3)
                         for op, v in sorted(by_op.items())},
            "windows": windows,
        }

    # control-plane decisions: the audit trail the autopilot
    # leaves on the stream — every record kept in order so the summary
    # shows the full detect -> evict -> grow / retune -> refuse chain
    control = None
    if control_decisions:
        by_action: dict = defaultdict(int)
        for ev in control_decisions:
            by_action[str(ev.get("name", "?"))] += 1
        control = {
            "total": len(control_decisions),
            "by_action": dict(sorted(by_action.items())),
            "chain": [{("action" if k == "name" else k): ev.get(k)
                       for k in ("name", "rank", "epoch", "step",
                                 "world_from", "world_to", "applied",
                                 "reason")
                       if ev.get(k) is not None}
                      for ev in control_decisions],
        }

    partial_total = sum(partial_ms.values())
    partial_epoch = None
    if partial_steps or partial_total > 0.0:
        partial_epoch = {
            "steps": partial_steps,
            "span_ms": {n: round(v, 3)
                        for n, v in sorted(partial_ms.items())},
            "total_ms": round(partial_total, 3),
        }

    out = {
        "schema": (meta or {}).get("schema"),
        "run_id": (meta or {}).get("run_id"),
        "n_events": len(events),
        "spans": {n: {"total_ms": round(v["total_ms"], 3),
                      "count": v["count"],
                      "mean_ms": round(v["total_ms"] / v["count"], 4)
                      if v["count"] else 0.0,
                      "max_ms": round(v["max_ms"], 3)}
                  for n, v in sorted(spans.items())},
        "counters": {n: round(v, 4) for n, v in sorted(counters.items())},
        "gauges": dict(sorted(gauges.items())),
        "anomalies": [{"name": a.get("name"),
                       **{k: v for k, v in a.items()
                          if k not in ("v", "ts", "kind", "name")}}
                      for a in anomalies],
        "step_split_pct": split,
        "device": device,
        "control_decisions": control,
        "partial_epoch": partial_epoch,
        "totals": {
            "recorded_wall_ms": round(wall_ms, 3),
            "accounted_span_ms": round(accounted_ms, 3),
            "unaccounted_ms": round(max(0.0, wall_ms - accounted_ms), 3)
            if wall_ms > 0 else None,
        },
    }
    if counters.get("epoch_time_s", 0.0) > 0 and "samples" in counters:
        out["throughput"] = {
            "samples": counters["samples"],
            "samples_per_sec": round(
                counters["samples"] / counters["epoch_time_s"], 2),
        }
    for key in ("wire_bytes_per_replica", "fsdp_gather_bytes",
                "tp_psum_bytes_per_replica", "exposed_comm_pct"):
        if key in counters:
            out.setdefault("wire", {})[key] = counters[key]
        elif key in gauges:
            out.setdefault("wire", {})[key] = gauges[key]
    return out


def to_perfetto(events: List[dict]) -> dict:
    """Chrome trace-event JSON: spans as complete ("X") events on one
    host-telemetry track, anomalies/events as instants — timestamps are
    wall-clock microseconds so the spans align with a torch.profiler trace
    captured in the same run."""
    trace: List[dict] = []
    pid = None
    for ev in events:
        kind = ev.get("kind")
        if kind == "meta":
            pid = ev.get("pid", pid)
            continue
        args = {k: v for k, v in ev.items()
                if k not in ("v", "ts", "kind", "name", "t0", "dur_ms")}
        common = {"pid": ev.get("pid", pid) or 0, "tid": 1,
                  "cat": f"telemetry/{kind}", "name": ev.get("name", "?"),
                  "args": args}
        if kind == "span":
            t0 = float(ev.get("t0", ev.get("ts", 0.0)))
            trace.append({**common, "ph": "X", "ts": t0 * 1e6,
                          "dur": float(ev.get("dur_ms", 0.0)) * 1e3})
        else:
            trace.append({**common, "ph": "i", "s": "p",
                          "ts": float(ev.get("ts", 0.0)) * 1e6})
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def _print_summary(s: dict) -> None:
    print(f"run {s.get('run_id')} — {s['n_events']} events")
    if s["step_split_pct"]:
        print("step-time split (% of recorded wall):")
        for n, pct in sorted(s["step_split_pct"].items(),
                             key=lambda kv: -kv[1]):
            tot = s["spans"].get(n, {}).get("total_ms")
            extra = f"  ({tot:.1f} ms)" if tot is not None else ""
            print(f"  {n:16s} {pct:6.2f}%{extra}")
    t = s["totals"]
    if t["recorded_wall_ms"]:
        print(f"recorded wall: {t['recorded_wall_ms']:.1f} ms, spans "
              f"account for {t['accounted_span_ms']:.1f} ms")
    if "throughput" in s:
        print(f"throughput: {s['throughput']['samples_per_sec']:.2f} "
              f"samples/s over {s['throughput']['samples']:.0f} samples")
    if "wire" in s:
        for k, v in s["wire"].items():
            print(f"wire: {k} = {v}")
    if s.get("device"):
        d = s["device"]
        print(f"device-time split ({d['profiles']} profiled window(s), "
              f"{d['window_ms']:.1f} ms of device window):")
        for phase, pct in sorted(d["split_pct"].items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {phase:16s} {pct:6.2f}%  "
                  f"({d['split_ms'][phase]:.1f} ms)")
        print(f"  exposed-comm ratio: {d['exposed_comm_ratio']:.3f}")
        for op, ms in d["by_op_ms"].items():
            print(f"  collective: {op} = {ms:.1f} ms")
        for w in d["windows"]:
            rng = (f"steps {w.get('start_step')}-{w.get('stop_step')}"
                   if w.get("start_step") is not None else "untracked")
            trig = (f", trigger step {w['trigger_step']}"
                    if w.get("trigger_step") is not None else "")
            mfu = (f", measured MFU {w['measured_mfu_pct']:.1f}%"
                   if w.get("measured_mfu_pct") is not None else "")
            print(f"  window: {rng} ({w.get('reason', '?')}{trig}{mfu})")
    if s.get("control_decisions"):
        c = s["control_decisions"]
        acts = ", ".join(f"{a}={n}" for a, n in c["by_action"].items())
        print(f"control decisions ({c['total']}): {acts}")
        for d in c["chain"]:
            who = f" rank {d['rank']}" if d.get("rank") is not None else ""
            at = (f" @epoch {d['epoch']} step {d['step']}"
                  if d.get("step") is not None else "")
            world = (f" world {d['world_from']}->{d['world_to']}"
                     if d.get("world_to") is not None else "")
            applied = " [applied]" if d.get("applied") else ""
            print(f"  {d.get('action'):7s}{who}{at}{world}{applied}: "
                  f"{d.get('reason', '')}")
    if s.get("partial_epoch"):
        pe = s["partial_epoch"]
        phases = ", ".join(f"{n} {v:.1f}ms"
                           for n, v in pe["span_ms"].items())
        print(f"PARTIAL EPOCH (crash-truncated — no enclosing epoch "
              f"total): {pe['steps']} step(s), {pe['total_ms']:.1f} ms "
              f"({phases}) excluded from the split above")
    if s["anomalies"]:
        print(f"ANOMALIES ({len(s['anomalies'])}):")
        for a in s["anomalies"]:
            print(f"  {a}")


def _follow(stream: str, n: int, poll_s: float,
            timeout_s: Optional[float]) -> int:
    """``tail -f``: print the last N events, then poll the file for new
    ones — surviving rotation to a new stream file (the follower resets
    on inode change/truncation). Ctrl-C (or ``--follow-timeout``, the
    scriptable bound) ends the watch cleanly."""
    from .aggregate import StreamFollower

    follower = StreamFollower(stream)
    backlog = follower.poll()
    for ev in backlog[-n:]:
        print(json.dumps(ev, sort_keys=True))
    sys.stdout.flush()
    deadline = (time.monotonic() + timeout_s
                if timeout_s is not None else None)
    try:
        while deadline is None or time.monotonic() < deadline:
            for ev in follower.poll():
                print(json.dumps(ev, sort_keys=True))
            sys.stdout.flush()
            time.sleep(poll_s)
    except KeyboardInterrupt:
        pass
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="telemetry", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command",
                   choices=["summary", "aggregate", "tail", "export"])
    p.add_argument("streams", nargs="+",
                   help="telemetry JSONL stream path(s) — aggregate/"
                        "export merge several; summary/tail take one")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("-n", type=int, default=20, help="tail: last N events")
    p.add_argument("-f", "--follow", action="store_true",
                   help="tail: keep polling for new events (survives "
                        "stream rotation)")
    p.add_argument("--poll-s", type=float, default=0.5,
                   help="tail -f: poll interval seconds")
    p.add_argument("--follow-timeout", type=float, default=None,
                   help="tail -f: stop after this many seconds "
                        "(default: until Ctrl-C)")
    p.add_argument("--perfetto", action="store_true",
                   help="export: Chrome trace-event JSON")
    p.add_argument("-o", "--output", default=None,
                   help="export/aggregate: output path (default: stdout)")
    args = p.parse_args(argv)

    if args.command == "aggregate":
        from .aggregate import aggregate_streams, print_fleet_summary

        agg = aggregate_streams(args.streams)
        if agg["n_streams"] == 0:
            print("telemetry: no readable stream among "
                  f"{args.streams}", file=sys.stderr)
            return 1
        if args.output:
            # -o always writes the machine-readable body, whatever the
            # stdout format — a silently-ignored output path would strand
            # every script that reads it
            Path(args.output).write_text(json.dumps(agg, sort_keys=True))
            print(f"telemetry: wrote {args.output}", file=sys.stderr)
        if args.as_json:
            if not args.output:
                print(json.dumps(agg, sort_keys=True))
        else:
            print_fleet_summary(agg)
        return 0

    if args.command in ("summary", "tail") and len(args.streams) != 1:
        print(f"telemetry: {args.command} takes exactly one stream "
              "(aggregate merges several)", file=sys.stderr)
        return 2
    stream = args.streams[0]

    if args.command == "tail" and args.follow:
        # the follower tolerates a not-yet-created stream; no upfront check
        return _follow(stream, args.n, args.poll_s, args.follow_timeout)

    if args.command == "export" and len(args.streams) > 1:
        if not args.perfetto:
            print("telemetry: export needs --perfetto (the only format "
                  "so far)", file=sys.stderr)
            return 2
        from .aggregate import split_streams, stitch_perfetto

        segments = split_streams(args.streams)
        if not segments:
            print("telemetry: no readable stream among "
                  f"{args.streams}", file=sys.stderr)
            return 1
        body = json.dumps(stitch_perfetto(segments))
        if args.output:
            Path(args.output).write_text(body)
            print(f"telemetry: wrote {args.output}", file=sys.stderr)
        else:
            print(body)
        return 0

    if not Path(stream).is_file():
        print(f"telemetry: no such stream: {stream}", file=sys.stderr)
        return 1
    events, bad = read_stream(stream)
    if bad:
        print(f"telemetry: note: {bad} malformed line(s) skipped",
              file=sys.stderr)
    if not events:
        print("telemetry: stream holds no events", file=sys.stderr)
        return 1

    if args.command == "summary":
        s = summarize(events)
        if args.as_json:
            print(json.dumps(s, sort_keys=True))
        else:
            _print_summary(s)
        return 0
    if args.command == "tail":
        for ev in events[-args.n:]:
            print(json.dumps(ev, sort_keys=True))
        return 0
    # export
    if not args.perfetto:
        print("telemetry: export needs --perfetto (the only format so far)",
              file=sys.stderr)
        return 2
    body = json.dumps(to_perfetto(events))
    if args.output:
        Path(args.output).write_text(body)
        print(f"telemetry: wrote {args.output}", file=sys.stderr)
    else:
        print(body)
    return 0


if __name__ == "__main__":
    sys.exit(main())
