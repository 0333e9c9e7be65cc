"""Fleet aggregation: merge N telemetry streams into ONE view.

One stream is one process's view; runs are multi-process (ranks, fleet
generations), and the JAX package's are elastic (mid-run world resizes)
and 2-D sharded (per-axis wire tiers). This module is the cross-stream
half, a copy of the JAX package's (same input, same output):

* :func:`split_streams` — N JSONL paths -> per-``(gen, rank)``
  :class:`StreamSegment`\\ s. Segment-aware by necessity: fleet children
  of successive generations APPEND to the same ``telemetry_rank0.jsonl``
  (the recorder opens ``"a"``), so one file can hold several runs'
  events; every ``meta`` line starts a new segment, and each event's own
  ``gen``/``rank`` stamp (v2) resolves which run it belongs to. v1
  streams (no stamps) normalize to gen 0 / rank 0.
* :func:`aggregate_streams` — the fleet summary: per-(gen, rank)
  step-time/phase splits SIDE BY SIDE, wire-byte rollups by tier/axis
  (the DCN tier slots in as one more row, nothing here is tier-aware
  beyond grouping), anomaly rollup, and the straggler table.
* :func:`detect_stragglers` — per-step cross-rank attribution: for each
  (step, phase) the slowest stream is compared against its peers at the
  SAME step (or, when no peer ran that step — elastic runs overlap only
  partially — against the phase's own cross-fleet median), and a flagged
  straggler names the (gen, rank), the step, AND the phase that made it
  slow. A ``loader_stall`` chaos fault on one fleet child reads back as
  exactly that: data_wait, that child's gen/rank, that step.
* :func:`stitch_perfetto` — ONE Chrome trace-event timeline with a
  STABLE pid per (gen, rank) (sorted identity order, so re-exports are
  diffable), span tracks on tid 1 and gauge COUNTER tracks (``ph:"C"``)
  beside them.

Clock skew: streams come from different processes (and, at fleet scale,
different hosts), so wall clocks disagree. Every segment's own ``meta``
event is its anchor — cross-stream timelines and per-step comparisons use
``ts - anchor_ts`` (durations were always monotonic ``perf_counter``
pairs and need nothing). The merged timeline therefore OVERLAYS segments
at t=0, which is the comparison view the straggler story needs; absolute
wall time stays in each event's ``args``.

stdlib-only, like every reader in this package: summaries are read on
machines with no accelerator stack.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

# the per-step phases the straggler detector attributes (the two spans
# the train loop emits per step, with their `step` field)
STRAGGLER_PHASES = ("data_wait", "step_dispatch")


@dataclasses.dataclass
class StreamSegment:
    """One recorder lifetime: the events between a ``meta`` line and the
    next (or EOF), keyed by the (gen, rank) identity stamped on them."""

    gen: int
    rank: int
    path: str
    anchor_ts: float            # the meta event's wall clock: t=0
    run_id: Optional[str] = None
    pid: Optional[int] = None
    events: List[dict] = dataclasses.field(default_factory=list)

    @property
    def key(self) -> Tuple[int, int]:
        return (self.gen, self.rank)


def _identity_of(ev: dict) -> Tuple[int, int]:
    """(gen, rank) of one event; v1 events (no stamps) read as (0, 0)."""
    try:
        return (int(ev.get("gen", 0)), int(ev.get("rank", 0)))
    except (TypeError, ValueError):
        return (0, 0)


def split_streams(paths: Iterable, *, missing: Optional[List[str]] = None
                  ) -> List[StreamSegment]:
    """Read N stream files into per-(gen, rank) segments. Unreadable or
    empty paths are recorded in ``missing`` (when given) instead of
    raising — one dead rank must not hide the rest of the fleet."""
    from .__main__ import read_stream

    segments: List[StreamSegment] = []
    current: Optional[StreamSegment] = None
    for raw_path in paths:
        path = str(raw_path)
        try:
            events, _bad = read_stream(path)
        except OSError:
            events = []
        if not events:
            if missing is not None:
                missing.append(path)
            continue
        current = None
        for ev in events:
            if ev.get("kind") == "meta":
                gen, rank = _identity_of(ev)
                current = StreamSegment(
                    gen=gen, rank=rank, path=path,
                    anchor_ts=float(ev.get("ts", 0.0)),
                    run_id=ev.get("run_id"), pid=ev.get("pid"))
                current.events.append(ev)
                segments.append(current)
                continue
            if current is None:
                # a header lost to truncation/rotation: synthesize an
                # anchor from the first event so the tail still reads
                gen, rank = _identity_of(ev)
                current = StreamSegment(
                    gen=gen, rank=rank, path=path,
                    anchor_ts=float(ev.get("ts", 0.0)))
                segments.append(current)
            current.events.append(ev)
    return segments


# ---------------------------------------------------------------------------
# straggler / divergence detection
# ---------------------------------------------------------------------------


def detect_stragglers(segments: List[StreamSegment],
                      phases: Tuple[str, ...] = STRAGGLER_PHASES,
                      rel_factor: float = 5.0,
                      abs_floor_s: float = 0.25) -> List[dict]:
    """Cross-rank per-step attribution: flag (gen, rank, step, phase)
    where one stream's span ran ``rel_factor`` x slower than its peers'
    median at the SAME step AND above ``abs_floor_s`` (microsecond noise
    at CPU-mesh step times must not read as divergence). Steps no peer
    ran — elastic fleets overlap only partially — fall back to the
    phase's own cross-fleet median, so a stall in a solo segment is still
    named. Each segment's FIRST ``step_dispatch`` is exempt: a relaunch's
    first dispatch is compile-dominated by construction (the watchdog's
    warm-up rule, applied cross-stream) and naming every generation's
    cold start a straggler would bury the real ones. Sorted worst-first
    by excess duration.

    Device attribution: when the flagged segment carries a
    ``device_profile`` event covering the flagged step (the window
    contains it, or the capture was anomaly-TRIGGERED by it —
    telemetry/device.covers_step), the straggler row gains a ``device``
    block: the captured split, the dominant collective op, and — when
    OTHER segments profiled too — the exposed-comm factor vs the fleet
    median ("rank 3 slow at step 12: exposed all-reduce 4.1x fleet
    median"). Span-based attribution is unchanged and remains the
    fallback when no capture overlapped."""
    # (phase, step) -> [(dur_s, segment)]
    by_step: Dict[Tuple[str, int], List[Tuple[float, StreamSegment]]] = \
        defaultdict(list)
    phase_all: Dict[str, List[float]] = defaultdict(list)
    profiles: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
    for seg in segments:
        seen_dispatch = False
        for ev in seg.events:
            if ev.get("kind") == "device_profile":
                profiles[seg.key].append(ev)
                continue
            if ev.get("kind") != "span" or ev.get("name") not in phases:
                continue
            if ev["name"] == "step_dispatch" and not seen_dispatch:
                seen_dispatch = True   # the compile-carrying cold start
                continue
            dur_s = float(ev.get("dur_ms", 0.0)) / 1e3
            phase_all[ev["name"]].append(dur_s)
            step = ev.get("step")
            if step is None:
                continue
            by_step[(ev["name"], int(step))].append((dur_s, seg))

    out: List[dict] = []
    for (phase, step), entries in by_step.items():
        dur_s, seg = max(entries, key=lambda e: e[0])
        peers = [d for d, s in entries if s is not seg]
        if peers:
            baseline = statistics.median(peers)
            basis = "peers_at_step"
        else:
            others = [d for d in phase_all[phase]]
            if len(others) < 4:   # nothing credible to compare against
                continue
            baseline = statistics.median(others)
            basis = "phase_median"
        if dur_s > abs_floor_s and dur_s > rel_factor * max(baseline, 1e-9):
            row = {
                "gen": seg.gen, "rank": seg.rank, "step": step,
                "phase": phase,
                "dur_s": round(dur_s, 4),
                "baseline_s": round(baseline, 6),
                "factor": round(dur_s / max(baseline, 1e-9), 1),
                "basis": basis, "peers": len(peers),
            }
            device = _device_attribution(profiles, seg.key, step)
            if device is not None:
                row["device"] = device
            out.append(row)
    out.sort(key=lambda s: -(s["dur_s"] - s["baseline_s"]))
    return out


def _device_attribution(profiles: Dict[Tuple[int, int], List[dict]],
                        key: Tuple[int, int], step: int) -> Optional[dict]:
    """The straggler row's device block: the flagged segment's covering
    profile, plus the exposed-comm factor vs the fleet median of the
    OTHER segments' profiles (when any exist to compare against)."""
    from .device import covers_step, split_of_event

    mine = next((p for p in profiles.get(key, ())
                 if covers_step(p, step)), None)
    if mine is None:
        return None
    split = split_of_event(mine)
    by_op = mine.get("by_op_ms") or {}
    device = {
        "split_ms": {p: round(v, 3) for p, v in split.items()},
        "window_ms": round(float(mine.get("window_ms", 0.0)), 3),
        "exposed_comm_ratio": mine.get("exposed_comm_ratio"),
        "reason": mine.get("reason"),
        "trigger_step": mine.get("trigger_step"),
    }
    if by_op:
        device["dominant_op"] = max(by_op, key=lambda k: by_op[k])
    peer_exposed = [float(p.get("comm_exposed_ms", 0.0))
                    for k, plist in profiles.items() if k != key
                    for p in plist]
    if peer_exposed:
        med = statistics.median(peer_exposed)
        if med > 0:
            device["exposed_vs_fleet_median"] = round(
                split["comm_exposed"] / med, 1)
        # med == 0 (peers fully hidden their comm): a ratio would be
        # meaningless noise — the absolute split above is the evidence
    return device


# ---------------------------------------------------------------------------
# the fleet summary
# ---------------------------------------------------------------------------


def aggregate_streams(paths: Iterable, *, rel_factor: float = 5.0,
                      abs_floor_s: float = 0.25) -> dict:
    """Merge N stream FILES (across ranks AND generations) into one
    fleet summary — the path-taking wrapper over
    :func:`aggregate_segments` (callers that also stitch a trace split
    once and pass the segments to both, instead of re-parsing)."""
    missing: List[str] = []
    segments = split_streams(paths, missing=missing)
    return aggregate_segments(segments, missing=missing,
                              rel_factor=rel_factor,
                              abs_floor_s=abs_floor_s)


def aggregate_segments(segments: List[StreamSegment], *,
                       missing: Optional[List[str]] = None,
                       rel_factor: float = 5.0,
                       abs_floor_s: float = 0.25) -> dict:
    """The fleet summary body: per-(gen, rank) phase splits side by
    side, wire-byte rollups by (counter, tier, axis), anomaly rollup,
    stragglers."""
    from .__main__ import summarize

    missing = missing if missing is not None else []
    streams: List[dict] = []
    wire: Dict[Tuple[str, str, str], float] = defaultdict(float)
    anomalies: List[dict] = []
    total_steps = 0.0
    for seg in sorted(segments, key=lambda s: s.key):
        s = summarize(seg.events)
        total_steps += s["counters"].get("steps", 0.0)
        streams.append({
            "gen": seg.gen, "rank": seg.rank, "run_id": seg.run_id,
            "path": seg.path, "n_events": len(seg.events),
            "schema": s.get("schema"),
            "step_split_pct": s["step_split_pct"],
            "steps": s["counters"].get("steps", 0.0),
            "recorded_wall_ms": s["totals"]["recorded_wall_ms"],
            "accounted_span_ms": s["totals"]["accounted_span_ms"],
            "partial_epoch": s.get("partial_epoch"),
            "anomaly_count": len(s["anomalies"]),
            # the device-time split beside the wall-clock one
            "device": s.get("device"),
        })
        for ev in seg.events:
            kind = ev.get("kind")
            if kind == "counter" and ("tier" in ev or "axis" in ev):
                key = (ev.get("name", "?"), str(ev.get("tier", "")),
                       str(ev.get("axis", "")))
                wire[key] += float(ev.get("value", 0.0))
            elif kind == "anomaly":
                anomalies.append({
                    "gen": seg.gen, "rank": seg.rank,
                    "name": ev.get("name", "?"),
                    **{k: v for k, v in ev.items()
                       if k not in ("v", "ts", "kind", "name", "gen",
                                    "rank")}})
    stragglers = detect_stragglers(segments, rel_factor=rel_factor,
                                   abs_floor_s=abs_floor_s)
    return {
        "kind": "fleet_summary",
        "n_streams": len(segments),
        "identities": sorted({seg.key for seg in segments}),
        "streams": streams,
        "total_steps": total_steps,
        "wire": [{"name": n, "tier": t, "axis": a, "total": round(v, 4)}
                 for (n, t, a), v in sorted(wire.items())],
        "anomalies": anomalies,
        "stragglers": stragglers,
        "missing_streams": missing,
    }


def print_fleet_summary(agg: dict) -> None:
    print(f"fleet: {agg['n_streams']} stream segment(s) across "
          f"{len(agg['identities'])} (gen, rank) identit(ies)")
    for s in agg["streams"]:
        split = " ".join(f"{n}={p:.1f}%" for n, p in
                         sorted(s["step_split_pct"].items(),
                                key=lambda kv: -kv[1]))
        partial = ""
        if s.get("partial_epoch"):
            partial = (f"  [PARTIAL EPOCH: "
                       f"{s['partial_epoch']['steps']} step(s)]")
        print(f"  gen={s['gen']} rank={s['rank']}: "
              f"{s['steps']:.0f} steps, wall "
              f"{s['recorded_wall_ms']:.0f}ms — {split}{partial}")
        if s.get("device"):
            d = s["device"]
            dev_split = " ".join(
                f"{n}={p:.1f}%" for n, p in
                sorted(d["split_pct"].items(), key=lambda kv: -kv[1]))
            print(f"    device ({d['profiles']} window(s), "
                  f"{d['window_ms']:.0f}ms): {dev_split} "
                  f"exposed_ratio={d['exposed_comm_ratio']:.3f}")
    for w in agg["wire"]:
        tier = f" tier={w['tier']}" if w["tier"] else ""
        axis = f" axis={w['axis']}" if w["axis"] else ""
        print(f"  wire: {w['name']}{tier}{axis} = {w['total']}")
    if agg["anomalies"]:
        print(f"  ANOMALIES ({len(agg['anomalies'])}):")
        for a in agg["anomalies"]:
            print(f"    gen={a['gen']} rank={a['rank']} {a['name']} "
                  + " ".join(f"{k}={v}" for k, v in a.items()
                             if k not in ("gen", "rank", "name")))
    if agg["stragglers"]:
        print(f"  STRAGGLERS ({len(agg['stragglers'])}):")
        for s in agg["stragglers"]:
            print(f"    gen={s['gen']} rank={s['rank']} step={s['step']} "
                  f"{s['phase']} {s['dur_s']:.3f}s "
                  f"({s['factor']}x {s['basis']})")
            if s.get("device"):
                d = s["device"]
                vs = (f" {d['exposed_vs_fleet_median']}x fleet median"
                      if "exposed_vs_fleet_median" in d else "")
                op = (f" {d['dominant_op']}" if "dominant_op" in d else "")
                print(f"      device: exposed{op} "
                      f"{d['split_ms']['comm_exposed']:.1f}ms{vs} "
                      f"(compute {d['split_ms']['compute']:.1f}ms, "
                      f"host gap {d['split_ms']['host_gap']:.1f}ms; "
                      f"capture: {d.get('reason', '?')})")
    for path in agg["missing_streams"]:
        print(f"  note: unreadable/empty stream skipped: {path}")


# ---------------------------------------------------------------------------
# trace stitching: N streams -> one Perfetto timeline
# ---------------------------------------------------------------------------


def stitch_perfetto(segments: List[StreamSegment]) -> dict:
    """One Chrome trace-event JSON over every segment: exactly one pid
    per (gen, rank) — STABLE (sorted identity order), named via metadata
    events — spans as ``ph:"X"`` on tid 1, gauges as counter tracks
    (``ph:"C"``), everything skew-normalized to its own segment's meta
    anchor so streams from skewed host clocks overlay comparably."""
    identities = sorted({seg.key for seg in segments})
    pid_of = {key: i + 1 for i, key in enumerate(identities)}
    trace: List[dict] = []
    for (gen, rank), pid in sorted(pid_of.items(), key=lambda kv: kv[1]):
        trace.append({"ph": "M", "pid": pid, "tid": 1,
                      "name": "process_name",
                      "args": {"name": f"gen{gen}/rank{rank}"}})
    for seg in segments:
        pid = pid_of[seg.key]
        for ev in seg.events:
            kind = ev.get("kind")
            if kind == "meta":
                continue
            rel_us = (float(ev.get("ts", seg.anchor_ts))
                      - seg.anchor_ts) * 1e6
            args = {k: v for k, v in ev.items()
                    if k not in ("v", "ts", "kind", "name", "t0",
                                 "dur_ms", "gen", "rank")}
            args["wall_ts"] = ev.get("ts")
            common = {"pid": pid, "tid": 1,
                      "cat": f"telemetry/{kind}",
                      "name": ev.get("name", "?"), "args": args}
            if kind == "span":
                t0 = float(ev.get("t0", ev.get("ts", seg.anchor_ts)))
                trace.append({**common, "ph": "X",
                              "ts": (t0 - seg.anchor_ts) * 1e6,
                              "dur": float(ev.get("dur_ms", 0.0)) * 1e3})
            elif kind == "gauge":
                try:
                    value = float(ev.get("value", 0.0))
                except (TypeError, ValueError):
                    continue
                trace.append({"ph": "C", "pid": pid,
                              "name": ev.get("name", "?"), "ts": rel_us,
                              "args": {"value": value}})
            elif kind == "device_profile":
                # the device split beside the host spans: one X event on
                # tid 2 spanning the captured window (the event's ts is
                # ingestion time — just after the window closed, so the
                # window is drawn ending there)
                window_us = float(ev.get("window_ms", 0.0)) * 1e3
                trace.append({**common, "tid": 2, "ph": "X",
                              "ts": rel_us - window_us,
                              "dur": window_us})
            else:
                trace.append({**common, "ph": "i", "s": "p",
                              "ts": rel_us})
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# StreamFollower: incremental JSONL reads (tail -f, the fleet's live tail)
# ---------------------------------------------------------------------------


class StreamFollower:
    """Poll a JSONL stream for new events, surviving rotation.

    Tracks a byte offset and the file's inode: a shrink or an inode
    change means the stream was rotated/replaced, and the follower
    restarts from the new file's beginning instead of wedging at a stale
    offset. Partial trailing lines (the writer mid-append) stay buffered
    until their newline lands. Missing files poll as empty — a follower
    may be armed before its child process first emits.

    ``start_at_end=True`` skips whatever the file holds AT ARM TIME (the
    fleet orchestrator's per-child watch: previous generations appended
    to the same file, and their events are not this child's progress).
    The snapshot is taken in the constructor, not at the first poll — a
    file created AFTER arming has no backlog, and everything the new
    child writes is seen from its first byte. A later rotation still
    restarts from byte 0: a fresh file is all new content."""

    def __init__(self, path, start_at_end: bool = False):
        self.path = Path(path)
        self._pos = 0
        self._ino: Optional[int] = None
        self._carry = b""
        self.n_malformed = 0
        if start_at_end:
            try:
                st = os.stat(self.path)
                self._pos = st.st_size
                self._ino = st.st_ino
            except OSError:
                pass   # nothing exists yet: nothing to skip

    def poll(self) -> List[dict]:
        try:
            st = os.stat(self.path)
        except OSError:
            return []
        if self._ino is not None and (st.st_ino != self._ino
                                      or st.st_size < self._pos):
            self._pos = 0          # rotated or truncated: start over
            self._carry = b""
        self._ino = st.st_ino
        if st.st_size <= self._pos:
            return []
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                chunk = f.read()
        except OSError:
            return []
        self._pos += len(chunk)
        data = self._carry + chunk
        head, sep, tail = data.rpartition(b"\n")
        if not sep:
            self._carry = data     # no complete line yet
            return []
        self._carry = tail
        events: List[dict] = []
        for line in head.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line.decode("utf-8"))
                if not isinstance(ev, dict):
                    raise ValueError("not an object")
                events.append(ev)
            except (ValueError, UnicodeDecodeError):
                self.n_malformed += 1
        return events


def last_step_of(events: Iterable[dict], prior: int = -1,
                 gen: Optional[int] = None) -> int:
    """The largest `step` seen on a step_dispatch span (the step fence's
    observable) — the fleet orchestrator's live-progress probe. ``gen``
    restricts to events stamped with that generation: on the shared
    appended stream a previous generation's spans must not read as THIS
    child's progress (v1 events, unstamped, count only when gen is
    None or 0)."""
    best = prior
    for ev in events:
        if ev.get("kind") == "span" and ev.get("name") == "step_dispatch":
            if gen is not None and _identity_of(ev)[0] != gen:
                continue
            try:
                best = max(best, int(ev.get("step", -1)))
            except (TypeError, ValueError):
                continue
    return best
