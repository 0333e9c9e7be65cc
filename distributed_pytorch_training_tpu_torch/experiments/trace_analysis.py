"""Gradient-sync share from ``torch.profiler`` traces (the JAX package's
``experiments/trace_analysis.py`` on the Chrome trace that
``utils/profiling.py`` writes, ``*.pt.trace.json``).

The reference README promises "At 4 GPUs, gradient synchronization
accounts for ~X% of step time" but never measures it; on the card one
reads it off a profiler timeline. The functions, their return keys and
their rounding are the JAX package's; what they read:

* **Device lanes.** On a trace of the card the device ops are the events
  of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; their ``pid``
  is the device and their ``tid`` the stream. A lane is one (device,
  stream) pair, and every per-pid union of the JAX accounting is a
  per-device union over all its streams (one device of one trace file).
* **Collectives on the card.** NCCL's kernels (``ncclDevKernel_<Op>_…``,
  ``ncclKernel_<Op>_…``), keyed onto the JAX package's ``by_op`` names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute`` for send/recv). Where the kernel runs inside
  ProcessGroupNCCL's ``nccl:<op>`` annotation on its stream, the
  annotation names the op (an all-to-all and a send/recv launch the same
  ``SendRecv`` kernel).
* **Collectives on the host.** gloo runs a collective on the host, even on
  CUDA tensors, in a ``gloo:<op>`` span of its worker thread, staging the
  tensors through pinned memory with copies on the card. Such a span
  counts as a collective interval of that process's device timeline
  (where the device works under it, ``comm_hidden``; elsewhere
  ``comm_exposed``, not ``host_gap``), and the copies it launched (matched
  to their launch by CUPTI's correlation id, launched inside the
  collective's ``gloo:`` span or its ``c10d::`` call) are the
  collective's own work, not compute.
* **CPU traces** (the tests' backend, and the CPU branch of the JAX
  reader): no device lanes; the host's operators are the ops. They nest
  (``aten::linear`` holds ``aten::addmm``), so only the outermost event of
  each nest counts (the union of a nest, no wall time twice), and the
  profiler's own bookkeeping (``ProfilerStep#…``, the ``[memory]``
  events, the session span) is dropped, as ``_INFRA_PREFIXES`` drops
  XLA's. The collectives are the ``c10d::`` calls and gloo's spans.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# the device-op categories of a CUDA trace (CUPTI's activities)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# NCCL's device kernels, as a trace of torch 2.11's NCCL on an H100 names
# them: "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<
# 4096ul>)", "ncclDevKernel_AllGather_RING_LL(...)",
# "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(...)",
# "ncclDevKernel_SendRecv(...)" (send/recv and all-to-all alike),
# "ncclDevKernel_Broadcast_RING_LL(...)"; older NCCLs' "ncclKernel_<Op>_..."
_NCCL_KERNEL_RE = re.compile(r"^(?:void\s+)?nccl(?:Dev)?Kernel_([A-Za-z]+)")
# host-side collective spans and calls: gloo's worker-thread span
# ("gloo:all_reduce"), ProcessGroupNCCL's annotation ("nccl:all_reduce",
# "nccl:_all_gather_base", "nccl:all_to_all", "nccl:send 0->1",
# "nccl:coalesced" for a batch of sends and receives), and the
# dispatcher's call ("c10d::allreduce_")
_HOST_COLLECTIVE_RE = re.compile(r"^(gloo|nccl):([a-z_]+)")
_C10D_RE = re.compile(r"^c10d::([a-z_]+?)_*$")

# one op name -> the JAX package's by_op key. NCCL's kernels are CamelCase
# (AllReduce), gloo's and nccl's annotations snake_case (all_reduce), the
# dispatcher's ops glued (allreduce); each is lowered and its separators
# dropped before the lookup
_OP_KEYS = {
    "allreduce": "all-reduce",
    "allgather": "all-gather",
    "allgatherintotensor": "all-gather",
    "allgatherbase": "all-gather",
    "reducescatter": "reduce-scatter",
    "reducescattertensor": "reduce-scatter",
    "reducescatterbase": "reduce-scatter",
    "alltoall": "all-to-all",
    "alltoallbase": "all-to-all",
    "sendrecv": "collective-permute",
    "send": "collective-permute",
    "recv": "collective-permute",
    "broadcast": "broadcast",
    "reduce": "reduce",
    "barrier": "barrier",
}

# the by_op keys of the JAX package's trace readers: an nccl: annotation
# renames the kernel inside it only to one of these (an all-to-all's
# SendRecv kernels), never to "coalesced" or "all-reduce-barrier"
_JAX_KEYS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

# the profiler's own bookkeeping on a CPU trace: neither compute nor
# communication (its [memory] and flow events are not complete events,
# so load_trace never returns them)
_INFRA_PREFIXES = ("ProfilerStep#",)
_INFRA_CATS = ("Trace", "overhead", "python_function", "cuda_runtime",
               "cuda_driver", "gpu_user_annotation")


def _op_key(op: str) -> str:
    """'AllReduce' / 'all_reduce' / 'allreduce_' -> 'all-reduce'; an op
    this table does not know keys as its own lowered name."""
    flat = op.lower().replace("_", "").replace("coalesced", "")
    return _OP_KEYS.get(flat, op.lower().strip("_").replace("_", "-"))


def collective_key(name: str) -> Optional[str]:
    """The by_op key of a collective's event name, or None for any other
    op: NCCL kernels, gloo's and nccl's spans, and ``c10d::`` calls."""
    m = _NCCL_KERNEL_RE.match(name)
    if m:
        return _op_key(m.group(1))
    m = _HOST_COLLECTIVE_RE.match(name)
    if m:
        return _op_key(m.group(2))
    m = _C10D_RE.match(name)
    if m:
        return _op_key(m.group(1))
    return None


def load_trace(log_dir: str) -> List[dict]:
    """The complete events of every ``*.pt.trace.json`` (or ``.json.gz``)
    under ``log_dir``, each with ``_file``, the index of its trace file
    (two processes' traces both call their card pid 0). Raises
    FileNotFoundError if no trace exists."""
    paths = sorted(
        glob.glob(str(Path(log_dir) / "**" / "*.pt.trace.json"),
                  recursive=True)
        + glob.glob(str(Path(log_dir) / "**" / "*.pt.trace.json.gz"),
                    recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {log_dir}")
    events: List[dict] = []
    for i, p in enumerate(paths):
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as f:
            data = json.load(f)
        for e in data.get("traceEvents", []):
            if e.get("ph") == "X" and e.get("dur", 0) > 0:
                e["_file"] = i
                events.append(e)
    return events


def _outermost(events: List[dict]) -> List[dict]:
    """The events no other event of the same thread contains (a nest's
    outermost op: its wall is the union of the nest). An event that starts
    inside another and outlasts it (spans that do not nest) keeps only
    its part past the other's end, so the union stays exact."""
    out: List[dict] = []
    by_thread: Dict[tuple, List[dict]] = {}
    for e in events:
        by_thread.setdefault((e["_file"], e.get("pid"), e.get("tid")),
                             []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        end = float("-inf")
        for e in evs:
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if t0 >= end:
                out.append(e)
            elif t1 > end:
                out.append(dict(e, ts=end, dur=t1 - end))
            end = max(end, t1)
    return out


def _within(spans: Dict[tuple, List[Tuple[float, float, str]]],
            where: tuple, t: float) -> Optional[str]:
    """The key of the span of thread ``where`` that holds instant ``t``."""
    ivs = spans.get(where)
    if not ivs:
        return None
    i = bisect.bisect_right(ivs, (t, float("inf"), "")) - 1
    if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
        return ivs[i][2]
    return None


def device_op_events(events: List[dict]) -> List[dict]:
    """The events that represent device op execution, counted ONCE, each
    with ``_lane`` (its device: (file, pid)) and ``_coll`` (its by_op key
    when it is a collective, else None).

    With device lanes (a CUDA trace): the kernels, copies and memsets, a
    collective by NCCL's kernel name (or the ``nccl:`` annotation around
    it on its stream) or, for a copy launched inside a gloo collective,
    by that collective; plus gloo's ``gloo:`` host spans, placed on the
    process's device (the lowest device pid of the trace file). Without
    (a CPU trace): the outermost host operators, bookkeeping dropped.
    Raises ValueError on a trace whose CUDA runtime launched kernels but
    which holds no kernel event (CUPTI recorded no device activity: no
    split is read off such a trace)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        if any(e.get("cat") == "cuda_runtime"
               and e.get("name") == "cudaLaunchKernel" for e in events):
            raise ValueError("the trace's CUDA runtime launched kernels but "
                             "it holds no kernel event (CUPTI recorded no "
                             "device activity)")
        host = [e for e in events
                if e.get("cat") not in _INFRA_CATS
                and not e["name"].startswith(_INFRA_PREFIXES)]
        out = []
        for e in _outermost(host):
            out.append(dict(e, _lane=(e["_file"], e.get("pid")),
                            _coll=collective_key(e["name"])))
        return out
    # host spans of the collectives gloo runs (and the calls that launch
    # its staging copies), per host thread, sorted by start
    host_spans: Dict[tuple, List[Tuple[float, float, str]]] = {}
    gloo: List[dict] = []
    for e in _outermost([
            e for e in events if e.get("cat") not in DEVICE_CATS
            and e.get("cat") != "gpu_user_annotation"
            and collective_key(e["name"]) is not None]):
        key = collective_key(e["name"])
        t0 = float(e["ts"])
        host_spans.setdefault((e["_file"], e.get("pid"), e.get("tid")),
                              []).append((t0, t0 + float(e["dur"]), key))
        if e["name"].startswith("gloo:"):
            gloo.append(e)
    for ivs in host_spans.values():
        ivs.sort()
    # the CUDA runtime call of each device op (CUPTI's correlation id)
    launch_at: Dict[tuple, Tuple[tuple, float]] = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[(e["_file"], corr)] = (
                    (e["_file"], e.get("pid"), e.get("tid")),
                    float(e["ts"]))
    # ProcessGroupNCCL's annotations on the card's streams
    nccl_spans: Dict[tuple, List[Tuple[float, float, str]]] = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and \
                e["name"].startswith("nccl:") and \
                collective_key(e["name"]) in _JAX_KEYS:
            t0 = float(e["ts"])
            nccl_spans.setdefault((e["_file"], e.get("pid"), e.get("tid")),
                                  []).append((t0, t0 + float(e["dur"]),
                                              collective_key(e["name"])))
    for ivs in nccl_spans.values():
        ivs.sort()
    out: List[dict] = []
    lanes_of_file: Dict[int, set] = {}
    for e in dev:
        lane = (e["_file"], e.get("pid"))
        lanes_of_file.setdefault(e["_file"], set()).add(e.get("pid"))
        key = collective_key(e["name"])
        if key is not None:
            t = float(e["ts"]) + float(e["dur"]) / 2
            key = _within(nccl_spans, (e["_file"], e.get("pid"),
                                       e.get("tid")), t) or key
        else:
            launch = launch_at.get((e["_file"],
                                    e.get("args", {}).get("correlation")))
            if launch is not None:
                key = _within(host_spans, *launch)
        out.append(dict(e, _lane=lane, _coll=key))
    for e in gloo:
        devices = lanes_of_file.get(e["_file"])
        if devices:
            out.append(dict(e, _lane=(e["_file"], min(devices)),
                            _coll=collective_key(e["name"])))
    return out


def collective_share(log_dir: str) -> dict:
    """Trace-derived gradient-sync share: collective time / device-op busy
    time.

    Returns {collective_us, op_us, share_pct, by_op: {name: us}} summed
    over every device op of the capture window (each op's own duration,
    as the JAX reader sums: NCCL's kernels and gloo's spans and staging
    copies are the collective part, every other kernel, copy and memset
    the rest; on a CPU trace, the outermost host operators).
    ``share_pct`` is the fraction of that time spent in communication —
    the number the reference's README placeholder wants.
    """
    ops = device_op_events(load_trace(log_dir))
    coll_us = 0.0
    op_us = 0.0
    by_op: Dict[str, float] = {}
    for e in ops:
        dur = float(e["dur"])
        op_us += dur
        key = e["_coll"]
        if key is not None:
            coll_us += dur
            by_op[key] = by_op.get(key, 0.0) + dur
    return {
        "collective_us": round(coll_us, 1),
        "op_us": round(op_us, 1),
        "share_pct": round(100.0 * coll_us / op_us, 2) if op_us else 0.0,
        "by_op": {k: round(v, 1) for k, v in sorted(by_op.items())},
    }


def _merge(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    ivs = sorted(ivs)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def comm_overlap_split(log_dir: str) -> dict:
    """Exposed-vs-hidden communication time from a torch.profiler trace —
    the overlap instrument of the bucketed reducer (DDP's hooks hide comm
    behind backward compute; this measures how much of the collectives'
    wall time the device's other work hid).

    A collective event's duration is HIDDEN where it overlaps (same
    device, any stream) with non-collective device ops, EXPOSED elsewhere
    (per event, as the JAX reader counts). On a CPU trace the ops are the
    host's, so the split measures host concurrency, not overlap on a
    device.

    Returns {collective_us, hidden_us, exposed_us, exposed_frac_pct}.
    """
    ops = device_op_events(load_trace(log_dir))
    comp_by_lane: Dict[tuple, List[Tuple[float, float]]] = {}
    coll = []
    for e in ops:
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e["_coll"] is not None:
            coll.append((e["_lane"], iv))
        else:
            comp_by_lane.setdefault(e["_lane"], []).append(iv)
    merged = {lane: _merge(ivs) for lane, ivs in comp_by_lane.items()}
    total = hidden = 0.0
    for lane, (a, b) in coll:
        total += b - a
        for ca, cb in merged.get(lane, ()):
            if cb <= a:
                continue
            if ca >= b:
                break
            hidden += min(b, cb) - max(a, ca)
    exposed = max(0.0, total - hidden)
    return {
        "collective_us": round(total, 1),
        "hidden_us": round(hidden, 1),
        "exposed_us": round(exposed, 1),
        "exposed_frac_pct": round(100.0 * exposed / total, 2) if total
        else 0.0,
    }


def device_time_split(log_dir: str) -> dict:
    """The four-way device-time attribution of one captured window (the
    number set telemetry/device.py turns into a typed ``device_profile``
    event):

    * ``compute_us`` — device busy time (kernels, copies, memsets) that is
      neither communication nor hidden under it,
    * ``comm_hidden_us`` — collective time (NCCL kernels; gloo's host
      spans and their staging copies) overlapping other device work on
      the same device,
    * ``comm_exposed_us`` — collective time nothing overlapped (the number
      that decides whether compressed sync paid off),
    * ``host_gap_us`` — wall extent of the device's activity minus its
      busy time (dispatch stalls, host waits, loader waits, host work).

    The four numbers are UNION wall measures per device (one device of one
    trace file, all its streams: compute-only wall, collective wall
    coinciding with compute, collective-only wall, idle wall), so
    ``compute + hidden + exposed + gap == window`` holds EXACTLY on any
    trace, overlapping streams and collectives included. ``by_op`` stays
    per-event op time. On a CPU trace (no device lanes) the lanes are the
    processes and the ops their outermost host operators, so the split
    measures host concurrency, not a device's.
    """
    ops = device_op_events(load_trace(log_dir))
    coll_by_lane: Dict[tuple, List[Tuple[float, float]]] = {}
    comp_by_lane: Dict[tuple, List[Tuple[float, float]]] = {}
    by_op: Dict[str, float] = {}
    for e in ops:
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        key = e["_coll"]
        if key is not None:
            coll_by_lane.setdefault(e["_lane"], []).append(iv)
            by_op[key] = by_op.get(key, 0.0) + (iv[1] - iv[0])
        else:
            comp_by_lane.setdefault(e["_lane"], []).append(iv)

    def _length(ivs: List[Tuple[float, float]]) -> float:
        return sum(b - a for a, b in ivs)

    def _intersect_len(xs: List[Tuple[float, float]],
                       ys: List[Tuple[float, float]]) -> float:
        total = 0.0
        i = j = 0
        while i < len(xs) and j < len(ys):
            a = max(xs[i][0], ys[j][0])
            b = min(xs[i][1], ys[j][1])
            if b > a:
                total += b - a
            if xs[i][1] <= ys[j][1]:
                i += 1
            else:
                j += 1
        return total

    window = compute = hidden = exposed = gap = coll_total = 0.0
    lanes = set(coll_by_lane) | set(comp_by_lane)
    for lane in lanes:
        comp = _merge(comp_by_lane.get(lane, []))
        coll = _merge(coll_by_lane.get(lane, []))
        every = _merge(comp + coll)
        if not every:
            continue
        extent = every[-1][1] - every[0][0]
        busy = _length(every)
        c_len, k_len = _length(comp), _length(coll)
        overlap = _intersect_len(comp, coll)
        window += extent
        compute += c_len - overlap
        hidden += overlap
        exposed += k_len - overlap
        gap += extent - busy
        coll_total += k_len
    return {
        "window_us": round(window, 1),
        "compute_us": round(compute, 1),
        "comm_hidden_us": round(hidden, 1),
        "comm_exposed_us": round(exposed, 1),
        "host_gap_us": round(gap, 1),
        "collective_us": round(coll_total, 1),
        "exposed_frac_pct": round(100.0 * exposed / coll_total, 2)
        if coll_total else 0.0,
        "by_op": {k: round(v, 1) for k, v in sorted(by_op.items())},
        "n_device_lanes": len(lanes),
    }


def top_device_ops(log_dir: str, n: int = 10) -> List[dict]:
    """The ``n`` device ops with the most total time in the window:
    [{name, launches, total_us, mean_us}], a kernel named without its
    return type and parameter list (``op_name``)."""
    totals: Dict[str, List[float]] = {}
    for e in load_trace(log_dir):
        if e.get("cat") in DEVICE_CATS:
            t = totals.setdefault(op_name(e["name"]), [0, 0.0])
            t[0] += 1
            t[1] += float(e["dur"])
    rows = sorted(totals.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"name": name, "launches": int(k), "total_us": round(us, 1),
             "mean_us": round(us / k, 3)} for name, (k, us) in rows]


def op_name(name: str, templates: bool = True) -> str:
    """A device op's name without its return type, ``(anonymous
    namespace)::`` qualifiers and parameter list, and without its
    template arguments unless ``templates``: ``void (anonymous
    namespace)::flash_fwd_bf16_kernel<64>(int)`` ->
    ``flash_fwd_bf16_kernel<64>``. A copy's or a memset's name
    (``Memset (Device)``) has no parameter list and is returned whole."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    out = []
    for i, ch in enumerate(name):
        opens = ch == "<"
        closes = ch == ">" and name[i - 1:i] != "-"   # not an arrow "->"
        if opens:
            depth += 1
        elif closes:
            depth -= 1
        elif depth == 0 and ch == "(" and i and name[i - 1] != " ":
            break
        if templates or (depth == 0 and not (opens or closes)):
            out.append(ch)
    return "".join(out).strip()


def kernel_base_name(name: str) -> str:
    """A kernel's base name, its template arguments dropped too (how a
    hand-written kernel is matched in a trace): ``void (anonymous
    namespace)::flash_fwd_bf16_kernel<64>(...)`` ->
    ``flash_fwd_bf16_kernel``."""
    return op_name(name, templates=False)


def capture_step_trace(step_fn, state, batch, steps: int, log_dir: str):
    """Run ``steps`` calls of a train step (``step_fn(state, batch)``, the
    port's ``Trainer.train_step``, which updates ``state`` in place) under
    a torch.profiler trace into ``log_dir`` (call AFTER warm-up so first-
    call costs stay out of the window), on the device of the state's
    parameters; on a CUDA device the window ends with
    ``torch.cuda.synchronize()``, so every kernel of its steps is inside
    it. Returns the state. Rides utils/profiling's session guard: a
    concurrently-open session refuses loudly instead of raising from
    inside torch."""
    from ..utils.profiling import trace_session

    device = state.params[0].device
    with trace_session(log_dir, owner="capture_step_trace",
                       device=device) as started:
        if not started:
            raise RuntimeError(
                "capture_step_trace: a profiler session is already open "
                "in this process — stop it (StepProfiler window / "
                "on-demand capture) before capturing a bench trace")
        for _ in range(steps):
            step_fn(state, batch)
    return state
