"""Device-split ingestion: captured traces -> typed telemetry.

The host-side spans can say WHICH rank was slow and in WHICH phase, but
not what the device was doing. This module closes that gap: whenever
utils/profiling.StepProfiler finishes a capture (the static
``--profile-steps`` window, a ``POST /profile`` on-demand window, or an
anomaly-triggered one), the trace is
parsed through the experiments/trace_analysis machinery
(:func:`~..experiments.trace_analysis.device_time_split`, which reads
``torch.profiler``'s Chrome trace: the card's kernel, memcpy and memset
lanes, NCCL's kernels and gloo's host spans as collectives) into ONE
``device_profile`` event on the stream, the JAX package's event:

* per-phase device milliseconds — ``compute`` / ``comm_hidden`` /
  ``comm_exposed`` / ``host_gap`` — whose sum is the captured window (the
  self-consistency the acceptance test pins);
* per-collective-op rollups (``by_op_ms``: all-reduce vs all-gather vs
  reduce-scatter time);
* ``exposed_comm_ratio`` — exposed / total collective time, the number
  that decides whether compressed gradient sync paid off;
* measured MFU when the caller provides a FLOPs reference (train.py wires
  the Trainer's MFU reference: ``experiments/flops.py``'s per-sample
  FLOPs and the card's peak, ``Trainer.set_mfu_reference``).

The event is gen/rank-stamped like every other (the recorder does that),
so ``telemetry aggregate``'s straggler detector can device-attribute a
flagged rank when a capture overlapped the flagged step, and the live
``/metrics`` observer folds it into ``dpt_device_seconds{phase=...}`` /
``dpt_exposed_comm_ratio`` without extra wiring.

Ingestion is observability: every failure path here logs and returns —
a torn trace, a missing capture, a parse error must never take the
training run down. Imports of the trace parser are lazy so this module
(and the telemetry package) stays importable on stdlib-only readers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from . import recorder as _recorder

# The event kind + the four phase keys (readers — summary, aggregate,
# metrics_http — key on these; one definition).
DEVICE_PROFILE_KIND = "device_profile"
DEVICE_PHASES = ("compute", "comm_hidden", "comm_exposed", "host_gap")

# type of the optional MFU reference: () -> (flops_per_step, peak_flops_total)
MfuRef = Callable[[], Optional[Tuple[float, float]]]


def analyze_capture(trace_dir: str) -> Optional[Dict[str, Any]]:
    """Parse one captured trace directory into the device split, or None
    (logged) when no trace exists / parsing fails."""
    try:
        from ..experiments.trace_analysis import device_time_split

        return device_time_split(trace_dir)
    except FileNotFoundError:
        # legitimate: process != 0, or a capture window that closed
        # before the profiler flushed — nothing to ingest
        return None
    except Exception as e:  # noqa: BLE001 — ingestion is observability
        print(f"telemetry: device-split parse of {trace_dir} failed: {e}",
              flush=True)
        return None


def profile_event_fields(split: Dict[str, Any], info: Dict[str, Any],
                         mfu_ref: Optional[MfuRef] = None
                         ) -> Dict[str, Any]:
    """The ``device_profile`` event body from one parsed split + the
    profiler's window info (start/stop step, reason, trigger)."""
    window_ms = split["window_us"] / 1e3
    coll_ms = split["collective_us"] / 1e3
    fields: Dict[str, Any] = {
        "start_step": info.get("start_step"),
        "stop_step": info.get("stop_step"),
        "steps": info.get("steps"),
        "reason": info.get("reason", "?"),
        "trigger_step": info.get("trigger_step"),
        "window_ms": round(window_ms, 4),
        "compute_ms": round(split["compute_us"] / 1e3, 4),
        "comm_hidden_ms": round(split["comm_hidden_us"] / 1e3, 4),
        "comm_exposed_ms": round(split["comm_exposed_us"] / 1e3, 4),
        "host_gap_ms": round(split["host_gap_us"] / 1e3, 4),
        "exposed_comm_ratio": round(
            split["comm_exposed_us"] / split["collective_us"], 4)
        if split["collective_us"] else 0.0,
        "comm_share_pct": round(100.0 * coll_ms / window_ms, 2)
        if window_ms else 0.0,
        "by_op_ms": {k: round(v / 1e3, 4)
                     for k, v in split["by_op"].items()},
        "n_device_lanes": split["n_device_lanes"],
    }
    steps = info.get("steps")
    if mfu_ref is not None and steps and window_ms > 0:
        try:
            ref = mfu_ref()
        except Exception:  # noqa: BLE001 — the reference is a nicety
            ref = None
        if ref:
            flops_per_step, peak_total = ref
            if flops_per_step and peak_total:
                fields["measured_mfu_pct"] = round(
                    100.0 * flops_per_step * steps
                    / (peak_total * window_ms / 1e3), 2)
    return fields


def ingest_capture(trace_dir: str, info: Dict[str, Any],
                   mfu_ref: Optional[MfuRef] = None
                   ) -> Optional[Dict[str, Any]]:
    """Parse + emit one capture. Returns the emitted fields (tests), or
    None when there was nothing to ingest. Never raises."""
    split = analyze_capture(trace_dir)
    if split is None:
        return None
    fields = profile_event_fields(split, info, mfu_ref=mfu_ref)
    fields["trace_dir"] = str(trace_dir)
    _recorder.emit(DEVICE_PROFILE_KIND, "device_profile", **fields)
    return fields


def make_ingestor(mfu_ref: Optional[MfuRef] = None
                  ) -> Callable[[str, Dict[str, Any]], None]:
    """The ``StepProfiler(on_capture=...)`` callback: close over the
    optional MFU reference (train.py passes a lazy Trainer read — the
    reference is set after the profiler is constructed)."""

    def _ingest(trace_dir: str, info: Dict[str, Any]) -> None:
        ingest_capture(trace_dir, info, mfu_ref=mfu_ref)

    return _ingest


def split_of_event(ev: Dict[str, Any]) -> Dict[str, float]:
    """{phase: ms} of one ``device_profile`` event (reader helper —
    summary/aggregate/metrics all bucket through this one mapping)."""
    return {"compute": float(ev.get("compute_ms", 0.0)),
            "comm_hidden": float(ev.get("comm_hidden_ms", 0.0)),
            "comm_exposed": float(ev.get("comm_exposed_ms", 0.0)),
            "host_gap": float(ev.get("host_gap_ms", 0.0))}


def covers_step(ev: Dict[str, Any], step: int) -> bool:
    """Does this profile attribute the given step? True when the window
    [start_step, stop_step) contains it OR the capture was TRIGGERED by
    the anomaly at that step (an anomaly-armed window records the steps
    immediately after its trigger — that capture is the device-side
    evidence for the triggering step, and refusing to associate them
    would strand exactly the trace the trigger existed to record)."""
    if ev.get("trigger_step") == step:
        return True
    start, stop = ev.get("start_step"), ev.get("stop_step")
    try:
        return start is not None and stop is not None \
            and int(start) <= int(step) < int(stop)
    except (TypeError, ValueError):
        return False
