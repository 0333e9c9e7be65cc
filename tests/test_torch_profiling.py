"""The port's ``utils/profiling.py`` (``torch.profiler``, the CPU activity
only here): the static ``--profile-steps`` window, the session guard and
its ``profiler_busy`` counter, an armed K-step capture, ``close()`` in
the middle of a window, ``on_capture`` ingestion into a
``device_profile`` event, and a rank other than 0 capturing nothing. The
JAX package's StepProfiler contract (tests/test_device_profile.py), on
the port."""

import glob
import os

import pytest
import torch

from distributed_pytorch_training_tpu_torch import telemetry
from distributed_pytorch_training_tpu_torch.experiments import (
    trace_analysis as ta,
)
from distributed_pytorch_training_tpu_torch.telemetry import device
from distributed_pytorch_training_tpu_torch.utils import profiling
from distributed_pytorch_training_tpu_torch.utils.profiling import (
    StepProfiler,
    trace_session,
)
from _torch_rig import port_process_state  # noqa: F401


def traces(d):
    return sorted(glob.glob(os.path.join(str(d), "**", "*.pt.trace.json"),
                            recursive=True))


def run(prof, steps):
    """Drive ``steps`` step-hook calls with a little host work each."""
    x = torch.ones(64, 64)
    for i in range(steps):
        prof(i)
        x = torch.tanh(x @ x / 64)


@pytest.fixture
def stream():
    return telemetry.configure(None)


def test_static_window_writes_one_trace(tmp_path, stream):
    seen = []
    prof = StepProfiler(str(tmp_path), 2, 4,
                        on_capture=lambda d, info: seen.append((d, info)))
    with prof:
        run(prof, 6)
    assert len(traces(tmp_path)) == 1
    assert seen == [(str(tmp_path), {"start_step": 2, "stop_step": 4,
                                     "steps": 2, "reason": "window",
                                     "trigger_step": None})]
    assert profiling.session_owner() is None
    split = ta.device_time_split(str(tmp_path))
    assert split["window_us"] > 0 and split["n_device_lanes"] == 1


def test_second_session_is_refused_with_a_counter(tmp_path, stream):
    prof = StepProfiler(str(tmp_path / "a"), 0, 3)
    prof(0)                                 # the window's session is open
    assert profiling.session_owner() == "StepProfiler.window"
    with trace_session(str(tmp_path / "b")) as started:
        assert started is False
    assert prof.request_capture(2) is False
    assert prof.busy_refused == 1
    with prof.capture("mid") as d:
        assert d is None
    prof.close()
    assert traces(tmp_path / "b") == []
    busy = [ev for ev in stream.tail(50) if ev["name"] == "profiler_busy"]
    assert [ev["wanted"] for ev in busy] == ["trace_session", "http", "mid"]
    with trace_session(str(tmp_path / "c")) as started:   # free again
        assert started is True
    assert len(traces(tmp_path / "c")) == 1


def test_armed_capture_of_k_steps(tmp_path, stream):
    seen = []
    prof = StepProfiler(str(tmp_path),
                        on_capture=lambda d, info: seen.append((d, info)))
    run(prof, 2)
    assert prof.request_capture(3, reason="http") is True
    assert prof.request_capture(1) is False   # one armed window at a time
    for i in range(2, 8):
        prof(i + 10)                          # global step labels
    prof.close()
    (d, info), = seen
    assert os.path.basename(d) == f"capture_{os.getpid()}_000"
    assert info == {"start_step": 12, "stop_step": 15, "steps": 3,
                    "reason": "http", "trigger_step": None}
    assert len(traces(d)) == 1


def test_close_in_the_middle_of_a_window(tmp_path, stream):
    seen = []
    prof = StepProfiler(str(tmp_path), 1, 10,
                        on_capture=lambda d, info: seen.append(info))
    run(prof, 4)                          # the window opened at step 1
    prof.close()
    assert seen == [{"start_step": 1, "stop_step": 4, "steps": 3,
                     "reason": "window", "trigger_step": None}]
    assert len(traces(tmp_path)) == 1
    assert profiling.session_owner() is None
    prof.close()                          # idempotent
    assert len(seen) == 1


def test_on_capture_emits_a_device_profile_event(tmp_path, stream):
    prof = StepProfiler(str(tmp_path), 1, 3,
                        on_capture=device.make_ingestor(
                            mfu_ref=lambda: (1e12, 1e15)))
    with prof:
        run(prof, 4)
    ev, = [e for e in stream.tail(50) if e["kind"] == "device_profile"]
    assert (ev["start_step"], ev["stop_step"], ev["steps"]) == (1, 3, 2)
    assert device.covers_step(ev, 2) and not device.covers_step(ev, 3)
    split = device.split_of_event(ev)
    assert abs(sum(split.values()) - ev["window_ms"]) < 1e-3
    # 2 steps of 1e12 FLOPs over the window at 1e15 FLOP/s
    assert ev["window_ms"] > 0 and ev["measured_mfu_pct"] == round(
        100 * 2e12 / (1e15 * ev["window_ms"] / 1e3), 2)
    assert ev["trace_dir"] == str(tmp_path)


def test_other_ranks_capture_nothing(tmp_path, stream, monkeypatch):
    monkeypatch.setattr(profiling, "_process_index", lambda: 1)
    seen = []
    prof = StepProfiler(str(tmp_path), 0, 2,
                        on_capture=lambda d, info: seen.append(info))
    assert prof.request_capture(2) is False
    with prof:
        run(prof, 4)
    assert seen == [] and traces(tmp_path) == []
    assert profiling.session_owner() is None


def test_window_arguments_are_checked(tmp_path):
    with pytest.raises(ValueError, match="both start and stop"):
        StepProfiler(str(tmp_path), 3, None)
    with pytest.raises(ValueError, match="stop > start"):
        StepProfiler(str(tmp_path), 3, 3)


def test_capture_step_trace_runs_steps_under_the_guard(tmp_path):
    """`capture_step_trace`: the port's train step, ``steps`` times, under
    one session (on the CPU: the host's operators); a second session at
    the same time raises instead of reaching torch."""
    from _torch_rig import rig

    trainer, state_factory, make_loader = rig("gpt2", n=8, batch=4)
    state = state_factory()
    batch = next(iter(make_loader().epoch(0)))
    out = ta.capture_step_trace(trainer.train_step, state, batch, 2,
                                str(tmp_path / "a"))
    assert out is state and state.step == 2
    assert len(traces(tmp_path / "a")) == 1
    assert ta.device_time_split(str(tmp_path / "a"))["window_us"] > 0
    with trace_session(str(tmp_path / "b")) as started:
        assert started
        with pytest.raises(RuntimeError, match="already open"):
            ta.capture_step_trace(trainer.train_step, state, batch, 1,
                                  str(tmp_path / "c"))
    assert state.step == 2 and traces(tmp_path / "c") == []
