"""The port's fault tolerance (``resilience/faults.py``,
``resilience/supervisor.py``, ``training/preemption.py``) against the JAX
package's.

* ``FaultPlan.parse`` gives the JAX plan, field by field, for every kind,
  trigger, ``:Ns`` argument and ``xK`` repeat, and refuses the same
  malformed specs with the same messages; ``RetryPolicy.delay_s`` is the
  JAX policy's for the same seed and index;
* the injector fires once (or its repeat count); ``loader_stall`` leaves
  the batches unchanged, and the loader hook sees the resume offset;
* ``PreemptionGuard``: the twins of ``tests/test_preemption.py``;
* the Supervisor at a fixed world (the twins of the JAX package's
  ``TestSupervisor``): crash recovery, a torn save, the sigterm drain, a
  crash inside a save, the step fence, the retry budget, stale
  checkpoints — each run ends BITWISE equal to the uninterrupted run;
* the entry point: ``--max-restarts`` with ``crash`` (and ``torn_ckpt``)
  ends bitwise equal to the no-fault run; on 2 gloo ranks with the int8
  wire, a SIGTERM that reaches rank 1 only stops both ranks at the same
  step with one checkpoint, and the resume is bitwise the uninterrupted
  run, error-feedback residuals included.
"""

import dataclasses
import os
import random
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_pytorch_training_tpu.resilience import (
    faults as jax_faults,
)
from distributed_pytorch_training_tpu.resilience.supervisor import (
    RetryPolicy as JaxRetryPolicy,
)
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.resilience.faults import (
    FaultError, FaultInjector, FaultPlan, ReplicaDeathError,
)
from distributed_pytorch_training_tpu_torch.resilience.supervisor import (
    RetryPolicy, RunReport, Supervisor, SupervisorError,
)
from distributed_pytorch_training_tpu_torch.training.checkpoint import (
    CheckpointManager, CheckpointWorldSizeMismatch,
)
from distributed_pytorch_training_tpu_torch.training.preemption import (
    PreemptionGuard, RankAgreedStop,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_rig import (  # noqa: E402,F401
    assert_bitwise_equal, control, flat_state, port_process_state,
    reset_port_process_state, rig,
)
from _torch_dp_worker import run_ranks  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models here run as fast on one thread, and the other test
    files' workers keep the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAST_RETRY = RetryPolicy(max_restarts=4, backoff_base_s=0.01,
                         backoff_max_s=0.02, seed=0)
QUIET = dict(log=lambda _m: None)


# ---------------------------------------------------------------------------
# FaultPlan, FaultInjector, RetryPolicy: the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    None, "", "crash@step=7", "sigterm@step=12", "loader_stall@step=5:2.5s",
    "loader_stall@step=5:2s", "loader_stall@step=0:0.15", "torn_ckpt@save=2",
    "crash_during_save@save=3", "replica_death@step=7",
    "capacity_return@step=2", "replica_death@step=3x2", "crash@step=3 x2",
    "crash@step=7, sigterm@step=12,torn_ckpt@save=2,"
    "loader_stall@step=5:2.5s,crash@step=1x3",
])
def test_fault_plan_equals_jax(spec):
    ours, ref = FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec)
    assert bool(ours) == bool(ref)
    assert [dataclasses.asdict(f) for f in ours.faults] == \
        [dataclasses.asdict(f) for f in ref.faults]
    for f, g in zip(ours.faults, ref.faults):
        assert f.label() == g.label()
        assert f.label(remaining=f.count) == g.label(remaining=g.count)


@pytest.mark.parametrize("bad", [
    "explode@step=1", "crash@save=1", "torn_ckpt@step=1", "crash@step",
    "loader_stall@step=5", "crash@step=5:2s", "crash@step=3x0",
    "crash@step=-1", "sigterm@step=2:1s",
])
def test_malformed_fault_plan_raises_as_in_jax(bad):
    with pytest.raises(ValueError) as ours:
        FaultPlan.parse(bad)
    with pytest.raises(ValueError) as ref:
        jax_faults.FaultPlan.parse(bad)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("seed,indices", [(0, [1, 1, 2, 3, 4]),
                                          (7, [1, 2, 3, 4, 5, 6, 7, 8]),
                                          (123, [3, 1, 9, 1])])
def test_retry_delay_equals_jax(seed, indices):
    ours, ref = RetryPolicy(seed=seed), JaxRetryPolicy(seed=seed)
    r1, r2 = random.Random(seed), random.Random(seed)
    assert [ours.delay_s(i, r1) for i in indices] == \
        [ref.delay_s(i, r2) for i in indices]


def test_injector_fires_once_and_reports():
    inj = FaultInjector(FaultPlan.parse("crash@step=3"), **QUIET)
    inj.on_step(2)
    with pytest.raises(FaultError, match="crash@step=3"):
        inj.on_step(3)
    inj.on_step(3)  # the replay of step 3 after a restore passes
    assert inj.fired == ["crash@step=3"] and inj.unfired() == []


def test_injector_honours_repeats():
    inj = FaultInjector(FaultPlan.parse("replica_death@step=3x2, "
                                        "crash@step=5"), **QUIET)
    for _ in range(2):
        with pytest.raises(ReplicaDeathError, match="replica_death"):
            inj.on_step(3)
    inj.on_step(3)  # spent
    assert inj.fired == ["replica_death@step=3"] * 2
    assert inj.unfired() == ["crash@step=5"]
    logs = []
    quiet = FaultInjector(FaultPlan.parse("capacity_return@step=0"),
                          log=logs.append)
    quiet.on_step(0)  # no raise: nothing to notify in a fixed world
    assert quiet.fired == ["capacity_return@step=0"] and logs


def test_injector_save_counters():
    inj = FaultInjector(FaultPlan.parse("torn_ckpt@save=2,"
                                        "crash_during_save@save=1"), **QUIET)
    with pytest.raises(FaultError, match="crash_during_save@save=1"):
        inj.on_save_finalize(4)
    inj.on_save_finalize(8)     # the second attempt finalizes
    assert inj.finalizes_seen == 2 and inj.unfired() == ["torn_ckpt@save=2"]


@pytest.mark.parametrize("kind", ["resnet", "gpt2"])
def test_loader_stall_leaves_batches_unchanged(kind):
    _, _, make_loader = rig(kind)
    inj = FaultInjector(FaultPlan.parse("loader_stall@step=1:0.15s"),
                        **QUIET)
    t0 = time.monotonic()
    stalled = list(make_loader(inj.on_loader_batch).epoch(0))
    assert time.monotonic() - t0 >= 0.15
    plain = list(make_loader().epoch(0))
    assert inj.fired == ["loader_stall@step=1:0.15s"]
    assert len(stalled) == len(plain) == 4
    for a, b in zip(stalled, plain):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_loader_hook_sees_the_resume_offset():
    seen = []
    _, _, make_loader = rig("gpt2")
    batches = list(make_loader(seen.append).epoch(0, start_step=2))
    assert seen == [2, 3] and len(batches) == 2


# ---------------------------------------------------------------------------
# PreemptionGuard (the twins of tests/test_preemption.py)
# ---------------------------------------------------------------------------


def test_sigterm_sets_stop_flag():
    guard = PreemptionGuard.install()
    assert not guard.should_stop
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.should_stop
    assert RankAgreedStop(guard).should_stop  # one process: the flag
    guard.reset()


def test_install_is_idempotent_and_rearms():
    g1 = PreemptionGuard.install()
    g1.request_stop()
    g2 = PreemptionGuard.install()  # a new run: the stale flag is cleared
    assert g1 is g2
    assert not g2.should_stop


def test_signal_arms_hard_deadline(monkeypatch):
    monkeypatch.setenv("DPT_PREEMPT_GRACE_SECONDS", "0.2")
    guard = PreemptionGuard.install()
    fired = threading.Event()
    guard._force_exit = fired.set
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.should_stop
    assert fired.wait(timeout=2.0), "hard-exit deadline never fired"
    guard.reset()


def test_disarm_cancels_hard_deadline(monkeypatch):
    monkeypatch.setenv("DPT_PREEMPT_GRACE_SECONDS", "0.3")
    guard = PreemptionGuard.install()
    fired = threading.Event()
    guard._force_exit = fired.set
    os.kill(os.getpid(), signal.SIGTERM)
    guard.disarm()
    assert not fired.wait(timeout=0.8), "deadline fired after disarm"
    guard.reset()


def test_uninstall_puts_back_the_previous_handlers():
    PreemptionGuard.uninstall()     # whatever an earlier test installed
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard.install()
    assert signal.getsignal(signal.SIGTERM) == guard._handler
    PreemptionGuard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    assert PreemptionGuard.install() is not guard
    PreemptionGuard.uninstall()


def test_sigterm_reaches_a_jax_guard_after_a_port_test():
    """A port test that runs ``train.main`` leaves the port's guard
    handling SIGTERM (as the JAX entry leaves its own). A JAX guard
    installed earlier in the same worker process then never saw the
    signal: ``install`` is idempotent and does not take the handler back,
    so tests/test_preemption.py::test_sigterm_sets_stop_flag failed after
    a port test file. The port's per-test teardown
    (``reset_port_process_state``, the ``port_process_state`` fixture)
    puts the JAX handler back."""
    from distributed_pytorch_training_tpu.training.preemption import (
        PreemptionGuard as JaxGuard,
    )

    jax_guard = JaxGuard.install()          # an earlier JAX test's guard
    signal.signal(signal.SIGTERM, jax_guard._handler)
    PreemptionGuard.install()               # a port test's train.main
    assert signal.getsignal(signal.SIGTERM) != jax_guard._handler
    reset_port_process_state()              # that test's teardown
    assert JaxGuard.install() is jax_guard  # the JAX test's install
    os.kill(os.getpid(), signal.SIGTERM)
    assert jax_guard.should_stop
    jax_guard.reset()


# ---------------------------------------------------------------------------
# the Supervisor at a fixed world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resnet_rig():
    """The tiny ResNet rig (4 steps an epoch) and its uninterrupted 2-epoch
    state, shared by the supervisor tests."""
    trainer, state_factory, make_loader = rig("resnet")
    want = flat_state(control(trainer, state_factory, make_loader(), 2))
    return trainer, state_factory, make_loader, want


def _supervised(resnet_rig, tmp_path, spec, ckpt=True, **kw):
    trainer, state_factory, make_loader, want = resnet_rig
    inj = FaultInjector(FaultPlan.parse(spec), **QUIET)
    mgr = (CheckpointManager(str(tmp_path / "ckpt"),
                             post_save_hook=inj.on_save,
                             pre_finalize_hook=inj.on_save_finalize)
           if ckpt else None)
    kw.setdefault("checkpoint_every_steps", 2)
    kw.setdefault("retry", FAST_RETRY)
    sup = Supervisor(trainer, mgr, state_factory,
                     make_loader(inj.on_loader_batch), injector=inj, **kw)
    try:
        state, report = sup.run(epochs=2)
    finally:
        if mgr is not None:
            mgr.close()
    return state, report, want


def test_supervisor_crash_recovery_bitwise(resnet_rig, tmp_path):
    state, report, want = _supervised(resnet_rig, tmp_path, "crash@step=5")
    assert report.completed and report.restarts == 1
    assert report.fence_violations == 0
    assert report.steps_replayed == 1  # step 4 ran twice, nothing else
    assert report.faults_fired == ["crash@step=5"]
    assert state.step == 8
    assert_bitwise_equal(want, state)


def test_supervisor_torn_save_skipped_then_bitwise(resnet_rig, tmp_path):
    state, report, want = _supervised(resnet_rig, tmp_path,
                                      "torn_ckpt@save=2,crash@step=5")
    assert report.completed and report.restarts == 1
    assert report.checkpoints_skipped == 1   # the torn save 2 (label 4)
    assert report.steps_replayed == 3        # restored at 2, crashed at 5
    assert state.step == 8
    assert_bitwise_equal(want, state)


def test_supervisor_sigterm_drains_then_resumes_bitwise(resnet_rig,
                                                        tmp_path):
    guard = PreemptionGuard.install()
    try:
        state, report, want = _supervised(
            resnet_rig, tmp_path, "sigterm@step=6", guard=guard,
            resume_preempted=True)
    finally:
        guard.reset()
    assert report.completed and report.preemptions_drained == 1
    assert report.restarts == 0  # a drain is not a failure
    assert state.step == 8
    assert_bitwise_equal(want, state)


def test_supervisor_crash_during_save_recovered_bitwise(resnet_rig,
                                                        tmp_path):
    state, report, want = _supervised(resnet_rig, tmp_path,
                                      "crash_during_save@save=2")
    assert report.completed and report.restarts == 1
    assert report.faults_fired == ["crash_during_save@save=2"]
    assert report.checkpoints_skipped == 1  # the half-born label 4
    assert report.fence_violations == 0
    assert state.step == 8
    assert_bitwise_equal(want, state)


def test_supervisor_loader_stall_is_survived(resnet_rig, tmp_path):
    state, report, want = _supervised(resnet_rig, tmp_path,
                                      "loader_stall@step=1:0.1s", ckpt=False,
                                      checkpoint_every_steps=None)
    assert report.completed and report.restarts == 0
    assert report.faults_fired == ["loader_stall@step=1:0.1s"]
    assert_bitwise_equal(want, state)


def test_step_fence_detects_mismatched_coordinate(resnet_rig, tmp_path):
    trainer, state_factory, make_loader, _ = resnet_rig
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state_factory(), epoch=0, step_in_epoch=3)  # claims step 3
    sup = Supervisor(trainer, mgr, state_factory, make_loader(),
                     retry=FAST_RETRY)
    report = RunReport()
    _state, epoch, step = sup._restore_or_fresh(report, spe=4)
    mgr.close()
    assert report.fence_violations == 1
    assert (epoch, step) == (0, 0)  # the optimizer's true position


def test_supervisor_gives_up_after_retry_budget(resnet_rig, tmp_path):
    with pytest.raises(SupervisorError, match="giving up") as err:
        _supervised(resnet_rig, tmp_path, "crash@step=0,crash@step=1",
                    retry=RetryPolicy(max_restarts=1, backoff_base_s=0.01))
    assert err.value.report.restarts == 2
    assert err.value.report.faults_fired == ["crash@step=0", "crash@step=1"]


def test_retry_budget_resets_after_clean_segment(resnet_rig, tmp_path):
    retry = RetryPolicy(max_restarts=1, backoff_base_s=0.01,
                        backoff_max_s=0.02, seed=0)
    sleeps = []
    state, report, want = _supervised(resnet_rig, tmp_path,
                                      "crash@step=1,crash@step=5",
                                      retry=retry, sleep=sleeps.append)
    assert report.completed and report.restarts == 2
    rng = random.Random(retry.seed)
    assert sleeps == [retry.delay_s(1, rng), retry.delay_s(1, rng)]
    assert state.step == 8
    assert_bitwise_equal(want, state)


def test_fresh_run_never_restores_stale_checkpoints(resnet_rig, tmp_path):
    _, state_factory, _, _ = resnet_rig
    stale = CheckpointManager(str(tmp_path / "ckpt"))
    stale.save(8, state_factory(), epoch=2)  # a finished 2-epoch run
    stale.close()
    state, report, want = _supervised(resnet_rig, tmp_path, "crash@step=1",
                                      trust_existing=False)
    assert report.completed and report.restarts == 1
    assert state.step == 8  # trained 2 real epochs, not the stale one
    assert_bitwise_equal(want, state)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

RESNET_CLI = ["--device", "cpu", "--model", "resnet18", "--model-overrides",
              "num_filters=4", "--synthetic", "--synthetic-size", "64",
              "--batch-size", "8", "--epochs", "2", "--print-freq", "2",
              "--no-telemetry"]


@pytest.mark.parametrize("chaos,restarts,skipped", [
    ("crash@step=3", 1, 0),
    ("crash@step=10,torn_ckpt@save=1", 1, 1),
])
def test_cli_max_restarts_ends_bitwise(tmp_path, capsys, chaos, restarts,
                                       skipped):
    want = train.main(RESNET_CLI + ["--output-dir", str(tmp_path / "a")])
    got = train.main(RESNET_CLI + ["--output-dir", str(tmp_path / "b"),
                                   "--checkpoint-dir", str(tmp_path / "ck"),
                                   "--max-restarts", "2", "--chaos", chaos])
    out = capsys.readouterr().out
    assert (f"Supervisor: completed=True restarts={restarts} "
            in out), out
    assert f"torn_checkpoints_skipped={skipped}" in out
    if skipped:
        assert "CHECKPOINT INTEGRITY: checkpoint 8 is torn" in out
    assert got.step == want.step == 16
    assert_bitwise_equal(want, got)


DP_CLI = ["--device", "cpu", "--model", "resnet18", "--model-overrides",
          "num_filters=4", "--synthetic", "--synthetic-size", "64",
          "--batch-size", "4", "--epochs", "2", "--print-freq", "2",
          "--wire-dtype", "int8", "--bucket-cap-mb", "0", "--no-telemetry"]


def test_two_ranks_sigterm_on_one_rank_then_resume_bitwise(tmp_path):
    """2 gloo ranks on the int8 wire (8 steps an epoch): rank 1 alone gets
    SIGTERM at step 2. Both ranks agree at the next print boundary, stop
    after step 3 with one checkpoint (epoch 0, step 4), and the resumed
    run ends bitwise equal to the uninterrupted one on each rank,
    error-feedback residuals included. That checkpoint, restored by one
    process, is refused by world size."""
    ck = str(tmp_path / "ck")

    def cli(name, per_rank):
        work = tmp_path / name
        work.mkdir()
        return run_ranks(work, 2, {"cli": ("cli", {"argv": per_rank})},
                         timeout=180)

    base = DP_CLI + ["--output-dir", str(tmp_path / "b"),
                     "--checkpoint-dir", ck]
    # the uninterrupted run and the cut one side by side (own stores)
    with ThreadPoolExecutor(2) as pool:
        whole = pool.submit(cli, "a", [DP_CLI + ["--output-dir",
                                                 str(tmp_path / "a")]] * 2)
        cut = pool.submit(cli, "b",
                          [base, base + ["--chaos", "sigterm@step=2"]])
        whole, cut = whole.result(), cut.result()
    assert [r["cli"]["step"] for r in cut] == [4, 4]
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [4]
    man = mgr.manifest(4)
    assert (man["epoch"], man["step_in_epoch"], man["world_size"]) == \
        (0, 4, 2)
    assert man["shapes"]["grad_sync"][0][0] == 2   # one row per rank
    resumed = cli("c", [base + ["--resume"]] * 2)
    for r in range(2):
        assert resumed[r]["cli"]["step"] == whole[r]["cli"]["step"] == 16
        a, b = whole[r]["cli"]["state"], resumed[r]["cli"]["state"]
        assert "grad_sync/ef" in a and a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # the two ranks' residuals differ: each restored its own row
    assert not np.array_equal(resumed[0]["cli"]["state"]["grad_sync/ef"],
                              resumed[1]["cli"]["state"]["grad_sync/ef"])
    _, state_factory, _ = rig("resnet")
    template = state_factory()
    template.grad_sync = {"ef": torch.zeros(
        sum(p.numel() for p in template.params))}
    with pytest.raises(CheckpointWorldSizeMismatch, match="world size 2"):
        mgr.restore_latest(template)
    mgr.close()
    with pytest.raises(NotImplementedError, match="elastic slice"):
        train.main(DP_CLI + ["--output-dir", str(tmp_path / "d"),
                             "--checkpoint-dir", ck, "--resume"])
