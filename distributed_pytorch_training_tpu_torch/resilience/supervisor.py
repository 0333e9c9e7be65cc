"""In-process restart supervisor at a fixed world size (the JAX package's
resilience/supervisor.py without its elastic and control-plane parts).

Wraps ``Trainer.train_epoch`` in segments of at most
``checkpoint_every_steps`` steps (an epoch by default) and writes a
step-granular checkpoint after each. When a segment raises (an injected
:class:`~.faults.FaultError`, a real step failure, a failed save) it
restores the newest valid checkpoint (torn ones are skipped by the
manifest verification) and replays behind the step fence:

* the checkpoint's ``(epoch, step_in_epoch)`` decides where the loader
  resumes (the sampler is deterministic in seed and epoch);
* the restored ``state.step`` seeds the step's augmentation draws;
* the restored error-feedback residuals carry on where they left off;
* the fence check ``state.step == epoch * steps_per_epoch + step`` catches
  a restore whose optimizer count disagrees with its data coordinate (a
  replay would apply an update twice, or skip one): reported loudly, and
  the run resumes at the optimizer's position.

Retries are bounded by :class:`RetryPolicy`. Preemptions are drained: the
segment stops at a step boundary, a checkpoint is written, and the
supervisor returns (the relaunch resumes with ``--resume``) or, with
``resume_preempted=True``, restores its own checkpoint and goes on.

On several ranks every rank runs the same supervisor in step: the faults
fire on every rank at the same fence, saves and restores are collectives
(``training/checkpoint.py``), and ``guard`` is a
``training.preemption.RankAgreedStop`` polled every ``stop_poll_every``
steps.

Every restart, torn-checkpoint skip, drained preemption and abort leaves
a flight-recorder postmortem (``telemetry.flush_flight``; a no-op without
a telemetry stream), and each restart counts on the stream's ``restarts``
counter, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, List, Optional, Tuple

from ..telemetry import flush_flight
from ..telemetry import recorder as _telemetry
from ..utils.logging import log_main


class SupervisorError(RuntimeError):
    """The retry budget is exhausted; the last failure is the __cause__."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``max_restarts`` bounds CONSECUTIVE restore-and-replay attempts: a
    clean segment (train, save, barrier) resets the count and the backoff
    exponent. Attempt n sleeps ``min(base * factor^(n-1), max) * (1 +
    jitter * u)``, ``u ~ U[0, 1)`` from the policy's own seeded stream."""

    max_restarts: int = 3
    backoff_base_s: float = 0.25
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    jitter_frac: float = 0.25
    seed: int = 0

    def delay_s(self, restart_index: int, rng: random.Random) -> float:
        base = min(self.backoff_base_s
                   * self.backoff_factor ** max(0, restart_index - 1),
                   self.backoff_max_s)
        return base * (1.0 + self.jitter_frac * rng.random())


@dataclasses.dataclass
class RunReport:
    """Recovery statistics of one supervised run."""

    completed: bool = False
    preempted: bool = False
    restarts: int = 0
    preemptions_drained: int = 0
    steps_run: int = 0        # train steps executed, replays included
    steps_replayed: int = 0   # executed more than once (lost to a restore)
    final_step: int = -1
    fence_violations: int = 0
    checkpoints_skipped: int = 0   # torn checkpoints the restores skipped
    faults_fired: List[str] = dataclasses.field(default_factory=list)
    faults_unfired: List[str] = dataclasses.field(default_factory=list)
    failures: List[str] = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Supervisor:
    """Drive ``trainer`` over ``loader`` for N epochs, surviving failures.

    ``state_factory()`` builds a FRESH initial state (same seed and
    structure as the run's): the restore template and the from-scratch
    fallback, so the in-flight state of a failed step is never reused.
    ``ckpt`` is a ``training.checkpoint.CheckpointManager`` or None (a
    failure then restarts from scratch). ``injector`` is an armed
    ``FaultInjector`` or None. ``epoch_end_cb(epoch, state, loss, acc,
    seconds)`` runs after each completed epoch (validation, CSV row).
    ``trust_existing=False`` restricts restores to checkpoints this run
    wrote (a run without ``--resume`` must never restore a previous run's
    checkpoint from the same directory). A failed async save surfaces at
    the next save or the epoch-end ``wait``, inside the recovery scope."""

    def __init__(self, trainer, ckpt, state_factory: Callable[[], Any],
                 loader, *, retry: RetryPolicy = RetryPolicy(),
                 guard=None, injector=None,
                 checkpoint_every_steps: Optional[int] = None,
                 resume_preempted: bool = False,
                 trust_existing: bool = True,
                 epoch_end_cb: Optional[Callable[..., None]] = None,
                 stop_poll_every: int = 1,
                 sleep: Callable[[float], None] = time.sleep):
        if checkpoint_every_steps is not None and checkpoint_every_steps <= 0:
            raise ValueError("checkpoint_every_steps must be positive "
                             f"(got {checkpoint_every_steps})")
        if stop_poll_every < 1:
            raise ValueError(f"stop_poll_every must be >= 1 (got "
                             f"{stop_poll_every})")
        self.trainer = trainer
        self.ckpt = ckpt
        self.state_factory = state_factory
        self.loader = loader
        self.retry = retry
        self.guard = guard
        self.injector = injector
        self.every = checkpoint_every_steps
        self.resume_preempted = resume_preempted
        self.trust_existing = trust_existing
        self.epoch_end_cb = epoch_end_cb
        self.stop_poll_every = stop_poll_every
        self.sleep = sleep
        # consecutive restore-and-replay attempts since the last clean
        # segment (the RetryPolicy's index; report.restarts never resets)
        self._consecutive_failures = 0
        self._last_step_entered = -1
        self._saved_labels: set = set()
        self._skipped_labels: set = set()
        # the data-parallel world the manifests record
        self._world: Optional[int] = getattr(trainer, "n_shards", None)

    # -- fence and stop hooks ----------------------------------------------

    def _fault_hook(self, report: RunReport, seg_start_abs: int):
        """The per-step fence handed to train_epoch: records progress (so
        a restore can account the replay) and fires injected faults
        BEFORE the step executes."""
        injector = self.injector

        def hook(i: int) -> None:
            step = seg_start_abs + i
            self._last_step_entered = step
            if injector is not None:
                injector.on_step(step)
            report.steps_run += 1

        return hook

    def _segment_stop(self, seg_len: int):
        """stop_fn of one segment: stop after ``seg_len`` steps, or at a
        polled step boundary once a preemption was requested."""
        count = [0]
        guard, poll = self.guard, self.stop_poll_every

        def stop() -> bool:
            count[0] += 1
            if count[0] >= seg_len:
                return True
            if count[0] % poll:
                return False
            return bool(guard is not None and guard.should_stop)

        return stop

    # -- checkpoints --------------------------------------------------------

    def _save(self, epoch: int, step: int, spe: int, state) -> None:
        if self.ckpt is None:
            return
        if step >= spe:  # epoch complete: the epoch-boundary label
            label, save_epoch, in_epoch = (epoch + 1) * spe, epoch + 1, 0
        else:
            label, save_epoch, in_epoch = epoch * spe + step, epoch, step
        # the manager joins the previous write first, so an earlier failed
        # save surfaces HERE, inside the recovery scope
        self.ckpt.save(label, state, epoch=save_epoch,
                       step_in_epoch=in_epoch, world_size=self._world)
        self._saved_labels.add(label)

    def _restore_or_fresh(self, report: RunReport, spe: int
                          ) -> Tuple[Any, int, int]:
        """The newest valid checkpoint, or a fresh state when there is
        none: ``(state, epoch, step_in_epoch)``, with the step fence
        enforced."""
        among = None if self.trust_existing else self._saved_labels
        restored = (None if self.ckpt is None else
                    self.ckpt.restore_latest(self.state_factory(),
                                             among=among))
        if self.ckpt is not None:
            # a torn checkpoint is skipped by every later restore: count
            # distinct labels, not skip events
            fresh_skips = sorted(set(self.ckpt.last_skipped)
                                 - self._skipped_labels)
            self._skipped_labels.update(self.ckpt.last_skipped)
            report.checkpoints_skipped = len(self._skipped_labels)
            if fresh_skips:
                # each newly found torn checkpoint leaves its own
                # postmortem (the torn_ckpt chaos fault's flight artifact)
                flush_flight(
                    cause=f"torn_checkpoint: labels {fresh_skips} failed "
                          "integrity verification",
                    detail="supervisor restore skipped torn checkpoint(s)")
        if restored is None:
            if self.ckpt is not None:
                log_main("supervisor: no valid checkpoint — "
                         "(re)starting from scratch")
            return self.state_factory(), 0, 0
        state, epoch, step = restored
        expected = epoch * spe + step
        got = int(state.step)
        if got != expected:
            report.fence_violations += 1
            log_main(f"supervisor: STEP FENCE VIOLATION — restored "
                     f"optimizer step {got} != checkpoint coordinate "
                     f"epoch {epoch} * {spe} + step {step} = {expected}; "
                     "resuming at the optimizer's step to avoid a "
                     "double-apply")
            epoch, step = divmod(got, spe)
        return state, epoch, step

    # -- the loop -----------------------------------------------------------

    def run(self, epochs: int,
            initial: Optional[Tuple[Any, int, int]] = None):
        """Run to completion (or a drained preemption, or exhausted
        retries). ``initial`` is an already built ``(state, epoch, step)``
        (train.py's ``--resume`` restore); by default the supervisor
        restores from the manager. Returns ``(final_state, RunReport)``."""
        spe = len(self.loader)
        report = RunReport()
        rng = random.Random(self.retry.seed)
        if initial is not None:
            state, epoch, step = initial
        else:
            state, epoch, step = self._restore_or_fresh(report, spe)

        while epoch < epochs:
            seg_start_abs = epoch * spe + step
            seg_len = (spe - step if self.every is None
                       else min(self.every, spe - step))
            try:
                state, loss, acc, seconds, done = self.trainer.train_epoch(
                    state, self.loader.epoch(epoch, start_step=step),
                    epoch, spe, start_step=step,
                    stop_fn=self._segment_stop(seg_len),
                    fault_hook=self._fault_hook(report, seg_start_abs))
                step += done
                # the save is inside the recovery scope too
                self._save(epoch, step, spe, state)
                if self.ckpt is not None and step >= spe:
                    # epoch-boundary barrier: a failed write surfaces here,
                    # before epoch_end_cb writes the epoch's CSV row (a
                    # later surfacing would replay the epoch and write it
                    # twice); it also covers the run's last save
                    self.ckpt.wait()
            except Exception as e:  # every step failure is a restart
                # candidate; the budget bounds the ones that keep failing
                if self.guard is not None and self.guard.should_stop:
                    # a failure during the drain: restarting would race
                    # the preemption's hard-exit deadline
                    report.preempted = True
                    report.failures.append(
                        f"{type(e).__name__}: {e} (during preemption drain"
                        " — not restarted)")
                    flush_flight(
                        cause=f"{type(e).__name__}: {e}",
                        detail="failure during preemption (sigterm) drain "
                               "— not restarted", rc=1)
                    log_main("supervisor: failure during preemption drain; "
                             "stopping (relaunch resumes from the last "
                             "checkpoint)")
                    break
                report.restarts += 1
                self._consecutive_failures += 1
                report.failures.append(f"{type(e).__name__}: {e}")
                # the per-failure postmortem: an injected fault's flight
                # carries its label verbatim in the cause
                flush_flight(
                    cause=f"{type(e).__name__}: {e}",
                    detail=f"supervisor restart {report.restarts} "
                           f"(consecutive {self._consecutive_failures}/"
                           f"{self.retry.max_restarts})")
                _telemetry.counter("restarts", 1)
                if self._consecutive_failures > self.retry.max_restarts:
                    report.final_step = -1
                    if self.injector is not None:
                        report.faults_fired = list(self.injector.fired)
                        report.faults_unfired = self.injector.unfired()
                    flush_flight(
                        cause=f"supervisor abort: retry budget "
                              f"({self.retry.max_restarts}) exhausted; "
                              f"last failure: {type(e).__name__}: {e}",
                        detail="SupervisorError", rc=1)
                    err = SupervisorError(
                        f"giving up after {self.retry.max_restarts} "
                        f"consecutive restart(s); last failure: {e}")
                    err.report = report
                    raise err from e
                delay = self.retry.delay_s(self._consecutive_failures, rng)
                log_main(f"supervisor: step failure ({type(e).__name__}: "
                         f"{e}) — restart {self._consecutive_failures}/"
                         f"{self.retry.max_restarts} in {delay:.2f}s")
                self.sleep(delay)
                state, epoch, step = self._restore_or_fresh(report, spe)
                restored_abs = epoch * spe + step
                if self._last_step_entered >= 0:
                    report.steps_replayed += max(
                        0, self._last_step_entered - restored_abs)
                continue

            # a clean segment resets the retry budget and backoff
            self._consecutive_failures = 0

            if step >= spe:
                # epoch complete, BEFORE the drain check: a preemption at
                # the boundary still gets the finished epoch's CSV row
                if self.epoch_end_cb is not None:
                    self.epoch_end_cb(epoch, state, loss, acc, seconds)
                epoch, step = epoch + 1, 0

            if (self.guard is not None and epoch < epochs
                    and self.guard.should_stop):
                report.preemptions_drained += 1
                flush_flight(
                    cause=f"preemption (sigterm) drained at epoch {epoch} "
                          f"step {step}/{spe}",
                    detail="supervisor drain"
                           + ("" if not self.resume_preempted
                              else " + simulated relaunch"), rc=0)
                if not self.resume_preempted:
                    report.preempted = True
                    log_main(f"supervisor: preempted — checkpointed epoch "
                             f"{epoch} step {step}/{spe}; relaunch with "
                             "--resume to continue")
                    break
                log_main("supervisor: preemption drained; simulating "
                         "relaunch (restore + resume)")
                self.guard.reset()
                state, epoch, step = self._restore_or_fresh(report, spe)
                continue
        else:
            report.completed = True

        report.final_step = int(state.step)
        if self.injector is not None:
            report.faults_fired = list(self.injector.fired)
            report.faults_unfired = self.injector.unfired()
        return state, report
