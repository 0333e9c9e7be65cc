"""The port's checkpoints (``training/checkpoint.py``) against the JAX
package's protocol and against uninterrupted runs.

* save and restore are bitwise: parameters, BatchNorm statistics, SGD and
  AdamW state, ``step``, ``epoch``, ``step_in_epoch`` and the residual;
* the manifest carries the JAX manifest's keys and coordinates, and the
  same parameter shapes, for the same save of the same weights;
* torn checkpoints (truncated, corrupt, never finalized) are skipped with
  a log line naming them; a failed write surfaces at the next save;
  ``save`` returns before the write and snapshots a copy;
* a run stopped mid-epoch and resumed from its checkpoint ends bitwise
  equal to the uninterrupted run (tiny ResNet with SGD, tiny GPT-2 with
  AdamW), and within the trajectory test's tolerances of the JAX Trainer
  (PARAM_ATOL and PARAM_RTOL of ``tests/test_torch_training.py``, with
  its AdamW key-bias bound);
* the entry point resumes (``--checkpoint-dir``/``--resume``, ``--chaos
  sigterm``), and ``serving smoke --ckpt-dir`` serves the restored
  weights.
"""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from distributed_pytorch_training_tpu.models import (
    get_model as jax_get_model,
)
from distributed_pytorch_training_tpu.parallel import shard_batch
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
)
from distributed_pytorch_training_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from distributed_pytorch_training_tpu.training.tasks import (
    LanguageModelingTask as JaxLMTask,
)
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import (
    iter_flax_leaves, load_flax_params, torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.resilience.faults import (
    FaultError, FaultInjector, FaultPlan,
)
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig, Trainer, make_optimizer,
)
from distributed_pytorch_training_tpu_torch.training.checkpoint import (
    CheckpointManager, CheckpointWorldSizeMismatch,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    LanguageModelingTask,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_rig import (  # noqa: E402,F401
    GPT2, assert_bitwise_equal, control, flat_state, port_process_state, rig,
)

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models here run as fast on one thread, and the other test
    files' workers keep the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# test_torch_training.py's trajectory tolerances
PARAM_ATOL = 1e-5
PARAM_RTOL = 1e-4


def _trained(kind, steps=3, ef=False):
    """A rig's state after ``steps`` steps (the optimizer state exists),
    with a random residual when ``ef``."""
    trainer, state_factory, make_loader = rig(kind)
    state = state_factory()
    loader = make_loader()
    for i, batch in enumerate(loader.epoch(0)):
        if i == steps:
            break
        trainer.train_step(state, batch)
    if ef:
        n = sum(p.numel() for p in state.params)
        state.grad_sync = {"ef": torch.randn(
            n, generator=torch.Generator().manual_seed(5))}
    return state, state_factory


def _fresh_template(state_factory, ef=False):
    template = state_factory()
    if ef:
        n = sum(p.numel() for p in template.params)
        template.grad_sync = {"ef": torch.zeros(n)}
    return template


@pytest.mark.parametrize("kind,ef", [("resnet", False), ("resnet", True),
                                     ("gpt2", False)],
                         ids=["resnet-sgd", "resnet-sgd-ef", "gpt2-adamw"])
def test_save_restore_bitwise(tmp_path, kind, ef):
    state, state_factory = _trained(kind, ef=ef)
    before = flat_state(state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, state, epoch=1, step_in_epoch=3, world_size=1)
    mgr.wait()
    restored = mgr.restore_latest(_fresh_template(state_factory, ef))
    mgr.close()
    assert restored is not None
    new, epoch, step_in_epoch = restored
    assert (epoch, step_in_epoch, new.step) == (1, 3, 3)
    assert mgr.last_restored == 7
    assert_bitwise_equal(before, new)
    if kind == "gpt2":  # AdamW's moments and count really are there
        slots = new.optimizer.state_dict()["state"][0]
        assert {"exp_avg", "exp_avg_sq", "step"} <= set(slots)
    else:
        assert "momentum_buffer" in new.optimizer.state_dict()["state"][0]
        assert any("mean" in k for k in new.batch_stats)
    meta = mgr.metadata(7)
    assert meta == mgr.latest_metadata()
    assert meta["optimizer"] == type(state.optimizer).__name__
    assert mgr.checkpoint_world_size(7) == 1


def test_manifest_has_the_jax_keys_and_coordinates(tmp_path, mesh8):
    """The same save of the same tiny GPT-2 weights by both packages: the
    port's manifest holds every key of the JAX manifest with the same
    label, step, world size and format, the same parameter shapes, and
    adds the coordinates epoch and step_in_epoch."""
    jm = jax_get_model("gpt2_124m", **GPT2)
    jt = JaxTrainer(JaxLMTask(), mesh8, JaxTrainConfig(seed=0))
    jstate = jt.init_state(jm, np.zeros((1, GPT2["max_position"]), np.int32),
                           jax_make_optimizer("adamw", 3e-3),
                           jax.random.PRNGKey(0))
    jstate = jstate.replace(step=jstate.step + 4)
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"))
    jmgr.save(12, jstate, epoch=1, step_in_epoch=4, world_size=8)
    jmgr.wait()
    jman = jmgr.manifest(12)
    jmgr.close()

    model = get_model("gpt2_124m", **GPT2)
    load_flax_params(model, jax.device_get(jstate.params))
    trainer = Trainer(LanguageModelingTask(), TrainConfig(seed=0),
                      device="cpu")
    state = trainer.init_state(model, make_optimizer("adamw", 3e-3))
    state.step = 4
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(12, state, epoch=1, step_in_epoch=4, world_size=8)
    mgr.wait()
    man = mgr.manifest(12)
    mgr.close()

    assert set(jman) <= set(man)
    assert set(man) - set(jman) == {"epoch", "step_in_epoch"}
    for key in ("format", "label", "step", "world_size"):
        assert man[key] == jman[key], key
    assert (man["epoch"], man["step_in_epoch"]) == (1, 4)
    assert set(man["shapes"]) == set(jman["shapes"])
    assert man["shapes"]["params"] == jman["shapes"]["params"]
    assert man["n_files"] == len(man["files"])
    for info in man["files"].values():
        assert set(info) == {"size", "sha256"}


def _tear(step_dir: Path, how: str) -> None:
    victim = max((p for p in step_dir.iterdir() if p.is_file()),
                 key=lambda p: p.stat().st_size)
    if how == "truncate":
        with open(victim, "r+b") as f:
            f.truncate(victim.stat().st_size // 2)
    else:
        blob = bytearray(victim.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        victim.write_bytes(bytes(blob))


@pytest.mark.parametrize("how,problem", [("truncate", "truncated"),
                                         ("flip", "digest mismatch")])
def test_torn_checkpoint_skipped_loudly(tmp_path, capsys, how, problem):
    state, state_factory = _trained("resnet", steps=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, epoch=1)
    mgr.save(2, state, epoch=2)
    mgr.wait()
    _tear(tmp_path / "ckpt" / "2", how)
    assert problem in mgr.verify(2)
    restored = mgr.restore_latest(state_factory())
    mgr.close()
    assert restored is not None and restored[1:] == (1, 0)
    assert mgr.last_skipped == [2] and mgr.last_restored == 1
    out = capsys.readouterr().out
    assert "CHECKPOINT INTEGRITY: checkpoint 2 is torn" in out
    assert problem in out


def test_all_checkpoints_torn_returns_none(tmp_path, capsys):
    state, state_factory = _trained("resnet", steps=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, epoch=1)
    mgr.wait()
    _tear(tmp_path / "ckpt" / "1", "truncate")
    assert mgr.restore_latest(state_factory()) is None
    mgr.close()
    assert "failed verification" in capsys.readouterr().out


def test_crash_during_save_leaves_pending_that_is_skipped(tmp_path, capsys):
    state, state_factory = _trained("resnet", steps=1)
    inj = FaultInjector(FaultPlan.parse("crash_during_save@save=1"),
                        log=lambda _m: None)
    mgr = CheckpointManager(str(tmp_path / "ckpt"),
                            pre_finalize_hook=inj.on_save_finalize)
    mgr.save(1, state, epoch=1)
    with pytest.raises(FaultError, match="crash_during_save"):
        mgr.wait()
    manifests = tmp_path / "ckpt" / ".manifests"
    assert (manifests / "1.pending").exists()
    assert not (manifests / "1.json").exists()
    assert (tmp_path / "ckpt" / "1").is_dir()     # committed, not vouched
    assert "never finalized" in mgr.verify(1)
    assert mgr.restore_latest(state_factory()) is None
    assert mgr.last_skipped == [1]
    assert "never finalized" in capsys.readouterr().out
    mgr.save(1, state, epoch=1)      # the fault fired once: re-save heals
    mgr.wait()
    assert mgr.verify(1) is None
    assert mgr.restore_latest(state_factory()) is not None
    mgr.close()


def test_failed_async_write_surfaces_at_next_save(tmp_path):
    state, state_factory = _trained("resnet", steps=1)
    armed = {"on": True}

    def hook(_label):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("disk gone")

    mgr = CheckpointManager(str(tmp_path / "ckpt"), pre_finalize_hook=hook)
    mgr.save(1, state, epoch=1)
    with pytest.raises(RuntimeError, match="disk gone"):
        mgr.save(2, state, epoch=2)
    mgr.save(2, state, epoch=2)  # the error was consumed at the barrier
    mgr.wait()
    assert mgr.verify(2) is None
    assert "never finalized" in mgr.verify(1)
    restored = mgr.restore_latest(state_factory())
    mgr.close()
    assert restored is not None and restored[1] == 2


def _gated():
    gate, entered = threading.Event(), threading.Event()

    def hold(_label):
        entered.set()
        assert gate.wait(timeout=30.0)

    return gate, entered, hold


def test_save_returns_before_the_write_finishes(tmp_path):
    state, _ = _trained("resnet", steps=1)
    gate, entered, hold = _gated()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), pre_finalize_hook=hold)
    t0 = time.perf_counter()
    mgr.save(1, state, epoch=1)
    assert entered.wait(timeout=30.0)     # the writer is parked mid-save
    manifests = tmp_path / "ckpt" / ".manifests"
    assert (manifests / "1.pending").exists()
    assert not (manifests / "1.json").exists()
    assert mgr.save_blocked_ms <= (time.perf_counter() - t0) * 1e3
    gate.set()
    mgr.wait()
    assert (manifests / "1.json").exists()
    assert not (manifests / "1.pending").exists()
    assert mgr.verify(1) is None
    assert mgr.snapshot_ms <= mgr.save_blocked_ms
    assert mgr.saves_started == 1 and mgr.bytes_written > 0
    mgr.close()


@pytest.mark.parametrize("kind", ["resnet", "gpt2"])
def test_snapshot_is_a_copy(tmp_path, kind):
    """The optimizer updates parameters and moments in place: what a
    checkpoint holds is the state when ``save`` was called, even when the
    write runs after the state moved on."""
    state, state_factory = _trained(kind, ef=kind == "resnet")
    before = flat_state(state)
    gate, entered, hold = _gated()
    mgr = CheckpointManager(str(tmp_path / "ckpt"),
                            post_save_hook=lambda label, d: hold(label))
    mgr.save(1, state, epoch=1)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for t in state.model.buffers():
            t.add_(1.0)
        for slots in state.optimizer.state.values():
            for v in slots.values():
                v.add_(1.0)
        for v in state.grad_sync.values():
            v.add_(1.0)
    gate.set()
    mgr.wait()
    restored, _, _ = mgr.restore_latest(
        _fresh_template(state_factory, ef=kind == "resnet"))
    mgr.close()
    assert_bitwise_equal(before, restored)


def test_max_to_keep_prunes_checkpoints_and_manifests(tmp_path):
    state, _ = _trained("resnet", steps=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for label in (1, 2, 3, 4):
        mgr.save(label, state, epoch=label)
    mgr.wait()
    mgr.close()
    assert mgr.all_steps() == [3, 4]
    manifests = sorted(p.name for p in
                       (tmp_path / "ckpt" / ".manifests").iterdir())
    assert manifests == ["3.json", "4.json"]


def test_ef_checkpoint_at_another_world_size_raises(tmp_path):
    """A checkpoint whose residual rows were laid out for 2 ranks restored
    by a run of 1: the named error, before any tensor is touched."""
    state, state_factory = _trained("resnet", steps=1, ef=True)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, epoch=1, world_size=2)
    mgr.wait()
    with pytest.raises(CheckpointWorldSizeMismatch,
                       match="world size 2") as err:
        mgr.restore_latest(_fresh_template(state_factory, ef=True),
                           template_world_size=1)
    assert (err.value.label, err.value.world_size) == (1, 2)
    # no residual in the template (serving, or the fp32 wire): the rows
    # are not read, and nothing about them can mismatch
    assert mgr.restore_latest(state_factory()) is not None
    mgr.close()


def test_restore_refuses_another_optimizer(tmp_path):
    state, _ = _trained("resnet", steps=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, epoch=1)
    mgr.wait()
    _, gpt_factory, _ = rig("gpt2")
    with pytest.raises(ValueError, match="SGD state"):
        mgr.restore_latest(gpt_factory())
    mgr.close()


# ---------------------------------------------------------------------------
# mid-epoch resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["resnet", "gpt2"],
                         ids=["resnet-bn-sgd", "gpt2-adamw"])
def test_midepoch_resume_matches_uninterrupted(tmp_path, kind):
    """Stop after 2 steps of epoch 0, checkpoint (epoch, step), restore
    into a fresh state, resume at start_step=2: the final state is
    bitwise the uninterrupted run's (test_preemption.py's pin of the JAX
    package, here with BatchNorm statistics and optimizer state too)."""
    trainer, state_factory, make_loader = rig(kind)
    loader = make_loader()
    spe = len(loader)
    assert spe == 4
    state_a = control(trainer, state_factory, loader, 2)

    executed = [0]

    def stop_after_two():
        executed[0] += 1
        return executed[0] >= 2

    state_b, _, _, _, done = trainer.train_epoch(
        state_factory(), loader.epoch(0), 0, spe, stop_fn=stop_after_two)
    assert done == 2
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(done, state_b, wait=True, epoch=0, step_in_epoch=done)
    state_b, r_epoch, r_step = mgr.restore_latest(state_factory())
    mgr.close()
    assert (r_epoch, r_step) == (0, 2)
    for epoch in range(r_epoch, 2):
        start = r_step if epoch == r_epoch else 0
        state_b, *_ = trainer.train_epoch(
            state_b, loader.epoch(epoch, start_step=start), epoch, spe,
            start_step=start)
    assert state_b.step == state_a.step == 2 * spe
    assert_bitwise_equal(state_a, state_b)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_resumed_trajectory_matches_jax(tmp_path, mesh8, opt):
    """4 steps of the JAX Trainer against the port's 2 steps, a checkpoint
    round trip into a fresh state and 2 more: within the trajectory test's
    tolerances of JAX, and bitwise the port's own 4 uninterrupted steps."""
    steps, lr = 4, (0.05 if opt == "sgd" else 3e-3)
    rng = np.random.RandomState(0)
    batches = [{"input_ids": rng.randint(0, GPT2["vocab_size"],
                                         (16, GPT2["max_position"])
                                         ).astype(np.int32),
                "weight": np.ones(16, np.float32)} for _ in range(steps)]
    jm = jax_get_model("gpt2_124m", **GPT2)
    jt = JaxTrainer(JaxLMTask(), mesh8, JaxTrainConfig(seed=0,
                                                       print_freq=1000))
    jstate = jt.init_state(jm, np.zeros((1, GPT2["max_position"]), np.int32),
                           jax_make_optimizer(opt, lr),
                           jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate.params)
    key = jax.random.PRNGKey(0)
    for batch in batches:
        jstate, _ = jt._train_step(jstate, shard_batch(batch, mesh8), key)

    trainer = Trainer(LanguageModelingTask(),
                      TrainConfig(seed=0, print_freq=1000), device="cpu")

    def fresh():
        model = get_model("gpt2_124m", **GPT2)
        load_flax_params(model, params0)
        return trainer.init_state(model, make_optimizer(opt, lr))

    def run(state, chunk):
        for batch in chunk:
            trainer.train_step(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        return state

    whole = run(fresh(), batches)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, run(fresh(), batches[:2]), epoch=0, step_in_epoch=2)
    resumed, _, _ = mgr.restore_latest(fresh())
    mgr.close()
    resumed = run(resumed, batches[2:])
    assert resumed.step == int(jstate.step) == steps
    assert_bitwise_equal(whole, resumed)
    ours = dict(iter_flax_leaves(torch_to_flax(resumed.model)))
    ref = dict(iter_flax_leaves(jax.device_get(jstate.params)))
    assert ours.keys() == ref.keys()
    for path, want in ref.items():
        got, want = ours[path], np.asarray(want)
        if opt == "adamw" and path[-2:] == ("qkv", "bias"):
            # the key bias: held apart as in test_torch_training.py
            assert np.abs(got[1] - want[1]).max() <= 2 * lr * steps
            got, want = got[[0, 2]], want[[0, 2]]
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=str(path))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

# the port's tiny CLI GPT-2 (test_torch_training.py's TINY_CLI): 8 steps an
# epoch of 4 sequences
TINY_CLI = ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
            "vocab_size=50257,hidden_dim=32,depth=2,num_heads=2,"
            "max_position=32", "--seq-len", "32", "--synthetic",
            "--synthetic-size", "32", "--optimizer", "adamw", "--lr",
            "1e-3", "--batch-size", "4", "--print-freq", "2",
            "--no-telemetry"]


def _csv_epochs(out: Path):
    lines = (out / "metrics_rank0.csv").read_text().strip().splitlines()
    return [ln.split(",")[0] for ln in lines[1:]]


def test_cli_amp_checkpoint_resume(tmp_path):
    """tests/test_e2e.py's --amp checkpoint-resume pin on the port: one
    epoch, then --resume to two; the CSV holds epochs 1 and 2."""
    common = TINY_CLI + ["--amp", "--output-dir", str(tmp_path / "out"),
                         "--checkpoint-dir", str(tmp_path / "ckpt")]
    train.main(common + ["--epochs", "1"])
    state = train.main(common + ["--epochs", "2", "--resume"])
    assert state.step == 16
    assert _csv_epochs(tmp_path / "out") == ["1", "2"]
    assert state.model.dtype == torch.bfloat16


def test_cli_sigterm_preemption_then_resume_bitwise(tmp_path, capsys):
    """--chaos sigterm@step=4: the guard stops after step 4 (the fence
    fires before it, the step still runs), checkpoints epoch 0 step 5 and
    writes no CSV row for the cut epoch; --resume finishes bitwise equal to the
    uninterrupted run."""
    whole = train.main(TINY_CLI + ["--epochs", "2", "--output-dir",
                                   str(tmp_path / "a")])
    common = TINY_CLI + ["--epochs", "2", "--output-dir",
                         str(tmp_path / "b"), "--checkpoint-dir",
                         str(tmp_path / "ckpt")]
    cut = train.main(common + ["--chaos", "sigterm@step=4"])
    out = capsys.readouterr().out
    assert "chaos: delivering SIGTERM at step 4" in out
    assert "Preempted: checkpointed epoch 0 step 5/8" in out
    assert cut.step == 5
    assert _csv_epochs(tmp_path / "b") == []     # no row for epoch 1
    manifest = json.loads(
        (tmp_path / "ckpt" / ".manifests" / "5.json").read_text())
    assert (manifest["epoch"], manifest["step_in_epoch"],
            manifest["step"]) == (0, 5, 5)
    resumed = train.main(common + ["--resume"])
    assert "Resumed from epoch 0 step 5" in capsys.readouterr().out
    assert_bitwise_equal(whole, resumed)
    assert _csv_epochs(tmp_path / "b") == ["1", "2"]


def test_cli_resume_with_nothing_to_restore_starts_fresh(tmp_path):
    a = train.main(TINY_CLI + ["--epochs", "1", "--output-dir",
                               str(tmp_path / "a")])
    b = train.main(TINY_CLI + ["--epochs", "1", "--output-dir",
                               str(tmp_path / "b"), "--checkpoint-dir",
                               str(tmp_path / "empty"), "--resume"])
    assert_bitwise_equal(a, b)


def test_serving_smoke_serves_the_checkpoint(tmp_path, capsys):
    from distributed_pytorch_training_tpu_torch.serving.__main__ import run

    state = train.main(TINY_CLI + ["--epochs", "1", "--output-dir",
                                   str(tmp_path / "out"), "--checkpoint-dir",
                                   str(tmp_path / "ckpt")])
    capsys.readouterr()
    report = run(["smoke", "--device", "cpu", "--ckpt-dir",
                  str(tmp_path / "ckpt"), "--model-overrides",
                  "vocab_size=50257,hidden_dim=32,depth=2,num_heads=2,"
                  "max_position=32", "--buckets", "8,16", "--prompt-len",
                  "6", "--output-dir", str(tmp_path / "serving")])
    out = capsys.readouterr().out
    manifest = json.loads(
        (tmp_path / "ckpt" / ".manifests" / "8.json").read_text())
    assert (f"serving: checkpoint label=8 step=8 verified=True "
            f"tree_digest={manifest['tree_digest']}") in out
    assert "random-init" not in out
    info = report.engine.checkpoint_info
    assert (info["label"], info["step"]) == (8, 8)
    served = report.engine._served
    for name, p in state.model.named_parameters():
        assert torch.equal(served[name], p.detach()), name
    assert len(report.results) == 3
