"""Data-parallel GPT-2 and the reference's own command, the port against
the JAX package: 3-step Trainer trajectories of a narrow GPT-2 (2 blocks,
width 64, seq 32) on 2 gloo ranks against the JAX Trainer on a 2-device
CPU mesh, on the implicit path (the defaults) and through the explicit
fp32 reducer with a bucket cap; the per-rank token loader against the JAX
sampler's per-rank rows; then ``torchrun`` on 2 CPU ranks with the
reference's default flags and with ``--amp``.

Each rank gets its contiguous half of every global batch of 8 sequences
(the last two weighted 0), as the JAX mesh shards it. SGD lr 0.05,
momentum 0.9. The ranks are ``tests/_torch_dp_worker.py`` processes; one
module-scoped run serves every leg.

Tolerances, as on one rank (``test_torch_training.py``): the per-step
losses within LOSS_RTOL = 1e-5 and the parameters within PARAM_ATOL =
1e-5 + PARAM_RTOL = 1e-4, float32 reassociation (GPT-2 has no batch
statistics, so the ranks' partial sums meet only in the gradient sum and
the metrics); the token loader's rows bitwise.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from distributed_pytorch_training_tpu.data.sampler import (
    ShardedSampler as JaxSampler,
)
from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import shard_batch
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
)
from distributed_pytorch_training_tpu.training.tasks import (
    LanguageModelingTask as JaxLMTask,
)
from distributed_pytorch_training_tpu_torch.convert import iter_flax_leaves
from distributed_pytorch_training_tpu_torch.data.text import (
    TokenLoader,
    synthetic_token_dataset,
)
from distributed_pytorch_training_tpu_torch.utils import MetricsCSV

from _torch_dp_worker import run_ranks

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
SEQ, GLOBAL_BATCH, STEPS, LR = 32, 8, 3, 0.05
MODEL_KW = dict(vocab_size=97, hidden_dim=64, depth=2, num_heads=2,
                max_position=SEQ)
CAP = 0.15            # MB: the 0.41 MB gradient in 3 buckets

# (bucket_cap_mb, grad_accum): the implicit path, then the explicit
# fp32 reducer
CASES = [(0.0, 1), (0.0, 2), (CAP, 1)]
IDS = ["implicit", "implicit-accum2", "explicit-fp32-cap"]


def global_batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        w = np.ones(GLOBAL_BATCH, np.float32)
        w[-2:] = 0.0
        out.append({"input_ids": rng.randint(
            0, MODEL_KW["vocab_size"], (GLOBAL_BATCH, SEQ)).astype(np.int32),
            "weight": w})
    return out


def leaves(tree):
    return {path: np.asarray(v) for path, v in iter_flax_leaves(tree)}


@pytest.fixture(scope="module")
def jax_runs(devices):
    """Per case: (initial params, final params, per-step metrics)."""
    mesh2 = build_mesh(MeshSpec(data=2), devices=devices[:2])
    runs = {}
    for cap, accum in CASES:
        jt = JaxTrainer(JaxLMTask(), mesh2, JaxTrainConfig(
            seed=0, print_freq=1000, grad_accum=accum, bucket_cap_mb=cap))
        jstate = jt.init_state(jax_get_model("gpt2_124m", **MODEL_KW),
                               np.zeros((1, SEQ), np.int32),
                               jax_make_optimizer("sgd", LR),
                               jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(np.array,
                                      jax.device_get(jstate.params))
        metrics = []
        for b in global_batches():
            jstate, m = jt._train_step(jstate, shard_batch(b, mesh2),
                                       jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
        runs[(cap, accum)] = (init, jax.device_get(jstate.params), metrics)
    return runs


@pytest.fixture(scope="module")
def port_ranks(jax_runs, tmp_path_factory):
    jobs = {case: ("train", dict(
        lm=True, model_kwargs=MODEL_KW, params=init, lr=LR,
        batches=global_batches(),
        config=dict(grad_accum=case[1], bucket_cap_mb=case[0])))
        for case, (init, _, _) in jax_runs.items()}
    return run_ranks(tmp_path_factory.mktemp("dp_gpt2"), 2, jobs)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dp_gpt2_trajectory_matches_jax_trainer(jax_runs, port_ranks,
                                                case):
    params0, jparams, jmetrics = jax_runs[case]
    r0, r1 = (r[case] for r in port_ranks)
    assert r0["step"] == r1["step"] == STEPS
    for ours, ref in zip(r0["metrics"], jmetrics):
        assert ours["weight"] == ref["weight"] == (GLOBAL_BATCH - 2) * (
            SEQ - 1)
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    a, b = leaves(r0["params"]), leaves(r1["params"])
    for path in a:                     # replicated: the same bits
        np.testing.assert_array_equal(a[path], b[path])
    ref, start = leaves(jparams), leaves(params0)
    assert a.keys() == ref.keys()
    moved = 0.0
    for path, want in ref.items():
        moved = max(moved, float(np.abs(want - start[path]).max()))
        np.testing.assert_allclose(a[path], want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=str(path))
    assert moved > 10 * PARAM_ATOL


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)],
                         ids=["shuffle-padded", "in-order-drop-last"])
def test_token_loader_rows_per_rank_are_the_jax_samplers(shuffle,
                                                         drop_last):
    ds = synthetic_token_dataset(21, 8, 97, seed=2)
    for rank in range(2):
        loader = TokenLoader(ds, 4, shuffle=shuffle, seed=7,
                             drop_last=drop_last, process_index=rank,
                             process_count=2, device="cpu")
        plan = JaxSampler(n=21, global_batch=8, shuffle=shuffle, seed=7,
                          drop_last=drop_last, process_index=rank,
                          process_count=2)
        assert len(loader) == plan.steps_per_epoch() == (2 if drop_last
                                                         else 3)
        for epoch in range(2):
            batches = list(loader.epoch(epoch))
            for batch, (idx, w) in zip(batches, plan.iter_epoch(epoch)):
                assert batch["input_ids"].shape == (4, 8)
                np.testing.assert_array_equal(batch["input_ids"].numpy(),
                                              ds.tokens[idx])
                np.testing.assert_array_equal(batch["weight"].numpy(), w)
            assert len(batches) == len(loader)


# ---------------------------------------------------------------------------
# the reference's own command under torchrun
# ---------------------------------------------------------------------------

RESNET_CLI = ["--device", "cpu", "--model", "resnet18", "--model-overrides",
              "num_filters=8", "--synthetic", "--synthetic-size", "48",
              "--batch-size", "8", "--epochs", "2", "--print-freq", "1",
              "--lr", "0.05", "--no-telemetry"]
GPT2_CLI = ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
            "vocab_size=50257,hidden_dim=32,depth=2,num_heads=2,"
            "max_position=32", "--seq-len", "32", "--synthetic",
            "--synthetic-size", "32", "--epochs", "2", "--optimizer",
            "adamw", "--lr", "1e-3", "--batch-size", "4", "--print-freq",
            "2", "--no-telemetry"]


def torchrun(tmp_path, argv):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])),
        OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "distributed_pytorch_training_tpu_torch.train", *argv,
         "--output-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = (tmp_path / "metrics_rank0.csv").read_text().splitlines()
    assert lines[0] == MetricsCSV.HEADER.strip()
    losses = [float(ln.split(",")[1]) for ln in lines[1:]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    return proc.stdout, losses


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_torchrun_reference_command_on_cpu(tmp_path, amp):
    """The reference's command, default --wire-dtype fp32 --bucket-cap-mb
    0: the implicit path (no reducer banner), rank 0 alone logging."""
    out, losses = torchrun(tmp_path, RESNET_CLI + (["--amp"] if amp
                                                   else []))
    assert ("Using device: cpu (mesh {'data': 2}), world_size=2, "
            f"amp={amp}, backend=gloo") in out
    assert "Gradient sync" not in out and "NOTE: explicit" not in out
    # 48 samples / global batch 16: 3 steps an epoch
    assert out.count("Epoch [1] Step [3/3] Loss: ") == 1
    assert out.count("[Epoch 2/2] Train: loss=") == 1
    assert losses[1] < losses[0]


def test_torchrun_gpt2_amp_on_cpu(tmp_path):
    """Data-parallel GPT-2 in bf16 through the entry: 32 sequences over a
    global batch of 8, 4 steps an epoch."""
    out, _ = torchrun(tmp_path, GPT2_CLI + ["--amp"])
    assert ("Using device: cpu (mesh {'data': 2}), world_size=2, "
            "amp=True, backend=gloo") in out
    assert out.count("Epoch [1] Step [4/4] Loss: ") == 1
    assert out.count("[Epoch 2/2] Train: loss=") == 1
