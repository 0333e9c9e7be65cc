"""The port's data-parallel training path against the JAX package's: 3-step
Trainer trajectories on 2 gloo ranks against the JAX Trainer on a
2-device CPU mesh, through the explicit bucketed reducer and its fp32,
int8 and int8_multihop wires, with and without gradient accumulation and
overlap; then the entry point under ``torchrun`` on the CPU, and what it
still refuses.

The model is a narrow ResNet-18 (num_filters 8, the CIFAR stem, 16x16
images; ``test_torch_resnet.py`` says why the CIFAR stem), no
augmentation, SGD lr 1e-3, momentum 0.9. Each rank gets its contiguous
half of every global batch of 16 (the last two rows weighted 0), as the
JAX mesh shards it. The ranks are ``tests/_torch_dp_worker.py``
processes; one module-scoped run serves every leg.

Tolerances: the per-step losses within LOSS_RTOL = 1e-5 and the final
parameters and BatchNorm statistics within PARAM_ATOL = 1e-5 + PARAM_RTOL
= 1e-4, float32 reassociation as on one rank (test_torch_resnet.py). On
the int8 wires the codecs are bitwise the reference's
(test_torch_grad_sync.py), but their inputs, the gradients, differ by
reassociation, so an element whose value sits at a rounding boundary of
the int8 grid can take the neighbouring code on one side (about 3 in 1e5
elements at the first step, measured). Such an element moves by one code
step of its bucket's scale, and the parameters then differ by up to
lr x (1 + momentum + momentum^2) x that step / W; the int8 legs are held
to PARAM_ATOL plus that bound per step and per hop of the wire, with the
scale taken as the largest parameter movement over 127. The error-feedback
residual of a flipped element differs by one code step, at most twice the
reference's largest |residual| (a residual lies within half a step); the
others stay within PARAM_ATOL (EF_TIGHT of the elements at least). The
small lr keeps a flipped code's effect (about 6e-6) below PARAM_ATOL, so
it does not shift the next steps' gradients into further flips: at lr
1e-2 that cascade reached 2e-3 in the parameters after 3 steps
(measured), a property of a quantized trajectory, not of the port.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import shard_batch
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
)
from distributed_pytorch_training_tpu.training.tasks import (
    ImageClassificationTask as JaxImageTask,
)
from distributed_pytorch_training_tpu_torch import train
from distributed_pytorch_training_tpu_torch.convert import iter_flax_leaves
from distributed_pytorch_training_tpu_torch.data.datasets import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)
from distributed_pytorch_training_tpu_torch.utils import MetricsCSV

from _torch_dp_worker import run_ranks

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
EF_TIGHT = 0.95
MODEL_KW = dict(num_filters=8, cifar_stem=True)
HW, GLOBAL_BATCH, STEPS, LR = 16, 16, 3, 0.001
CAP = 0.25            # MB: the narrow model's 0.7 MB gradient in 3 buckets

# (wire, bucket_cap_mb, grad_accum, overlap)
CASES = [
    ("fp32", CAP, 1, True),
    ("int8", 0.0, 1, True),
    ("int8_multihop", CAP, 1, True),
    ("int8", CAP, 2, True),
    ("int8_multihop", 0.0, 2, False),
    ("fp32", CAP, 2, False),
]
IDS = [f"{w}-{'cap' if c else 'one-bucket'}-accum{a}"
       + ("" if a == 1 else "-overlap-" + ("on" if o else "off"))
       for w, c, a, o in CASES]


def global_batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        w = np.ones(GLOBAL_BATCH, np.float32)
        w[-2:] = 0.0
        out.append({"image": rng.randint(0, 256, (GLOBAL_BATCH, HW, HW, 3),
                                         dtype=np.uint8),
                    "label": rng.randint(0, 10, GLOBAL_BATCH).astype(
                        np.int32),
                    "weight": w})
    return out


def host_copy(tree):
    """Numpy copies of a pytree's arrays (the JAX step donates its input
    state, so a zero-copy view would change under the next step)."""
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def jax_config(wire, cap, accum, overlap):
    return JaxTrainConfig(seed=0, print_freq=1000, grad_accum=accum,
                          bucket_cap_mb=cap, wire_dtype=wire,
                          overlap_grad_sync=overlap, fused_quantize=False)


@pytest.fixture(scope="module")
def jax_runs(devices):
    return run_jax_cases(devices)


def run_jax_cases(devices):
    """Per case: (initial params and stats, final JAX state, per-step
    metrics)."""
    mesh2 = build_mesh(MeshSpec(data=2), devices=devices[:2])
    runs = {}
    for case in CASES:
        jt = JaxTrainer(JaxImageTask(CIFAR10_MEAN, CIFAR10_STD,
                                     augment=False), mesh2,
                        jax_config(*case))
        jstate = jt.init_state(jax_get_model("resnet18", **MODEL_KW),
                               np.zeros((1, HW, HW, 3), np.float32),
                               jax_make_optimizer("sgd", LR),
                               jax.random.PRNGKey(0))
        init = (host_copy(jstate.params), host_copy(jstate.batch_stats))
        metrics = []
        for b in global_batches():
            jstate, m = jt._train_step(jstate, shard_batch(b, mesh2),
                                       jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
        runs[case] = (init, jstate, metrics)
    return runs


@pytest.fixture(scope="module")
def port_ranks(jax_runs, tmp_path_factory):
    return run_port_cases(jax_runs, tmp_path_factory.mktemp("dp"))


def run_port_cases(jax_runs, tmp_path):
    """Every case on 2 port ranks, plus two refusals."""
    jobs = {}
    for case, ((params, stats), *_) in jax_runs.items():
        wire, cap, accum, overlap = case
        jobs[case] = ("train", dict(
            model_kwargs=MODEL_KW, params=params, batch_stats=stats,
            mean=CIFAR10_MEAN, std=CIFAR10_STD, lr=LR,
            batches=global_batches(),
            config=dict(grad_accum=accum, bucket_cap_mb=cap,
                        wire_dtype=wire, overlap_grad_sync=overlap)))
    jobs["implicit"] = ("refuse", dict(config={}))
    jobs["bf16"] = ("refuse", dict(config=dict(wire_dtype="bf16")))
    return run_ranks(tmp_path, 2, jobs)


def leaves(tree):
    return {path: np.asarray(v) for path, v in iter_flax_leaves(tree)}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dp_trajectory_matches_jax_trainer(jax_runs, port_ranks, case):
    (params0, _), jstate, jmetrics = jax_runs[case]
    wire = case[0]
    r0, r1 = (r[case] for r in port_ranks)
    assert r0["step"] == r1["step"] == int(jstate.step) == STEPS
    for ours, ref in zip(r0["metrics"], jmetrics):
        assert ours["weight"] == ref["weight"] == GLOBAL_BATCH - 2
        np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                   rtol=LOSS_RTOL)
    # the update is replicated: both ranks hold the same bits
    for tree in ("params", "batch_stats"):
        a, b = leaves(r0[tree]), leaves(r1[tree])
        assert a.keys() == b.keys()
        for path in a:
            np.testing.assert_array_equal(a[path], b[path])
    atol = PARAM_ATOL
    if wire != "fp32":
        # one int8 code step of the largest bucket scale, through
        # lr x (1 + 0.9 + 0.81) over the 3 steps, per hop of the wire
        start = leaves(params0)
        step = max(np.abs(leaves(jax.device_get(jstate.params))[p]
                          - start[p]).max() for p in start)
        atol += (2 if wire == "int8_multihop" else 1) * step / 127 * 3
    moved = 0.0
    ours, ref = leaves(r0["params"]), leaves(jax.device_get(jstate.params))
    assert ours.keys() == ref.keys()
    for path, want in ref.items():
        moved = max(moved, float(np.abs(want - leaves(params0)[path]).max()))
        np.testing.assert_allclose(ours[path], want, atol=atol,
                                   rtol=PARAM_RTOL, err_msg=str(path))
    assert moved > 10 * PARAM_ATOL
    ours = leaves(r0["batch_stats"])
    ref = leaves(jax.device_get(jstate.batch_stats))
    for path, want in ref.items():
        np.testing.assert_allclose(ours[path], want, atol=atol,
                                   rtol=PARAM_RTOL, err_msg=str(path))
    if wire != "fp32":
        ef = np.asarray(jstate.grad_sync["ef"])
        for rank, r in enumerate((r0, r1)):
            assert r["ef"]["ef"].shape == ef[rank].shape
            diff = np.abs(r["ef"]["ef"] - ef[rank])
            assert diff.max() <= 2 * np.abs(ef[rank]).max()
            assert (diff <= PARAM_ATOL).mean() >= EF_TIGHT


def test_implicit_multi_rank_path_raises(port_ranks):
    for r in port_ranks:
        assert "implicit" in r["implicit"] and "SyncBN" in r["implicit"]
        assert "bf16" in r["bf16"]


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

RESNET_CLI = ["--device", "cpu", "--model", "resnet18", "--model-overrides",
              "num_filters=8", "--synthetic", "--synthetic-size", "48",
              "--batch-size", "8", "--epochs", "2", "--print-freq", "1",
              "--lr", "0.05", "--no-telemetry"]


def jax_param_count(**kw):
    shapes = jax.eval_shape(lambda: jax_get_model("resnet18", **kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))


def test_torchrun_two_ranks_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])),
        OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "distributed_pytorch_training_tpu_torch.train", *RESNET_CLI,
         "--wire-dtype", "int8", "--bucket-cap-mb", str(CAP),
         "--output-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert ("Using device: cpu (mesh {'data': 2}), world_size=2, "
            "amp=False, backend=gloo") in out
    assert ("Gradient sync: explicit bucketed reducer over 2 shards — "
            f"bucket_cap_mb={CAP}, wire=int8, overlap=on") in out
    assert "Gradient sync: 3 bucket(s) over 0.7 MB of fp32 gradient" in out
    assert f"Model resnet18: {jax_param_count(num_filters=8):,} params" in out
    # 48 samples / global batch 16: 3 steps an epoch; rank 0 logs alone
    assert out.count("Epoch [1] Step [3/3] Loss: ") == 1
    assert out.count("[Epoch 2/2] Train: loss=") == 1
    lines = (tmp_path / "metrics_rank0.csv").read_text().splitlines()
    assert lines[0] == MetricsCSV.HEADER.strip()
    losses = [float(ln.split(",")[1]) for ln in lines[1:]]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_one_rank_resnet_run_through_main(tmp_path, capsys):
    """One process: the int8 wire is an identity passthrough (logged)."""
    state = train.main(RESNET_CLI + ["--wire-dtype", "int8",
                                     "--grad-accum", "2",
                                     "--output-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "NOTE: explicit gradient sync requested on a single batch " \
           "shard" in out
    assert "NOTE: using synthetic data (cifar10-synthetic, n=48)" in out
    assert "Epoch [1] Step [6/6] Loss: " in out
    assert state.step == 12 and state.grad_sync == {}
    assert len((tmp_path / "metrics_rank0.csv").read_text()
               .splitlines()) == 3


@pytest.mark.parametrize("flags,match", [
    (["--wire-dtype", "bf16"], "bf16"),
    (["--wire-dtype", "int8_hier"], "--slices"),
    (["--slices", "2"], "--slices"),
    (["--zero1"], "ZeRO-1"),
    (["--fsdp-explicit"], "ZeRO-1"),
    (["--mesh", "data=1,model=2"], "--mesh"),
    (["--model", "vit_base"], "vit_base"),
    (["--download"], "fetches nothing"),
], ids=lambda x: x if isinstance(x, str) else "_".join(x))
def test_unported_image_flags_raise(tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        train.main(RESNET_CLI + flags + ["--output-dir", str(tmp_path)])
    assert not (tmp_path / "metrics_rank0.csv").exists()
