"""The port's data-parallel training path against the JAX package's: 3-step
Trainer trajectories on 2 gloo ranks against the JAX Trainer on a
2-device CPU mesh, on the implicit path (the defaults: global-batch
BatchNorm, one fp32 all-reduce) and through the explicit bucketed reducer
and its fp32, bf16, int8 and int8_multihop wires, with and without
gradient accumulation and overlap; one BatchNorm over 2 ranks against one
process over the whole batch; then the entry point under ``torchrun`` on
the CPU, and what it still refuses.

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
elements at the first step, measured); on the bf16 wire, likewise, an
element at a bf16 rounding boundary, one bf16 step (2**-7 of it) apart.
Such an element moves by one code step of its bucket's scale, and the
parameters then differ by up to lr x (1 + momentum + momentum^2) x that
step / W; the int8 and bf16 legs are held to PARAM_ATOL plus that bound
per step and per hop of the wire, with the scale taken as the largest
parameter movement over 127 (over 128 for bf16's step). The error-feedback
residual of a flipped element differs by one code step, at most twice the
reference's largest |residual| (a residual lies within half a step); the
others stay within PARAM_ATOL (EF_TIGHT of the elements at least). The
small lr keeps a flipped code's effect (about 6e-6) below PARAM_ATOL, so
it does not shift the next steps' gradients into further flips: at lr
1e-2 that cascade reached 2e-3 in the parameters after 3 steps
(measured), a property of a quantized trajectory, not of the port.

The implicit path's parameters and statistics are held to IMPLICIT_ATOL =
1e-4 (+ PARAM_RTOL): global-batch BatchNorm takes E[x^2] - E[x]^2 of
moments summed over ranks, whose float32 reassociation its cancellation
amplifies. The JAX Trainer itself moves by up to 9.2e-5 between a 1- and
a 2-device mesh on these batches (measured, grad_accum 1); the port, at
accumulation 2, by up to 1.9e-5. The implicit path normalizes by the
global batch, the explicit reducer by each rank's half: the same run on
the two paths must differ by more than that tolerance, or the test could
not tell them apart. The
cross-rank BatchNorm alone: within BN_ATOL = 1e-5 of the largest
magnitude of each output, float32 reassociation of the per-rank partial
sums.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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
from distributed_pytorch_training_tpu_torch.models.resnet import BatchNorm
from distributed_pytorch_training_tpu_torch.utils import MetricsCSV

from _torch_dp_worker import run_ranks
from _torch_rig import port_process_state  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
EF_TIGHT = 0.95
IMPLICIT_ATOL = 1e-4
BN_ATOL = 1e-5
MODEL_KW = dict(num_filters=8, cifar_stem=True)
HW, GLOBAL_BATCH, STEPS, LR = 16, 16, 3, 0.001
CAP = 0.25            # MB: the narrow model's 0.7 MB gradient in 3 buckets

# (wire, bucket_cap_mb, grad_accum, overlap): the explicit reducer
CASES = [
    ("fp32", CAP, 1, True),
    ("int8", 0.0, 1, True),
    ("int8_multihop", CAP, 1, True),
    ("int8", CAP, 2, True),
    ("int8_multihop", 0.0, 2, False),
    ("fp32", CAP, 2, False),
    ("bf16", CAP, 1, True),
]
IDS = [f"{w}-{'cap' if c else 'one-bucket'}-accum{a}"
       + ("" if a == 1 else "-overlap-" + ("on" if o else "off"))
       for w, c, a, o in CASES]
# the implicit path: the defaults, --wire-dtype fp32 --bucket-cap-mb 0
IMPLICIT_CASES = [("fp32", 0.0, 1, True), ("fp32", 0.0, 2, True)]
IMPLICIT_IDS = ["accum1", "accum2"]


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
    for case in CASES + IMPLICIT_CASES:
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
    """Every case on 2 port ranks, and the cross-rank BatchNorm."""
    jobs = {}
    for case, ((params, stats), *_) in jax_runs.items():
        wire, cap, accum, overlap = case
        jobs[case] = ("train", dict(
            model_kwargs=MODEL_KW, params=params, batch_stats=stats,
            mean=CIFAR10_MEAN, std=CIFAR10_STD, lr=LR,
            batches=global_batches(),
            config=dict(grad_accum=accum, bucket_cap_mb=cap,
                        wire_dtype=wire, overlap_grad_sync=overlap)))
    jobs["bn"] = ("bn", bn_inputs())
    return run_ranks(tmp_path, 2, jobs)


def bn_inputs():
    """One BatchNorm's inputs: x (8, 4, 3, 3) off-centre, so that E[x^2]
    and E[x]^2 differ in size; the upstream gradient; scale and bias."""
    rng = np.random.RandomState(3)
    return {"x": (rng.randn(8, 4, 3, 3) * 2 + 1).astype(np.float32),
            "dy": rng.randn(8, 4, 3, 3).astype(np.float32),
            "scale": (rng.rand(4) + 0.5).astype(np.float32),
            "bias": rng.randn(4).astype(np.float32)}


def leaves(tree):
    return {path: np.asarray(v) for path, v in iter_flax_leaves(tree)}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dp_trajectory_matches_jax_trainer(jax_runs, port_ranks, case):
    check_trajectory(jax_runs, port_ranks, case)


@pytest.mark.parametrize("case", IMPLICIT_CASES, ids=IMPLICIT_IDS)
def test_implicit_trajectory_matches_jax_trainer(jax_runs, port_ranks,
                                                 case):
    """The reference's default command: global-batch BatchNorm, one fp32
    all-reduce; under accumulation each microbatch's BatchNorm is global
    too (JAX splits the global batch)."""
    check_trajectory(jax_runs, port_ranks, case)


def check_trajectory(jax_runs, port_ranks, case):
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
    atol = IMPLICIT_ATOL if case in IMPLICIT_CASES else PARAM_ATOL
    if wire != "fp32":
        # one int8 code step of the largest bucket scale, through
        # lr x (1 + 0.9 + 0.81) over the 3 steps, per hop of the wire
        start = leaves(params0)
        step = max(np.abs(leaves(jax.device_get(jstate.params))[p]
                          - start[p]).max() for p in start)
        atol += {"bf16": 3 / 128, "int8": 3 / 127,
                 "int8_multihop": 6 / 127}[wire] * step
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
    if wire.startswith("int8"):
        ef = np.asarray(jstate.grad_sync["ef"])
        for rank, r in enumerate((r0, r1)):
            assert r["ef"]["ef"].shape == ef[rank].shape
            diff = np.abs(r["ef"]["ef"] - ef[rank])
            assert diff.max() <= 2 * np.abs(ef[rank]).max()
            assert (diff <= PARAM_ATOL).mean() >= EF_TIGHT


def test_implicit_path_differs_from_per_rank_batchnorm(port_ranks):
    """The same 3 steps with global-batch BatchNorm (implicit) and with
    each rank's own (the explicit fp32 reducer): they differ beyond the
    trajectory tolerance, so the legs above tell the two apart."""
    implicit, explicit = (port_ranks[0][c] for c in
                          (IMPLICIT_CASES[0], CASES[0]))
    for tree in ("params", "batch_stats"):
        a, b = leaves(implicit[tree]), leaves(explicit[tree])
        assert any(not np.allclose(a[p], b[p], atol=IMPLICIT_ATOL,
                                   rtol=PARAM_RTOL) for p in a)
    assert abs(implicit["metrics"][1]["loss_sum"]
               - explicit["metrics"][1]["loss_sum"]) > LOSS_RTOL * abs(
                   explicit["metrics"][1]["loss_sum"])


def test_cross_rank_batchnorm_equals_one_process(port_ranks):
    """BatchNorm over 2 ranks (one all-reduce of the per-channel sums
    forward, of their gradients backward) against one process's BatchNorm
    over the concatenated batch: output, new statistics, and the gradients
    of x, scale and bias (summed over ranks, as the step sums them)."""
    spec = bn_inputs()
    bn = BatchNorm(4)
    bn.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(spec["scale"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    bn.stats_name = ""
    x = torch.from_numpy(spec["x"]).requires_grad_()
    new_stats = {}
    y = bn(x, new_stats)
    (y * torch.from_numpy(spec["dy"])).sum().backward()
    r0, r1 = (r["bn"] for r in port_ranks)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BN_ATOL * np.abs(want).max())

    close(np.concatenate([r0["y"], r1["y"]]), y.detach())
    close(np.concatenate([r0["dx"], r1["dx"]]), x.grad)
    close(r0["dscale"] + r1["dscale"], bn.scale.grad)
    close(r0["dbias"] + r1["dbias"], bn.bias.grad)
    for name in ("mean", "var"):
        np.testing.assert_array_equal(r0[name], r1[name])
        close(r0[name], new_stats[name])
    # the per-rank statistics are not the global ones
    half = BatchNorm(4)
    half.reset_parameters(torch.Generator().manual_seed(0))
    half_stats = {}
    half(x[:4].detach(), half_stats)
    assert not np.allclose(half_stats["var"].numpy(), r0["var"],
                           rtol=1e-3)


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
    """Two gloo ranks through torchrun, every rank streaming telemetry
    (--telemetry-all-ranks): the banners, the CSV, and one stream a rank
    that `telemetry aggregate` merges, each with the int8 wire's
    accounting row."""
    from distributed_pytorch_training_tpu_torch.telemetry.aggregate import (
        aggregate_streams,
    )

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])),
        OMP_NUM_THREADS="1")
    cli = [f for f in RESNET_CLI if f != "--no-telemetry"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "distributed_pytorch_training_tpu_torch.train", *cli,
         "--wire-dtype", "int8", "--bucket-cap-mb", str(CAP),
         "--telemetry-all-ranks", "--output-dir", str(tmp_path)],
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
    streams = [tmp_path / f"telemetry_rank{r}.jsonl" for r in range(2)]
    agg = aggregate_streams([str(p) for p in streams])
    assert agg["n_streams"] == 2
    for rank, path in enumerate(streams):
        events = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert {ev["rank"] for ev in events} == {rank}
        wire, = [ev for ev in events
                 if ev["name"] == "wire_bytes_per_replica"]
        assert (wire["tier"], wire["wire_dtype"], wire["n_shards"]) == \
            ("ici", "int8", 2) and wire["value"] > 0
        assert sum(ev["name"] == "step_dispatch" for ev in events) == 6


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


def _image_refusal_id(case):
    flags, error, match = case
    # the model-axis case keeps the name it had while --mesh with a model
    # axis was refused outright (tensor parallelism is ported: a model
    # axis of 2 in one process is now the JAX mesh's size error, and a
    # ResNet on a model axis the JAX validate_mesh_usage's, which
    # tests/test_torch_tp.py holds)
    if flags == ["--mesh", "data=1,model=2"]:
        return "--mesh_data=1,model=2-NotImplementedError---mesh"
    return "-".join(["_".join(flags), error.__name__, match])


IMAGE_REFUSED = [
    # the JAX Trainer's incompatible update modes, its messages
    (["--zero1", "--bucket-cap-mb", "25"], ValueError,
     "zero1's per-leaf flat-shard layout IS its optimizer-state"),
    (["--fsdp-explicit", "--zero1"], ValueError,
     "fsdp_explicit IS zero1 plus flat-sharded parameters"),
    (["--fsdp-explicit", "--bucket-cap-mb", "25"], ValueError,
     "use fsdp_explicit with wire_dtype compression instead"),
    # --slices must divide the world (the JAX mesh's message)
    (["--slices", "3", "--wire-dtype", "int8_hier"], ValueError,
     "1 devices not divisible by fixed axes product 3"),
    (["--wire-dtype", "int8_hier", "--slice-axis", "seq"], ValueError,
     "int8_hier syncs over the batch axes"),
    (["--mesh", "data=1,model=2"], ValueError,
     "needs 2 devices but 1 are present"),
    (["--model", "vit_base"], NotImplementedError, "vit_base"),
    (["--download"], NotImplementedError, "fetches nothing"),
]


@pytest.mark.parametrize("flags,error,match", IMAGE_REFUSED,
                         ids=[_image_refusal_id(c) for c in IMAGE_REFUSED])
def test_unported_image_flags_raise(tmp_path, flags, error, match):
    with pytest.raises(error, match=match):
        train.main(RESNET_CLI + flags + ["--output-dir", str(tmp_path)])
    assert not (tmp_path / "metrics_rank0.csv").exists()
