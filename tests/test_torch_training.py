"""The port's training path against the JAX package's.

The same numpy-seeded inputs go to both packages: the CLI defaults, the
sampler's index and weight plans, the synthetic tokens, the metrics CSV,
the optimizers' learning-rate schedules, and a 3-step trajectory of the
port's Trainer against the JAX Trainer from the same (converted) flax
weights. Then the port's entry point runs end to end on the CPU at a tiny
size.

Tolerances:
* plans, tokens and CSV bytes are compared bitwise;
* LOSS_RTOL = 1e-5 on the per-step losses: both sides compute in float32
  and differ only by reassociation (measured below 1e-6);
* the final parameters within PARAM_ATOL = 1e-5 + PARAM_RTOL = 1e-4
  (measured below 3e-7), with one exception under AdamW: the attention
  KEY bias. Its exact gradient is zero (adding one vector to every key
  shifts each softmax row by a constant), so both sides see only float32
  rounding noise there, and AdamW, which divides each gradient by its own
  running RMS, turns that noise into steps of up to lr either way. Those
  entries are held to 2 * lr * steps, the most such steps can move them.
* bf16 compute: a 3-step SGD trajectory against the JAX Trainer run op
  by op (``jax.disable_jit``: flax's bf16 rounding, which a jitted CPU
  program relaxes in fused chains), within BF16_GAP_FRACTION = 0.9 of the
  JAX Trainer's own bf16-vs-float32 distance on the same batches,
  measured in the test (the largest difference over the parameters). The
  forward is bitwise flax's (test_torch_gpt2.py); the backward's bf16
  products sum in other orders on each side, so some gradients round to
  the neighbouring bf16 number and the steps carry that on: the port sits
  at 0.77 of the gap (measured). A port computing in float32 sits at 1.0
  of it and fails.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.data.sampler import (
    ShardedSampler as JaxSampler,
)
from distributed_pytorch_training_tpu.data.text import (
    get_token_dataset as jax_get_token_dataset,
    synthetic_token_dataset as jax_synthetic_tokens,
)
from distributed_pytorch_training_tpu import native as jax_native
from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.ops.flash_attention import (
    make_flash_attention_fn as jax_flash_fn,
)
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import shard_batch
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
    make_schedule as jax_make_schedule,
)
from distributed_pytorch_training_tpu.training.loop import (
    split_microbatches as jax_split_microbatches,
)
from distributed_pytorch_training_tpu.training.tasks import (
    LanguageModelingTask as JaxLMTask,
)
from distributed_pytorch_training_tpu.utils.config import (
    parse_args as jax_parse_args,
)
from distributed_pytorch_training_tpu.utils.metrics import (
    MetricsCSV as JaxMetricsCSV,
)
from distributed_pytorch_training_tpu_torch import native, train
from distributed_pytorch_training_tpu_torch.convert import (
    iter_flax_leaves,
    load_flax_params,
    torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.data.sampler import ShardedSampler
from distributed_pytorch_training_tpu_torch.data.text import (
    TokenLoader,
    get_token_dataset,
    synthetic_token_dataset,
)
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.ops.flash_attention import (
    make_flash_attention_fn,
)
from distributed_pytorch_training_tpu_torch.runtime import (
    choose_backend,
    per_process_seed,
    setup_distributed,
)
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig,
    Trainer,
    make_optimizer,
    make_schedule,
)
from distributed_pytorch_training_tpu_torch.training.loop import (
    split_microbatches,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    LanguageModelingTask,
)
from distributed_pytorch_training_tpu_torch.utils import MetricsCSV, parse_args
from _torch_rig import port_process_state  # noqa: F401

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
PARAM_RTOL = 1e-4

SEQ = 16
TINY = dict(vocab_size=97, hidden_dim=32, depth=2, num_heads=2,
            max_position=SEQ)


# ---------------------------------------------------------------------------
# config, runtime, data
# ---------------------------------------------------------------------------


def test_parse_args_defaults_equal_the_jax_package():
    ours = vars(parse_args([]))
    assert ours.pop("device") is None
    assert ours == vars(jax_parse_args([]))


def test_parse_args_same_values_for_a_command_line():
    argv = ["--model", "gpt2_124m", "--attention", "flash", "--seq-len",
            "64", "--grad-accum", "2", "--optimizer", "adamw", "--lr",
            "3e-4", "--schedule", "cosine", "--warmup-steps", "5",
            "--synthetic", "--no-telemetry", "--drop-last"]
    ours = vars(parse_args(argv))
    ours.pop("device")
    assert ours == vars(jax_parse_args(argv))


@pytest.mark.parametrize("seed,n", [(0, 1), (42, 2), (7, 33), (2 ** 40 + 3,
                                                               1000)])
def test_permutation_bitwise(seed, n):
    got = native.permutation(seed, n)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_native.permutation(seed, n))
    np.testing.assert_array_equal(got, jax_native._permutation_py(seed, n))


def test_gather_rows_checks_bounds():
    src = np.arange(12, dtype=np.int32).reshape(4, 3)
    np.testing.assert_array_equal(native.gather_rows(src, [3, 0, 3]),
                                  src[[3, 0, 3]])
    with pytest.raises(IndexError):
        native.gather_rows(src, [-1])


@pytest.mark.parametrize("n,batch,shuffle,drop_last", [
    (37, 8, True, False), (37, 8, False, False), (37, 8, True, True),
    (32, 8, True, False), (5, 8, True, False)],
    ids=["shuffle", "no-shuffle", "drop-last", "exact", "one-short-batch"])
def test_sampler_plans_bitwise(n, batch, shuffle, drop_last):
    for epoch in range(3):
        ours = ShardedSampler(n=n, global_batch=batch, shuffle=shuffle,
                              seed=42, drop_last=drop_last)
        ref = JaxSampler(n=n, global_batch=batch, shuffle=shuffle, seed=42,
                         drop_last=drop_last)
        assert ours.steps_per_epoch() == ref.steps_per_epoch()
        (idx, w), (idx_r, w_r) = (ours.epoch_indices(epoch),
                                  ref.epoch_indices(epoch))
        assert idx.dtype == idx_r.dtype and w.dtype == w_r.dtype
        np.testing.assert_array_equal(idx, idx_r)
        np.testing.assert_array_equal(w, w_r)
        steps = list(ours.iter_epoch(epoch, start_step=1))
        assert len(steps) == ours.steps_per_epoch() - 1


def test_synthetic_tokens_bitwise():
    ours = synthetic_token_dataset(16, 24, 50257, seed=3)
    ref = jax_synthetic_tokens(16, 24, 50257, seed=3)
    assert ours.tokens.dtype == ref.tokens.dtype == np.int32
    np.testing.assert_array_equal(ours.tokens, ref.tokens)
    for is_train in (True, False):
        a = get_token_dataset("gpt2", 32, "/nonexistent", train=is_train,
                              synthetic_size=8, seed=42)
        b = jax_get_token_dataset("gpt2", 32, "/nonexistent",
                                  train=is_train, synthetic_size=8, seed=42)
        assert (a.name, a.vocab_size, a.synthetic) == (b.name, b.vocab_size,
                                                       b.synthetic)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_token_file_loads_like_the_jax_package(tmp_path):
    flat = np.random.RandomState(0).randint(0, 50257, 1000).astype(np.int64)
    np.save(tmp_path / "gpt2_train.npy", flat)
    a = get_token_dataset("gpt2", 64, str(tmp_path), train=True)
    b = jax_get_token_dataset("gpt2", 64, str(tmp_path), train=True)
    assert not a.synthetic and a.tokens.shape == (15, 64)
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_token_loader_batches_follow_the_sampler():
    ds = synthetic_token_dataset(10, 8, 97, seed=1)
    loader = TokenLoader(ds, 4, shuffle=True, seed=5, device="cpu")
    plan = ShardedSampler(n=10, global_batch=4, shuffle=True, seed=5)
    batches = list(loader.epoch(2))
    assert len(batches) == len(loader) == 3
    for batch, (idx, w) in zip(batches, plan.iter_epoch(2)):
        assert batch["input_ids"].dtype == torch.int32
        np.testing.assert_array_equal(batch["input_ids"].numpy(),
                                      ds.tokens[idx])
        np.testing.assert_array_equal(batch["weight"].numpy(), w)
    assert batches[-1]["weight"].tolist() == [1.0, 1.0, 0.0, 0.0]


def test_metrics_csv_bytes_identical(tmp_path):
    rows = [(0, 10.123456, 1.23456, 9.87654, 2.5, 12.3456789),
            (1, 8.5, 3.0, 8.25, 4.125, 11.0)]
    ours, ref = MetricsCSV(tmp_path / "a"), JaxMetricsCSV(tmp_path / "b")
    for r in rows:
        ours.append(*r)
        ref.append(*r)
    assert ours.path.read_bytes() == ref.path.read_bytes()
    assert ours.path.read_text().startswith(MetricsCSV.HEADER)


def test_single_process_runtime(monkeypatch, tmp_path):
    assert per_process_seed(42, 3) == 45
    assert setup_distributed().process_count == 1
    # more ranks join a process group (test_torch_dp_training.py runs
    # them): NCCL when every local rank has a card, else gloo
    assert choose_backend("cuda", 1, 1) == choose_backend("cuda", 4, 4) \
        == "nccl"
    assert choose_backend("cuda", 2, 1) == choose_backend("cpu", 2, 0) \
        == "gloo"


# ---------------------------------------------------------------------------
# optimizer schedules and microbatches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,warmup", [("constant", 0),
                                         ("linear_warmup", 3),
                                         ("cosine", 2)])
def test_schedules_match_optax(name, warmup):
    ours = make_schedule(name, 0.1, total_steps=10, warmup_steps=warmup)
    ref = jax_make_schedule(name, 0.1, total_steps=10, warmup_steps=warmup)
    for count in range(12):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-9)


def test_lr_follows_optax_update_count():
    """optax reads the schedule at the count BEFORE it increments, so
    linear_warmup's first update has lr 0: the port's first step must not
    move a parameter."""
    p = torch.nn.Parameter(torch.ones(3))
    tx = make_optimizer("sgd", make_schedule("linear_warmup", 0.5,
                                             warmup_steps=2),
                        momentum=0.0, weight_decay=0.0)
    opt = tx.init([p])
    lrs = []
    for count in range(3):
        p.grad = torch.ones(3)
        tx.apply(opt, count)
        lrs.append(opt.param_groups[0]["lr"])
        if count == 0:
            assert torch.equal(p.detach(), torch.ones(3))
    assert lrs == [0.0, 0.25, 0.5]


def test_split_microbatches_interleaves_like_jax():
    ids = np.arange(24, dtype=np.int32).reshape(6, 4)
    w = np.arange(6, dtype=np.float32)
    ours = split_microbatches({"input_ids": torch.from_numpy(ids),
                               "weight": torch.from_numpy(w)}, 3)
    ref = jax_split_microbatches({"input_ids": jnp.asarray(ids),
                                  "weight": jnp.asarray(w)}, 3)
    for name in ("input_ids", "weight"):
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(ref[name]))
    np.testing.assert_array_equal(ours["weight"][1].numpy(), w[1::3])
    with pytest.raises(ValueError, match="not divisible"):
        split_microbatches({"weight": torch.zeros(5)}, 2)


# ---------------------------------------------------------------------------
# the trajectory: port Trainer against the JAX Trainer
# ---------------------------------------------------------------------------


def _batches(n_steps, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        w = np.ones(batch, np.float32)
        w[-3:] = 0.0            # padding rows: weighted out of the loss
        out.append({"input_ids": rng.randint(0, TINY["vocab_size"],
                                              (batch, SEQ)).astype(np.int32),
                    "weight": w})
    return out


# (attention, optimizer, schedule, grad_accum): every attention, optimizer
# and accumulation depth appears, and linear_warmup pins the lr-0 first step
TRAJECTORIES = [
    pytest.param("xla", "sgd", "constant", 1, id="xla-sgd"),
    pytest.param("xla", "adamw", "linear_warmup", 2,
                 id="xla-adamw-warmup-accum2"),
    pytest.param("flash", "sgd", "constant", 2, id="flash-sgd-accum2"),
    pytest.param("flash", "adamw", "constant", 1, id="flash-adamw"),
]


@pytest.mark.parametrize("attention,opt,schedule,accum", TRAJECTORIES)
def test_trainer_trajectory_matches_jax(mesh8, attention, opt, schedule,
                                        accum):
    steps, lr = 3, (0.05 if opt == "sgd" else 3e-3)
    batches = _batches(steps)

    # the JAX Trainer on its 8-device test mesh, global batch 16
    jax_kw = dict(TINY)
    if attention == "flash":
        jax_kw["attention_fn"] = jax_flash_fn(causal=True)
    jm = jax_get_model("gpt2_124m", **jax_kw)
    jt = JaxTrainer(JaxLMTask(), mesh8,
                    JaxTrainConfig(seed=0, print_freq=1000,
                                   grad_accum=accum))
    jtx = jax_make_optimizer(opt, jax_make_schedule(schedule, lr,
                                                    warmup_steps=2))
    jstate = jt.init_state(jm, np.zeros((1, SEQ), np.int32), jtx,
                           jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate.params)

    # the port in one process, from the same weights
    kw = dict(TINY)
    if attention == "flash":
        kw["attention_fn"] = make_flash_attention_fn(causal=True)
    model = get_model("gpt2_124m", **kw)
    load_flax_params(model, params0)
    trainer = Trainer(LanguageModelingTask(),
                      TrainConfig(seed=0, print_freq=1000, grad_accum=accum),
                      device="cpu")
    state = trainer.init_state(model, make_optimizer(
        opt, make_schedule(schedule, lr, warmup_steps=2)))

    key = jax.random.PRNGKey(0)
    for batch in batches:
        jstate, jm_metrics = jt._train_step(jstate, shard_batch(batch, mesh8),
                                            key)
        metrics = trainer.train_step(state, {
            name: torch.from_numpy(x) for name, x in batch.items()})
        assert float(metrics["weight"]) == float(jm_metrics["weight"]) \
            == 13 * (SEQ - 1)
        np.testing.assert_allclose(
            float(metrics["loss_sum"]) / float(metrics["weight"]),
            float(jm_metrics["loss_sum"]) / float(jm_metrics["weight"]),
            rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == steps

    ours = dict(iter_flax_leaves(torch_to_flax(state.model)))
    ref = dict(iter_flax_leaves(jax.device_get(jstate.params)))
    assert ours.keys() == ref.keys()
    moved = 0.0
    for path, want in ref.items():
        got, want = ours[path], np.asarray(want)
        moved = max(moved, float(np.abs(want - leaf_of(params0, path))
                                 .max()))
        if opt == "adamw" and path[-2:] == ("qkv", "bias"):
            # the key bias, (3, H, D)[1]: held apart (module docstring)
            assert np.abs(got[1] - want[1]).max() <= 2 * lr * steps
            got, want = got[[0, 2]], want[[0, 2]]
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=str(path))
    assert moved > 10 * PARAM_ATOL      # the steps did move the weights


def leaf_of(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

# vocab 50257: the synthetic corpus carries GPT-2's ids, and the entry
# refuses a model vocab below them, as the JAX entry does
TINY_CLI = ["--device", "cpu", "--model", "gpt2_124m", "--model-overrides",
            "vocab_size=50257,hidden_dim=32,depth=2,num_heads=2,"
            "max_position=32", "--seq-len", "32", "--synthetic",
            "--synthetic-size", "32", "--epochs", "2", "--optimizer",
            "adamw", "--lr", "1e-3", "--batch-size", "4", "--print-freq",
            "2"]


def test_entry_point_trains_on_cpu(tmp_path, capsys):
    train.main(TINY_CLI + ["--output-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "NOTE: using synthetic data (gpt2-synthetic, n=32)" in out
    # telemetry is on by default: rank 0's stream beside the CSV
    assert (tmp_path / "telemetry_rank0.jsonl").is_file()
    # the JAX entry's banner counts the flax model's parameters
    shapes = jax.eval_shape(
        lambda: jax_get_model("gpt2_124m", vocab_size=50257, hidden_dim=32,
                              depth=2, num_heads=2, max_position=32).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32),
            train=False))
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert f"Model gpt2_124m: {n_params:,} params\n" in out
    assert "Epoch [1] Step [8/8] Loss: " in out
    assert "[Epoch 2/2] Train: loss=" in out and "| Val: loss=" in out
    lines = (tmp_path / "metrics_rank0.csv").read_text().splitlines()
    assert lines[0] == MetricsCSV.HEADER.strip()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "2"]
    train_losses = [float(ln.split(",")[1]) for ln in lines[1:]]
    assert all(np.isfinite(train_losses))
    assert train_losses[1] < train_losses[0]


def test_entry_point_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pytorch_training_tpu_torch.train",
         *TINY_CLI, "--epochs", "1", "--no-telemetry", "--output-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "telemetry" not in proc.stdout
    assert len((tmp_path / "metrics_rank0.csv").read_text()
               .splitlines()) == 2


ELASTIC = "comes with the elastic slice"
REFUSED = [
    # --remat is ported for the transformers; a ResNet refuses it with the
    # JAX entry's message
    (["--model", "resnet18", "--remat"], ValueError,
     "--remat applies to transformer models"),
    # a mesh the one rank cannot fill: the JAX mesh's message
    (["--mesh", "data=2"], ValueError, "needs 2 devices but 1 are present"),
    # the JAX entry's mesh checks of --slices and --slice-axis, its
    # messages (--slices folds the slice axis into the mesh)
    (["--slices", "2"], ValueError,
     "1 devices not divisible by fixed axes product 2"),
    (["--slices", "0"], ValueError, "axis sizes must be >= 1"),
    (["--wire-dtype", "int8_hier", "--slice-axis", "model"], ValueError,
     "slice_axis='model' is not one of them"),
    # the JAX entry's checks of the checkpoint flags, its messages
    (["--resume"], ValueError, "--resume requires --checkpoint-dir"),
    (["--max-restarts", "1"], ValueError,
     "--max-restarts requires --checkpoint-dir"),
    (["--max-restarts", "-1"], ValueError, "--max-restarts must be >= 0"),
    (["--chaos", "replica_death@step=1"], NotImplementedError, ELASTIC),
    (["--chaos", "capacity_return@step=1"], NotImplementedError, ELASTIC),
    (["--autopilot"], NotImplementedError, "the autopilot slice"),
    (["--download"], NotImplementedError, "--download"),
    # ring and Ulysses are ported for GPT-2; BERT refuses them with the
    # JAX entry's message
    (["--attention", "ring", "--model", "bert_base"], ValueError,
     "ring/ulysses is causal-only"),
    (["--attention", "ulysses", "--model", "bert_base"], ValueError,
     "ring/ulysses is causal-only"),
]


def _refusal_id(flags, match):
    # the --remat, --mesh and --attention cases keep the names they had
    # while those flags were refused outright
    if "--remat" in flags:
        return "--remat-remat"
    if flags == ["--mesh", "data=2"]:
        return "--mesh_data=2---mesh"
    if flags[0] == "--attention":
        return f"--attention_{flags[1]}-{flags[1]}"
    return "_".join(flags) + "-" + match


@pytest.mark.parametrize("flags,error,match", REFUSED,
                         ids=[_refusal_id(f, m) for f, _, m in REFUSED])
def test_unported_flags_raise(tmp_path, flags, error, match):
    # argparse keeps the last value of a repeated flag
    with pytest.raises(error, match=match):
        train.main(TINY_CLI + flags + ["--output-dir", str(tmp_path)])
    assert not (tmp_path / "metrics_rank0.csv").exists()


# ---------------------------------------------------------------------------
# telemetry: the event stream, the profiler, /metrics, the watchdog
# ---------------------------------------------------------------------------

# (kind, name) the JAX entry emits and the port's does not, with why
JAX_ONLY_EVENTS = {
    ("counter", "compile_cache_enabled"):
        "XLA's persistent compilation cache; the port compiles nothing",
    ("counter", "wire_bytes_per_replica"):
        "emitted only when the batch is sharded over several replicas: "
        "the JAX run shards it over the 8-device CPU mesh, the port's "
        "run is one process (its rows are held to the JAX package's in "
        "test_torch_telemetry.py and on 2 ranks in "
        "test_torch_dp_training.py)",
}
PROFILE = ["--profile-dir", None, "--profile-steps", "1,3"]


def _events_by_step(path):
    import collections

    out = collections.defaultdict(collections.Counter)
    for line in path.read_text().splitlines():
        ev = json.loads(line)
        if (ev["kind"], ev["name"]) not in JAX_ONLY_EVENTS:
            out[ev.get("step")][(ev["kind"], ev["name"])] += 1
    return dict(out)


def test_telemetry_events_per_step_equal_jax(tmp_path, mesh8):
    """Telemetry on (the default), a --profile-dir window over steps 1-2:
    the JAX entry (batch 1 on each of 8 CPU devices) and the port's (batch
    8 in one process; the same 4 steps an epoch) emit the same multiset
    of (kind, name) at every step and outside the steps, but for
    JAX_ONLY_EVENTS; the port writes a trace and a device_profile event
    for the window, and both packages' `telemetry summary` read its
    stream."""
    import importlib

    from distributed_pytorch_training_tpu.telemetry import (
        __main__ as jax_telemetry_cli,
    )
    from distributed_pytorch_training_tpu_torch.telemetry import (
        __main__ as telemetry_cli,
    )

    flags = [f for f in TINY_CLI if f not in ("--device", "cpu")]
    batch = flags.index("--batch-size") + 1
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_train = importlib.import_module("train")
    jax_flags = flags[:batch] + ["1"] + flags[batch + 1:]
    jax_train.main(jax_flags + ["--output-dir", str(jax_dir)]
                   + PROFILE[:1] + [str(jax_dir / "prof")] + PROFILE[2:])
    port_flags = flags[:batch] + ["8"] + flags[batch + 1:]
    train.main(["--device", "cpu"] + port_flags
               + ["--output-dir", str(port_dir)]
               + PROFILE[:1] + [str(port_dir / "prof")] + PROFILE[2:])
    stream = port_dir / "telemetry_rank0.jsonl"
    ours = _events_by_step(stream)
    assert ours == _events_by_step(jax_dir / "telemetry_rank0.jsonl")
    assert set(ours) == {None, 0, 1, 2, 3}
    assert ours[0] == {("span", "data_wait"): 2, ("span", "step_dispatch"): 2}
    assert len(list((port_dir / "prof").glob("*.pt.trace.json"))) == 1
    prof, = [json.loads(ln) for ln in stream.read_text().splitlines()
             if '"device_profile"' in ln]
    assert (prof["start_step"], prof["stop_step"], prof["steps"]) == (1, 3, 2)
    assert prof["window_ms"] > 0
    assert telemetry_cli.main(["summary", str(stream)]) == 0
    assert jax_telemetry_cli.main(["summary", str(stream)]) == 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_port_scrape_and_profile_on_cpu(tmp_path, monkeypatch):
    """--metrics-port: mid-run, /metrics counts the steps, /healthz is
    200, and POST /profile?steps=2 arms a capture that lands under
    <output-dir>/profiles as a device_profile event."""
    import urllib.request

    from distributed_pytorch_training_tpu_torch.training import loop

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    seen = {}
    step = loop.Trainer.train_step

    def scraping_step(self, state, batch):
        n = seen.setdefault("calls", 0)
        seen["calls"] = n + 1
        if n in (2, 6):
            with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
                seen[f"metrics{n}"] = r.read().decode()
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                seen[f"healthz{n}"] = r.status
        if n == 2:
            req = urllib.request.Request(url + "/profile?steps=2",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=5) as r:
                seen["post"] = r.status
        return step(self, state, batch)

    monkeypatch.setattr(loop.Trainer, "train_step", scraping_step)
    train.main(TINY_CLI + ["--epochs", "1", "--metrics-port", str(port),
                           "--output-dir", str(tmp_path)])

    def steps_total(text):
        return float(next(ln.split()[-1] for ln in text.splitlines()
                          if ln.startswith("dpt_steps_total")))

    assert seen["healthz2"] == seen["healthz6"] == 200
    assert steps_total(seen["metrics6"]) > steps_total(seen["metrics2"])
    assert seen["post"] == 202
    captures = list((tmp_path / "profiles").glob("capture_*"))
    assert len(captures) == 1 and list(captures[0].glob("*.pt.trace.json"))
    prof, = [json.loads(ln) for ln in
             (tmp_path / "telemetry_rank0.jsonl").read_text().splitlines()
             if '"device_profile"' in ln]
    assert prof["reason"] == "http" and prof["steps"] == 2


def test_telemetry_abort_leaves_a_flight(tmp_path, monkeypatch):
    """--telemetry-abort: a detected anomaly (here any data wait, under an
    absolute stall bound of 1 ns) raises AnomalyAbort out of train.main,
    which leaves a flight_*.json naming it beside the stream."""
    from distributed_pytorch_training_tpu_torch import telemetry

    monkeypatch.setenv("DPT_WATCHDOG_STALL_ABS_S", "1e-9")
    with pytest.raises(telemetry.AnomalyAbort, match="loader_stall"):
        train.main(TINY_CLI + ["--telemetry-abort", "--output-dir",
                               str(tmp_path)])
    flight, = tmp_path.glob("flight_*.json")
    body = json.loads(flight.read_text())
    assert body["cause"].startswith("AnomalyAbort")
    assert any(ev["kind"] == "anomaly" for ev in body["events"])


def test_attention_auto_resolves_by_device():
    assert train.resolve_attention("auto", "cuda", 1024) == "flash"
    assert train.resolve_attention("auto", "cpu", 1024) == "xla"
    assert train.resolve_attention("flash", "cpu", 1024) == "flash"


@pytest.mark.parametrize("flags", [
    ["--bucket-cap-mb", "25"], ["--wire-dtype", "int8"],
    ["--wire-dtype", "int8_multihop", "--fused-quantize", "on"],
], ids="_".join)
def test_reducer_flags_on_one_rank_are_a_passthrough(tmp_path, capsys,
                                                     flags):
    """The JAX entry's rule: on one batch shard the explicit reducer has
    nothing to synchronize, says so and trains on the implicit path."""
    state = train.main(TINY_CLI + flags + ["--epochs", "1", "--output-dir",
                                           str(tmp_path)])
    assert "NOTE: explicit gradient sync requested on a single batch " \
           "shard" in capsys.readouterr().out
    assert state.step == 8 and state.grad_sync == {}


# ---------------------------------------------------------------------------
# bf16 (--amp)
# ---------------------------------------------------------------------------

BF16_GAP_FRACTION = 0.9


def test_bf16_trajectory_within_the_jax_bf16_gap(devices):
    steps, lr = 3, 0.05
    batches = _batches(steps)
    mesh1 = build_mesh(MeshSpec(data=1), devices=devices[:1])
    finals = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        jt = JaxTrainer(JaxLMTask(compute_dtype=dtype), mesh1,
                        JaxTrainConfig(seed=0, print_freq=1000,
                                       bf16=dtype == jnp.bfloat16))
        jstate = jt.init_state(
            jax_get_model("gpt2_124m", **TINY, dtype=dtype),
            np.zeros((1, SEQ), np.int32),
            jax_make_optimizer("sgd", jax_make_schedule("constant", lr)),
            jax.random.PRNGKey(0))
        if name == "bf16":
            params0 = jax.device_get(jstate.params)
        for batch in batches:
            if name == "bf16":
                with jax.disable_jit():
                    jstate, _ = jt._train_step(
                        jstate, shard_batch(batch, mesh1),
                        jax.random.PRNGKey(0))
            else:
                jstate, _ = jt._train_step(jstate, shard_batch(batch, mesh1),
                                           jax.random.PRNGKey(0))
        finals[name] = dict(iter_flax_leaves(jax.device_get(jstate.params)))
    model = get_model("gpt2_124m", **TINY, dtype=torch.bfloat16)
    load_flax_params(model, params0)
    trainer = Trainer(LanguageModelingTask(compute_dtype=torch.bfloat16),
                      TrainConfig(seed=0, print_freq=1000, bf16=True),
                      device="cpu")
    state = trainer.init_state(model, make_optimizer(
        "sgd", make_schedule("constant", lr)))
    for batch in batches:
        metrics = trainer.train_step(state, {
            name: torch.from_numpy(x) for name, x in batch.items()})
        assert np.isfinite(float(metrics["loss_sum"]))
    assert all(p.dtype == torch.float32 for p in state.params)
    ours = dict(iter_flax_leaves(torch_to_flax(state.model)))
    want, fp32 = finals["bf16"], finals["fp32"]
    assert ours.keys() == want.keys()

    def max_gap(a, b):
        return max(float(np.abs(np.asarray(a[p], np.float64)
                                - np.asarray(b[p])).max()) for p in b)

    gap = max_gap(want, fp32)
    assert gap > 10 * PARAM_ATOL                 # bf16 is really on
    assert max_gap(ours, want) <= BF16_GAP_FRACTION * gap


def test_entry_point_trains_with_amp_on_cpu(tmp_path, capsys):
    """--amp on one rank: bf16 compute, float32 parameters."""
    state = train.main(TINY_CLI + ["--amp", "--epochs", "1",
                                   "--output-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "world_size=1, amp=True" in out
    assert "Epoch [1] Step [8/8] Loss: " in out
    assert state.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.params)
    losses = [float(ln.split(",")[1]) for ln in
              (tmp_path / "metrics_rank0.csv").read_text().splitlines()[1:]]
    assert len(losses) == 1 and np.isfinite(losses[0])
