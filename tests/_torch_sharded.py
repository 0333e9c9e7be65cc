"""Shared rig of the sharded-update tests (test_torch_zero1.py,
test_torch_fsdp.py, test_torch_hier.py): the JAX Trainer's 3-step runs
on a CPU mesh, the same runs' jobs for the port's gloo ranks
(``_torch_dp_worker.py``), the trajectory check, and the JAX codecs run
inside ``shard_map``.

Tolerances (``test_torch_dp_training.py``'s docstring, whose measurements
they rest on): the per-step losses within LOSS_RTOL = 1e-5, the final
parameters and BatchNorm statistics within PARAM_ATOL = 1e-5 +
PARAM_RTOL = 1e-4, float32 reassociation. On a compressed wire an element
at a rounding boundary of the int8 grid (bf16's, for the bf16 wire) may
take the neighbouring code on one side, which moves the parameters by up
to lr x (1 + momentum + momentum^2) x one code step / W; each hop of the
wire adds HOP[wire] x the largest parameter movement (a code step is at
most 1/127 of the scale; 1/128 for bf16). The hops: the int8 scatter is
one (a whole leaf or layer group shares one scale); ZeRO-1's
``int8_multihop`` adds the s8 update gather; ``int8_hier`` is the
multihop codec across the slices (two) and, under ZeRO-1, its s8 scatter
and update gather (two). An error-feedback row holds within 2 x the
reference's largest |residual| everywhere (a flipped code moves its
element by one code step, the scale, which is at least twice that); on
EF_TIGHT of its elements within EF_RTOL = 2e-2 of it (or PARAM_ATOL): a
residual is carried - q x scale, so the gradients' float32 reassociation,
a relative change e of the scale, moves it by up to 127 e x the scale
(measured up to 8e-4 of the scale on a BatchNorm leaf's 8 elements,
which sum with cancellation), far below one code step. EF_TIGHT is a
share of all the run's residual elements (a leaf of 8 with one flipped
code is 1/8 off). Under AdamW, which divides each gradient by its own
running RMS, a flipped code can move its element's step by up to lr
(the key bias's float32 noise does the same, test_torch_training.py): on
a compressed wire such elements are held to 2 x lr x steps, and they
must be rare, at most FLIP_SHARE = 1e-3 of the parameters. AdamW's
attention KEY bias has an exact gradient of zero (test_torch_training.py):
its entries are held to 2 x lr x steps.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu.parallel import MeshSpec, build_mesh
from distributed_pytorch_training_tpu.parallel import shard_batch
from distributed_pytorch_training_tpu.parallel.collectives import shard_map
from distributed_pytorch_training_tpu.parallel.mesh import BATCH_AXES
from distributed_pytorch_training_tpu.training import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    make_optimizer as jax_make_optimizer,
)
from distributed_pytorch_training_tpu.training.tasks import (
    ImageClassificationTask as JaxImageTask,
    LanguageModelingTask as JaxLMTask,
)
from distributed_pytorch_training_tpu_torch.convert import iter_flax_leaves
from distributed_pytorch_training_tpu_torch.data.datasets import (
    CIFAR10_MEAN,
    CIFAR10_STD,
)

LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
EF_TIGHT = 0.95
EF_RTOL = 2e-2
FLIP_SHARE = 1e-3
STEPS = 3
HOP = {"fp32": 0.0, "bf16": 3 / 128, "int8": 3 / 127}

RESNET_KW = dict(num_filters=8, cifar_stem=True)
HW, IMAGE_BATCH, RESNET_LR = 16, 16, 1e-3
GPT2_KW = dict(vocab_size=97, hidden_dim=32, depth=2, num_heads=2,
               max_position=16)
SEQ, LM_BATCH, GPT2_LR, CLIP = 16, 8, 3e-3, 0.5


def image_batches(global_batch=IMAGE_BATCH):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        w = np.ones(global_batch, np.float32)
        w[-2:] = 0.0
        out.append({"image": rng.randint(0, 256, (global_batch, HW, HW, 3),
                                         dtype=np.uint8),
                    "label": rng.randint(0, 10, global_batch).astype(
                        np.int32),
                    "weight": w})
    return out


def token_batches(global_batch=LM_BATCH):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(STEPS):
        w = np.ones(global_batch, np.float32)
        w[-1] = 0.0
        out.append({"input_ids": rng.randint(
            0, GPT2_KW["vocab_size"], (global_batch, SEQ)).astype(np.int32),
            "weight": w})
    return out


def host(tree):
    """Numpy copies (the JAX step donates its input state)."""
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def mesh_of(devices, n, slices=1):
    spec = (MeshSpec(data=n) if slices == 1
            else MeshSpec.parse(f"slice={slices},data={n // slices}"))
    return build_mesh(spec, devices=devices[:n])


def jax_run(devices, n, lm, cfg, slices=1):
    """The JAX Trainer's 3 steps: (initial params, initial stats, final
    model-shaped params, final stats, per-step metrics, residual tree,
    optimizer-state leaf sizes)."""
    mesh = mesh_of(devices, n, slices)
    cfg = dict(cfg)
    cfg.pop("slices", None)
    jcfg = JaxTrainConfig(seed=0, print_freq=1000, fused_quantize=False,
                          **cfg)
    sharded = cfg.get("zero1") or cfg.get("fsdp_explicit")
    if lm:
        jt = JaxTrainer(JaxLMTask(), mesh, jcfg)
        tx = jax_make_optimizer(
            "adamw", GPT2_LR, weight_decay=0.01, grad_clip_norm=CLIP,
            shard_axes=BATCH_AXES if sharded and n > 1 else None)
        jstate = jt.init_state(jax_get_model("gpt2_124m", **GPT2_KW),
                               np.zeros((1, SEQ), np.int32), tx,
                               jax.random.PRNGKey(0))
        batches = token_batches()
    else:
        jt = JaxTrainer(JaxImageTask(CIFAR10_MEAN, CIFAR10_STD,
                                     augment=False), mesh, jcfg)
        jstate = jt.init_state(jax_get_model("resnet18", **RESNET_KW),
                               np.zeros((1, HW, HW, 3), np.float32),
                               jax_make_optimizer("sgd", RESNET_LR),
                               jax.random.PRNGKey(0))
        batches = image_batches()

    def params_of(state):
        return host(jt._fsdp_unflatten(state.params) if jt._fsdp
                    else state.params)

    init = (params_of(jstate), host(jstate.batch_stats))
    metrics = []
    for b in batches:
        jstate, m = jt._train_step(jstate, shard_batch(b, mesh),
                                   jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    opt_sizes = [int(np.prod(x.shape)) for x in
                 jax.tree_util.tree_leaves(jstate.opt_state)
                 if np.ndim(x)]
    return {"init": init, "params": params_of(jstate),
            "stats": host(jstate.batch_stats), "metrics": metrics,
            "ef": host(jstate.grad_sync.get("ef")) if jstate.grad_sync
            else None, "opt_sizes": opt_sizes}


def port_job(run, lm, cfg):
    """The worker's "train" job of the same run from the same weights."""
    params, stats = run["init"]
    if lm:
        return ("train", dict(
            lm=True, model_kwargs=GPT2_KW, params=params, lr=GPT2_LR,
            batches=token_batches(), config=cfg,
            optimizer=("adamw", dict(weight_decay=0.01,
                                     grad_clip_norm=CLIP))))
    return ("train", dict(
        model_kwargs=RESNET_KW, params=params, batch_stats=stats,
        mean=CIFAR10_MEAN, std=CIFAR10_STD, lr=RESNET_LR,
        batches=image_batches(), config=cfg))


def leaves(tree):
    return {path: np.asarray(v) for path, v in iter_flax_leaves(tree)}


def check_trajectory(run, ranks, hops, lm=False):
    """Every rank's 3 steps against the JAX run: losses, bitwise-equal
    parameters and statistics across ranks, the parameters and
    statistics within the tolerances (``hops``: the wire's HOP sum)."""
    r0 = ranks[0]
    for r in ranks:
        assert r["step"] == STEPS
        for ours, ref in zip(r["metrics"], run["metrics"]):
            assert ours["weight"] == ref["weight"]
            np.testing.assert_allclose(ours["loss_sum"], ref["loss_sum"],
                                       rtol=LOSS_RTOL)
        for tree in ("params", "batch_stats"):
            a, b = leaves(r0[tree]), leaves(r[tree])
            assert a.keys() == b.keys()
            for path in a:
                np.testing.assert_array_equal(a[path], b[path])
    start = leaves(run["init"][0])
    ref = leaves(run["params"])
    moved = max(np.abs(ref[p] - start[p]).max() for p in start)
    assert moved > 10 * PARAM_ATOL
    atol = PARAM_ATOL + hops * moved
    ours = leaves(r0["params"])
    assert ours.keys() == ref.keys()
    flipped = total = 0
    for path, want in ref.items():
        got = ours[path]
        if lm and path[-2:] == ("qkv", "bias"):
            assert np.abs(got[1] - want[1]).max() <= 2 * GPT2_LR * STEPS
            got, want = got[[0, 2]], want[[0, 2]]
        total += want.size
        if lm and hops:
            off = np.abs(got - want) > atol + PARAM_RTOL * np.abs(want)
            flipped += int(off.sum())
            assert np.abs(got - want)[off].max(initial=0.0) \
                <= 2 * GPT2_LR * STEPS, path
            got, want = got[~off], want[~off]
        np.testing.assert_allclose(got, want, atol=atol, rtol=PARAM_RTOL,
                                   err_msg=str(path))
    assert flipped <= FLIP_SHARE * total
    stats = leaves(run["stats"])
    for path, want in stats.items():
        np.testing.assert_allclose(leaves(r0["batch_stats"])[path], want,
                                   atol=atol, rtol=PARAM_RTOL,
                                   err_msg=str(path))


def check_ef_rows(ours, ref):
    """A run's residual rows (lists, in the same order) against the JAX
    ones (the module docstring)."""
    assert len(ours) == len(ref)
    tight = total = 0
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        diff = np.abs(a - b)
        top = np.abs(b).max()
        assert diff.max() <= 2 * top + PARAM_ATOL
        tight += int((diff <= max(PARAM_ATOL, EF_RTOL * top)).sum())
        total += b.size
    assert tight >= EF_TIGHT * total


def jax_codec(devices, n, fn, *stacked, n_out=1, slices=1):
    """``fn`` (per-device arguments) jitted inside ``shard_map`` over the
    batch axes of an n-device mesh (``slices`` x n/slices); every argument
    and output is stacked by device, which is by rank. Returns the
    ``n_out`` stacked outputs as numpy arrays."""
    mesh = mesh_of(devices, n, slices)
    spec = P(("slice", "data") if slices > 1 else "data")

    def body(*xs):
        outs = fn(*[x[0] for x in xs])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return tuple(o[None] for o in outs)

    run = jax.jit(shard_map(body, mesh, in_specs=(spec,) * len(stacked),
                            out_specs=(spec,) * n_out))
    return [np.asarray(o) for o in run(*[jnp.asarray(a) for a in stacked])]
