"""The port's image path against the JAX package's: ResNet-18/50 with
flax's BatchNorm, the image datasets, augmentation, the per-rank loader,
BatchNorm statistics across ``convert.py``, and single-rank Trainer
trajectories with BatchNorm and gradient accumulation.

Tolerances:
* datasets, records, loader batches, crops and flips: bitwise (the same
  numpy draws, byte moves and gathers);
* normalization: rtol 1e-6 (one float32 division each; XLA may compile a
  division by a constant as a multiply by its reciprocal, an ulp apart);
* logits and BatchNorm statistics of a narrow ResNet (num_filters 8, 16x16
  images): LOGIT_ATOL = 1e-4, STAT_ATOL = 1e-5 + rtol 1e-4. Both compute
  in float32 and differ by the order of the convolution and reduction
  sums (measured below 1e-5). Train-mode logits, where every BatchNorm
  divides by a batch standard deviation, within TRAIN_LOGIT_REL = 2e-4 of
  the largest |logit| (ResNet-50's 53 BatchNorms: measured 6e-5 of it);
* 3-step trajectories: the per-step losses within LOSS_RTOL = 1e-5, the
  parameters and statistics within PARAM_ATOL = 1e-5 + PARAM_RTOL = 1e-4:
  float32 reassociation through 20 BatchNorms over 3 SGD steps (measured
  below 1.1e-6 absolute). They run the CIFAR stem: with the ImageNet stem
  a 16x16 image reaches stages 3-4 as 1x1 maps, where a microbatch of 4
  rows gives BatchNorm 4 values and E[x^2] - E[x]^2 cancels, so both sides
  amplify their rounding apart (1e-2 after 2 steps, measured); the same
  holds for the train-mode check of the deeper ResNet-50.
* bf16 compute (``dtype=bfloat16``, ``--amp``), against flax run op by op
  (``jax.disable_jit``), which rounds every op to bf16 as flax's
  ``dtype`` says: eval logits bitwise (measured: equal), the JAX
  package's own bf16-vs-float32 gap asserted beside them. A jitted program
  keeps float32 through some fused bf16 chains on the CPU, and moves its
  logits from the op-by-op ones by as much as that gap (measured 0.030
  against 0.033), so it is not the reference here. A 3-step trajectory:
  the parameters and statistics within BF16_GAP_FRACTION = 0.9 of the
  JAX package's own bf16-vs-float32 gap on the same batches, measured in
  the test (the largest difference, leaf by leaf over the tree). In
  train mode BatchNorm's float32 statistics sum in another order on each
  side, so now and then a normalized value rounds to the neighbouring
  bf16 number, and the next BatchNorms spread that (15% of stage 2's
  outputs one bf16 step apart, measured): the port sits at 0.75 (params)
  and 0.80 (statistics) of the gap, measured. A port computing in float32
  sits at 1.0 of it and fails.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu import native as jax_native
from distributed_pytorch_training_tpu.data.augment import (
    normalize_images as jax_normalize,
    random_crop_flip as jax_crop_flip,
)
from distributed_pytorch_training_tpu.data.datasets import (
    get_dataset as jax_get_dataset,
    load_cifar10 as jax_load_cifar10,
    synthetic_image_dataset as jax_synthetic_images,
)
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
    ImageClassificationTask as JaxImageTask,
)
from distributed_pytorch_training_tpu_torch import native
from distributed_pytorch_training_tpu_torch.convert import (
    batch_stats_to_flax,
    iter_flax_leaves,
    load_flax_params,
    name_to_flax_path,
    torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.data.augment import (
    draw_crop_flip,
    normalize_images,
    random_crop_flip,
)
from distributed_pytorch_training_tpu_torch.data.datasets import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    get_dataset,
    load_cifar10,
    synthetic_image_dataset,
)
from distributed_pytorch_training_tpu_torch.data.loader import ShardedLoader
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.models.resnet import same_padding
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig,
    Trainer,
    make_optimizer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    ImageClassificationTask,
)

LOGIT_ATOL = 1e-4
TRAIN_LOGIT_REL = 2e-4
STAT_ATOL, STAT_RTOL = 1e-5, 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
CIFAR_STEM = {"cifar_stem": True}
HW = 16
NARROW = dict(num_filters=8)


def flax_variables(name, seed=0, **kw):
    """A flax model's (params, batch_stats), with random running
    statistics so the eval path reads them."""
    model = jax_get_model(name, **NARROW, **kw)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, HW, HW, 3)), train=False)
    params = jax.device_get(variables["params"])
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda x: (rng.rand(*x.shape) * 0.5 + 0.5).astype(np.float32)
        if x.shape else x, jax.device_get(variables["batch_stats"]))
    return model, params, stats


def images(n, seed=0):
    return np.random.RandomState(seed).randn(n, HW, HW, 3).astype(np.float32)


def leaves(tree):
    return dict(iter_flax_leaves(tree))


MODELS = [("resnet18", {}), ("resnet18", CIFAR_STEM), ("resnet50", {})]


@pytest.mark.parametrize("name,kw", MODELS,
                         ids=["resnet18", "resnet18-cifar-stem", "resnet50"])
def test_eval_logits_match_flax(name, kw):
    model, params, stats = flax_variables(name, **kw)
    x = images(4)
    want = model.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), train=False)
    ours = get_model(name, **NARROW, **kw)
    load_flax_params(ours, params, stats)
    ours.eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.shape == (4, ours.num_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("name,kw", [("resnet18", {}),
                                     ("resnet18", CIFAR_STEM),
                                     ("resnet50", CIFAR_STEM)],
                         ids=["resnet18", "resnet18-cifar-stem",
                              "resnet50-cifar-stem"])
def test_train_mode_logits_and_new_stats_match_flax(name, kw):
    model, params, stats = flax_variables(name, seed=1, **kw)
    x = images(6, seed=1) * 3 + 1
    want, mutated = model.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    ours = get_model(name, **NARROW, **kw)
    load_flax_params(ours, params, stats)
    got, new_stats = ours(torch.from_numpy(x), train=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=TRAIN_LOGIT_REL * np.abs(want).max())
    ref = leaves(jax.device_get(mutated["batch_stats"]))
    got_stats = {name_to_flax_path(k): v.numpy()
                 for k, v in new_stats.items()}
    assert got_stats.keys() == ref.keys()
    for path, want_stat in ref.items():
        np.testing.assert_allclose(got_stats[path], want_stat,
                                   atol=STAT_ATOL, rtol=STAT_RTOL,
                                   err_msg=str(path))
    # the forward wrote nothing: the Trainer decides
    np.testing.assert_array_equal(
        leaves(batch_stats_to_flax(ours))[("stem_bn", "var")],
        leaves(stats)[("stem_bn", "var")])


def test_batchnorm_running_var_is_the_biased_variance():
    """flax's EMA takes the biased E[x^2] - E[x]^2, not torch's unbiased
    one: at batch statistics (mean m, biased var v) the new var is
    0.9 * 1 + 0.1 * v."""
    from distributed_pytorch_training_tpu_torch.models.resnet import (
        BatchNorm,
    )

    bn = BatchNorm(3)
    bn.reset_parameters(torch.Generator())
    bn.stats_name = "bn."
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    stats = {}
    bn(x, stats)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(stats["bn.var"], 0.9 + 0.1 * biased,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(stats["bn.mean"],
                               0.1 * x.mean(dim=(0, 2, 3)))


@pytest.mark.parametrize("size,kernel,stride,want", [
    (32, 7, 2, (2, 3)), (16, 3, 2, (0, 1)), (16, 1, 2, (0, 0)),
    (8, 3, 1, (1, 1)), (7, 3, 2, (1, 1))])
def test_same_padding_is_xla(size, kernel, stride, want):
    assert same_padding(size, kernel, stride) == want


def test_resnet18_full_width_param_count():
    model = get_model("resnet18")
    assert sum(p.numel() for p in model.parameters()) == 11_181_642
    assert len(list(model.buffers())) == 40          # 20 BatchNorms


def test_batch_stats_round_trip():
    _, params, stats = flax_variables("resnet18", seed=2)
    ours = get_model("resnet18", **NARROW)
    load_flax_params(ours, params, stats)
    for tree, back in ((params, torch_to_flax(ours)),
                       (stats, batch_stats_to_flax(ours))):
        a, b = leaves(tree), leaves(back)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    bad = dict(stats)
    bad.pop("stem_bn")
    with pytest.raises(ValueError, match="batch_stats"):
        load_flax_params(ours, params, bad)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_synthetic_images_bitwise():
    a = synthetic_image_dataset(40, (32, 32), 10, seed=3)
    b = jax_synthetic_images(40, (32, 32), 10, seed=3)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    for dataset in ("cifar10", "imagenet"):
        for is_train in (True, False):
            a = get_dataset(dataset, "/nonexistent", train=is_train,
                            synthetic_size=3, seed=42)
            b = jax_get_dataset(dataset, "/nonexistent", train=is_train,
                                synthetic_size=3, seed=42)
            assert (a.name, a.num_classes, a.synthetic) == \
                (b.name, b.num_classes, b.synthetic)
            np.testing.assert_array_equal(a.images, b.images)
            np.testing.assert_array_equal(a.labels, b.labels)


def write_cifar_pickles(root, per_file=3):
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        entry = {"data": rng.randint(0, 256, (per_file, 3072),
                                     dtype=np.uint8),
                 "labels": rng.randint(0, 10, per_file).tolist()}
        with open(root / name, "wb") as f:
            pickle.dump(entry, f)


def test_load_cifar10_reads_the_pickles_like_jax(tmp_path):
    write_cifar_pickles(tmp_path / "cifar-10-batches-py")
    for is_train, n in ((True, 15), (False, 3)):
        a = load_cifar10(str(tmp_path), is_train)
        b = jax_load_cifar10(str(tmp_path), is_train)
        assert a.images.shape == (n, 32, 32, 3) and not a.synthetic
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        ds = get_dataset("cifar10", str(tmp_path), train=is_train)
        assert ds.name == "cifar10" and len(ds) == n
    assert load_cifar10(str(tmp_path / "missing"), True) is None


def test_chw_to_hwc_bitwise():
    rec = np.random.RandomState(1).randint(0, 256, (5, 3 * 4 * 6),
                                           dtype=np.uint8)
    np.testing.assert_array_equal(native.chw_to_hwc_u8(rec, 3, 4, 6),
                                  jax_native.chw_to_hwc_u8(rec, 3, 4, 6))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_flip_matches_jax_fed_the_same_draws(seed):
    imgs = np.random.RandomState(seed).randint(0, 256, (9, 12, 10, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_crop_flip(jnp.asarray(imgs), key, padding=4))
    # the draws random_crop_flip makes from `key`, handed to the port
    k_h, k_w, k_f = jax.random.split(key, 3)
    off_h = jax.random.randint(k_h, (9,), 0, 9)
    off_w = jax.random.randint(k_w, (9,), 0, 9)
    flip = jax.random.bernoulli(k_f, 0.5, (9,))
    got = random_crop_flip(torch.from_numpy(imgs),
                           torch.from_numpy(np.array(off_h)).long(),
                           torch.from_numpy(np.array(off_w)).long(),
                           torch.from_numpy(np.array(flip)), padding=4)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_draws_are_seeded_and_in_range():
    a = draw_crop_flip(64, torch.Generator().manual_seed(5), padding=4)
    b = draw_crop_flip(64, torch.Generator().manual_seed(5), padding=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    off_h, off_w, flip = a
    assert 0 <= int(off_h.min()) and int(off_h.max()) <= 8
    assert 0 <= int(off_w.min()) and int(off_w.max()) <= 8
    assert flip.dtype == torch.bool and 0 < int(flip.sum()) < 64


def test_normalize_matches_jax():
    imgs = np.random.RandomState(4).randint(0, 256, (3, 5, 5, 3),
                                            dtype=np.uint8)
    got = normalize_images(torch.from_numpy(imgs), CIFAR10_MEAN, CIFAR10_STD)
    want = jax_normalize(jnp.asarray(imgs), CIFAR10_MEAN, CIFAR10_STD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_normalize_into_bf16_matches_jax():
    """Computed in float32, rounded once to the compute dtype: within one
    bf16 step (2**-8 of a value) of the JAX module's, whose division may
    be a multiply by the reciprocal, an ulp apart before the rounding."""
    imgs = np.random.RandomState(4).randint(0, 256, (3, 5, 5, 3),
                                            dtype=np.uint8)
    got = normalize_images(torch.from_numpy(imgs), CIFAR10_MEAN, CIFAR10_STD,
                           torch.bfloat16)
    want = jax_normalize(jnp.asarray(imgs), CIFAR10_MEAN, CIFAR10_STD,
                         dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8)
    assert (got.float().numpy() == want).mean() > 0.99


@pytest.mark.parametrize("n,drop_last", [(37, False), (37, True)])
def test_per_rank_loader_follows_the_jax_sampler(n, drop_last):
    ds = synthetic_image_dataset(n, (8, 8), 10, seed=1)
    for rank in range(2):
        loader = ShardedLoader(ds, 4, shuffle=True, seed=7,
                               drop_last=drop_last, process_index=rank,
                               process_count=2)
        plan = JaxSampler(n=n, global_batch=8, shuffle=True, seed=7,
                          drop_last=drop_last, process_index=rank,
                          process_count=2)
        batches = list(loader.epoch(1))
        assert len(batches) == len(loader) == plan.steps_per_epoch()
        for batch, (idx, w) in zip(batches, plan.iter_epoch(1)):
            assert batch["image"].dtype == torch.uint8
            np.testing.assert_array_equal(batch["image"].numpy(),
                                          ds.images[idx])
            np.testing.assert_array_equal(batch["label"].numpy(),
                                          ds.labels[idx])
            np.testing.assert_array_equal(batch["weight"].numpy(), w)
    if not drop_last:
        assert batches[-1]["weight"].sum() < 4       # padded, weighted out


# ---------------------------------------------------------------------------
# single-rank trajectories with BatchNorm against the JAX Trainer
# ---------------------------------------------------------------------------


def image_batches(n_steps, batch, seed=0, padded_step=None):
    rng = np.random.RandomState(seed)
    out = []
    for step in range(n_steps):
        w = np.ones(batch, np.float32)
        w[-2:] = 0.0
        if step == padded_step:
            w[:] = 0.0
        out.append({"image": rng.randint(0, 256, (batch, HW, HW, 3),
                                         dtype=np.uint8),
                    "label": rng.randint(0, 10, batch).astype(np.int32),
                    "weight": w})
    return out


def assert_state_matches(state, jstate, params0):
    ours = leaves(torch_to_flax(state.model))
    ref = leaves(jax.device_get(jstate.params))
    assert ours.keys() == ref.keys()
    moved = 0.0
    for path, want in ref.items():
        start = leaves(params0)[path]
        moved = max(moved, float(np.abs(np.asarray(want) - start).max()))
        np.testing.assert_allclose(ours[path], want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=str(path))
    assert moved > 10 * PARAM_ATOL
    ours = leaves(batch_stats_to_flax(state.model))
    ref = leaves(jax.device_get(jstate.batch_stats))
    assert ours.keys() == ref.keys()
    for path, want in ref.items():
        np.testing.assert_allclose(ours[path], want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=str(path))


@pytest.mark.parametrize("accum,padded_step", [(1, None), (2, 2)],
                         ids=["accum1", "accum2-all-padded-step"])
def test_single_rank_trajectory_matches_jax(devices, accum, padded_step):
    steps, batch = 3, 8
    batches = image_batches(steps, batch, padded_step=padded_step)
    jm = jax_get_model("resnet18", **NARROW, **CIFAR_STEM)
    mesh1 = build_mesh(MeshSpec(data=1), devices=devices[:1])
    jt = JaxTrainer(JaxImageTask(CIFAR10_MEAN, CIFAR10_STD, augment=False),
                    mesh1, JaxTrainConfig(seed=0, print_freq=1000,
                                          grad_accum=accum))
    jstate = jt.init_state(jm, np.zeros((1, HW, HW, 3), np.float32),
                           jax_make_optimizer("sgd", 0.05),
                           jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate.params)
    model = get_model("resnet18", **NARROW, **CIFAR_STEM)
    load_flax_params(model, params0, jax.device_get(jstate.batch_stats))
    trainer = Trainer(ImageClassificationTask(CIFAR10_MEAN, CIFAR10_STD,
                                              augment=False),
                      TrainConfig(seed=0, print_freq=1000, grad_accum=accum),
                      device="cpu")
    state = trainer.init_state(model, make_optimizer("sgd", 0.05))
    stats_before_padded = None
    for step, b in enumerate(batches):
        if step == padded_step:
            stats_before_padded = leaves(batch_stats_to_flax(state.model))
        jstate, jmetrics = jt._train_step(jstate, shard_batch(b, mesh1),
                                          jax.random.PRNGKey(0))
        metrics = trainer.train_step(state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        assert float(metrics["weight"]) == float(jmetrics["weight"])
        if float(metrics["weight"]):
            np.testing.assert_allclose(
                float(metrics["loss_sum"]), float(jmetrics["loss_sum"]),
                rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == steps
    assert_state_matches(state, jstate, params0)
    if padded_step is not None:
        after = leaves(batch_stats_to_flax(state.model))
        for path, before in stats_before_padded.items():
            np.testing.assert_array_equal(after[path], before)


# ---------------------------------------------------------------------------
# bf16 compute against flax's bf16, beside flax's own bf16-vs-fp32 gap
# ---------------------------------------------------------------------------

BF16_GAP_FRACTION = 0.9


def bf16_pair(seed=0):
    """flax and port ResNet-18 (narrow, CIFAR stem) at bf16 and float32
    from the same float32 weights and the flax init's running statistics
    (flax_variables' random ones, all of mean > 0.5, leave nothing past
    the last ReLUs: zero logits)."""
    flax_bf16 = jax_get_model("resnet18", **NARROW, **CIFAR_STEM,
                              dtype=jnp.bfloat16)
    variables = jax.device_get(flax_bf16.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3)), train=False))
    params, stats = variables["params"], variables["batch_stats"]
    flax_fp32 = jax_get_model("resnet18", **NARROW, **CIFAR_STEM)
    ours = get_model("resnet18", **NARROW, **CIFAR_STEM,
                     dtype=torch.bfloat16)
    load_flax_params(ours, params, stats)
    return flax_bf16, flax_fp32, params, stats, ours


def test_bf16_eval_logits_bitwise_flax():
    flax_bf16, flax_fp32, params, stats, ours = bf16_pair()
    x = images(4, seed=2)
    variables = {"params": params, "batch_stats": stats}
    with jax.disable_jit():
        want = np.asarray(flax_bf16.apply(variables, jnp.asarray(x),
                                          train=False))
    fp32 = np.asarray(flax_fp32.apply(variables, jnp.asarray(x),
                                      train=False))
    ours.eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # bf16 is really on: flax's own bf16 logits are off its float32 ones
    assert np.abs(fp32).max() > 0.1
    assert np.abs(want - fp32).max() > 1e-3 * np.abs(fp32).max()


def max_gap(a, b):
    return max(float(np.abs(np.asarray(a[p], np.float64) - b[p]).max())
               for p in b)


def test_bf16_trajectory_within_the_flax_bf16_gap(devices):
    """3 SGD steps (lr 1e-3) at bf16: the port against the JAX Trainer run
    op by op, within BF16_GAP_FRACTION of the JAX Trainer's own bf16
    against float32 distance on the same batches (module docstring)."""
    steps, batch, lr = 3, 8, 1e-3
    batches = image_batches(steps, batch)
    mesh1 = build_mesh(MeshSpec(data=1), devices=devices[:1])
    finals = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        jt = JaxTrainer(
            JaxImageTask(CIFAR10_MEAN, CIFAR10_STD, augment=False,
                         compute_dtype=dtype), mesh1,
            JaxTrainConfig(seed=0, print_freq=1000,
                           bf16=dtype == jnp.bfloat16))
        jstate = jt.init_state(
            jax_get_model("resnet18", **NARROW, **CIFAR_STEM, dtype=dtype),
            np.zeros((1, HW, HW, 3), np.float32),
            jax_make_optimizer("sgd", lr), jax.random.PRNGKey(0))
        if name == "bf16":
            params0 = jax.device_get(jstate.params)
            stats0 = jax.device_get(jstate.batch_stats)
        for b in batches:
            if name == "bf16":
                with jax.disable_jit():
                    jstate, _ = jt._train_step(
                        jstate, shard_batch(b, mesh1), jax.random.PRNGKey(0))
            else:
                jstate, _ = jt._train_step(jstate, shard_batch(b, mesh1),
                                           jax.random.PRNGKey(0))
        finals[name] = (leaves(jax.device_get(jstate.params)),
                        leaves(jax.device_get(jstate.batch_stats)))
    model = get_model("resnet18", **NARROW, **CIFAR_STEM,
                      dtype=torch.bfloat16)
    load_flax_params(model, params0, stats0)
    trainer = Trainer(ImageClassificationTask(
        CIFAR10_MEAN, CIFAR10_STD, augment=False,
        compute_dtype=torch.bfloat16),
        TrainConfig(seed=0, print_freq=1000, bf16=True), device="cpu")
    state = trainer.init_state(model, make_optimizer("sgd", lr))
    for b in batches:
        metrics = trainer.train_step(state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        assert np.isfinite(float(metrics["loss_sum"]))
    assert all(p.dtype == torch.float32 for p in state.params)
    ours = (leaves(torch_to_flax(state.model)),
            leaves(batch_stats_to_flax(state.model)))
    for i, tree in enumerate(("params", "batch_stats")):
        (want, fp32), got = (finals["bf16"][i], finals["fp32"][i]), ours[i]
        assert got.keys() == want.keys()
        gap = max_gap(want, fp32)
        assert gap > 10 * PARAM_ATOL, tree       # bf16 is really on
        assert max_gap(got, want) <= BF16_GAP_FRACTION * gap, tree
