"""The port's ViT against the JAX package's, on converted weights.

* Forward (a 32x32 image, patch 4, width 32): logits within ATOL = RTOL
  = 1e-5 in float32 (reassociation; measured ~1e-6 at logits of ~1.5),
  and under bf16 compute BITWISE flax's run op by op (``jax.disable_jit``)
  with the JAX package's own bf16-vs-float32 gap asserted beside them.
  The patches flatten in flax's NHWC order: a patch grid that is not
  square (32x48) holds it.
* Parameters: 86,567,656 for ``vit_b16`` at 224x224 and 1000 classes, on
  ``device="meta"``, as the flax model counts them.
* A 3-step Trainer trajectory against the JAX Trainer on the 8-device
  CPU mesh (no augmentation: the port's crop and flip draws are not
  jax.random's; SGD with momentum): the losses within LOSS_RTOL = 1e-5,
  the parameters within PARAM_ATOL = 1e-5 + PARAM_RTOL = 1e-4.
* The entry point: ``vit_b16`` on synthetic ImageNet at a tiny width
  trains and writes the CSV (with ``--remat`` too); a ResNet refuses
  ``--remat`` with the JAX entry's message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.models import get_model as jax_get_model
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
from distributed_pytorch_training_tpu_torch.convert import (
    iter_flax_leaves,
    load_flax_params,
    torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.data.datasets import IMAGE_STATS
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig,
    Trainer,
    make_optimizer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    ImageClassificationTask,
)
from distributed_pytorch_training_tpu_torch.utils import MetricsCSV
from _torch_rig import port_process_state  # noqa: F401

ATOL = RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
TINY = dict(num_classes=10, patch_size=4, hidden_dim=32, depth=2,
            num_heads=2, mlp_dim=64)
VIT_B16_PARAMS = 86_567_656


def images_of(n, hw=(32, 32), seed=0):
    return np.random.RandomState(seed).randn(n, *hw, 3).astype(np.float32)


@pytest.fixture(scope="module")
def flax_params():
    return jax.device_get(jax_get_model("vit_b16", **TINY).init(
        jax.random.PRNGKey(0), images_of(1), train=False)["params"])


@pytest.mark.parametrize("hw", [(32, 32), (32, 48)], ids=["square", "wide"])
def test_logits_match_flax(hw):
    jm = jax_get_model("vit_b16", **TINY)
    x = images_of(3, hw, seed=1)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), x,
                                    train=False)["params"])
    ref = np.asarray(jm.apply({"params": params}, x, train=False))
    model = get_model("vit_b16", image_size=hw, **TINY)
    load_flax_params(model, params)
    assert tuple(model.pos_embedding.shape) == (1, hw[0] * hw[1] // 16 + 1,
                                                32)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        logits, stats = model(torch.from_numpy(x), train=True)
    assert out.dtype == torch.float32 and out.shape == (3, 10)
    assert stats == {} and torch.equal(logits, out)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_bf16_logits_bitwise_flax(flax_params):
    x = images_of(3, seed=2)
    with jax.disable_jit():
        ref = np.asarray(jax_get_model(
            "vit_b16", dtype=jnp.bfloat16, **TINY).apply(
            {"params": flax_params}, x, train=False))
    fp32 = np.asarray(jax_get_model("vit_b16", **TINY).apply(
        {"params": flax_params}, x, train=False))
    model = get_model("vit_b16", image_size=32, dtype=torch.bfloat16, **TINY)
    load_flax_params(model, flax_params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.abs(ref - fp32).max() > 1e-3 * np.abs(fp32).max()


def test_vit_b16_parameter_count_is_the_jax_models():
    model = get_model("vit_b16", device="meta")
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda: jax_get_model("vit_b16").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32),
        train=False))
    jax_n = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert n == VIT_B16_PARAMS == jax_n
    assert tuple(model.pos_embedding.shape) == (1, 197, 768)
    assert tuple(model.patch_embed.kernel.shape) == (16, 16, 3, 768)


def test_synthetic_imagenet_is_the_jax_packages():
    from distributed_pytorch_training_tpu.data.datasets import (
        get_dataset as jax_get_dataset,
    )
    from distributed_pytorch_training_tpu_torch.data.datasets import (
        get_dataset,
    )

    for is_train in (True, False):
        ours = get_dataset("imagenet", "/nonexistent", train=is_train,
                           synthetic=True, synthetic_size=3, seed=4)
        ref = jax_get_dataset("imagenet", "/nonexistent", train=is_train,
                              synthetic=True, synthetic_size=3, seed=4)
        assert (ours.name, ours.num_classes, ours.synthetic) == (
            ref.name, ref.num_classes, ref.synthetic) == (
            "imagenet-synthetic", 1000, True)
        assert ours.images.shape == (3, 224, 224, 3)
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.labels, ref.labels)


def test_imagenet_stats_are_the_jax_entrys():
    import importlib

    assert IMAGE_STATS == importlib.import_module("train").IMAGE_STATS


def _batches(n_steps, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        w = np.ones(batch, np.float32)
        w[-3:] = 0.0
        out.append({"image": rng.randint(0, 256, (batch, 32, 32, 3)
                                         ).astype(np.uint8),
                    "label": rng.randint(0, 10, batch).astype(np.int32),
                    "weight": w})
    return out


def test_trainer_trajectory_matches_jax(mesh8):
    steps, lr = 3, 0.05
    mean, std = IMAGE_STATS["imagenet"]
    jt = JaxTrainer(JaxImageTask(mean=mean, std=std, augment=False), mesh8,
                    JaxTrainConfig(seed=0, print_freq=1000))
    jstate = jt.init_state(jax_get_model("vit_b16", **TINY),
                           images_of(1), jax_make_optimizer("sgd", lr),
                           jax.random.PRNGKey(0))
    params0 = jax.device_get(jstate.params)
    model = get_model("vit_b16", image_size=32, **TINY)
    load_flax_params(model, params0)
    trainer = Trainer(ImageClassificationTask(mean=mean, std=std,
                                              augment=False),
                      TrainConfig(seed=0, print_freq=1000), device="cpu")
    state = trainer.init_state(model, make_optimizer("sgd", lr))
    for batch in _batches(steps):
        jstate, jm = jt._train_step(jstate, shard_batch(batch, mesh8),
                                    jax.random.PRNGKey(0))
        m = trainer.train_step(state, {k: torch.from_numpy(x)
                                       for k, x in batch.items()})
        assert float(m["weight"]) == float(jm["weight"]) == 13
        np.testing.assert_allclose(float(m["loss_sum"]),
                                   float(jm["loss_sum"]), rtol=LOSS_RTOL)
    ours = dict(iter_flax_leaves(torch_to_flax(state.model)))
    ref = dict(iter_flax_leaves(jax.device_get(jstate.params)))
    start = dict(iter_flax_leaves(params0))
    assert ours.keys() == ref.keys()
    moved = 0.0
    for path, want in ref.items():
        want = np.asarray(want)
        moved = max(moved, float(np.abs(want - np.asarray(start[path]))
                                 .max()))
        np.testing.assert_allclose(ours[path], want, atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=str(path))
    assert moved > 10 * PARAM_ATOL


VIT_CLI = ["--device", "cpu", "--model", "vit_b16", "--dataset", "imagenet",
           "--model-overrides", "hidden_dim=32,depth=2,num_heads=2,"
           "mlp_dim=64,patch_size=56", "--synthetic", "--synthetic-size",
           "16", "--epochs", "2", "--batch-size", "4", "--print-freq", "2",
           "--no-telemetry"]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_entry_point_trains_vit(tmp_path, capsys, remat):
    state = train.main(VIT_CLI + ["--output-dir", str(tmp_path)]
                       + (["--remat"] if remat else []))
    assert state.model.remat is remat
    assert tuple(state.model.pos_embedding.shape) == (1, 17, 32)
    out = capsys.readouterr().out
    assert "NOTE: using synthetic data (imagenet-synthetic, n=16)" in out
    assert "Epoch [2] Step [4/4] Loss: " in out
    lines = (tmp_path / "metrics_rank0.csv").read_text().splitlines()
    assert lines[0] == MetricsCSV.HEADER.strip()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["1", "2"]
    assert all(np.isfinite(float(x)) for ln in lines[1:]
               for x in ln.split(",")[1:5])


def test_resnet_refuses_remat_with_the_jax_message(tmp_path):
    import importlib

    flags = ["--model", "resnet18", "--synthetic", "--synthetic-size", "16",
             "--epochs", "1", "--remat", "--no-telemetry"]
    with pytest.raises(ValueError) as ours:
        train.main(["--device", "cpu"] + flags
                   + ["--output-dir", str(tmp_path / "port")])
    with pytest.raises(ValueError) as theirs:
        importlib.import_module("train").main(
            flags + ["--output-dir", str(tmp_path / "jax")])
    assert str(ours.value) == str(theirs.value)
    assert "--remat applies to transformer models" in str(ours.value)
