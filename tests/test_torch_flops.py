"""The port's FLOPs accounting and MFU against the JAX package's
experiments/flops.py: ``matmul_flops`` (torch's FlopCounterMode) of a
tiny GPT-2's and a tiny ResNet's forward equals ``jaxpr_matmul_flops``
of the same flax forward EXACTLY (both count 2 FLOPs per multiply-add of
every matrix product and convolution, and nothing else); ``mfu_pct`` and
``check_mfu`` equal JAX's over a grid, the raise above 100% included;
the peak table's rule; and the step line's MFU suffix.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_pytorch_training_tpu.experiments import flops as jflops
from distributed_pytorch_training_tpu.models import get_model as jax_get_model
from distributed_pytorch_training_tpu_torch.experiments import flops
from distributed_pytorch_training_tpu_torch.models import get_model
from distributed_pytorch_training_tpu_torch.training import (
    TrainConfig, Trainer, make_optimizer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (
    LanguageModelingTask,
)

GPT2 = dict(vocab_size=97, hidden_dim=32, depth=2, num_heads=2,
            max_position=16)


@pytest.mark.parametrize("batch,seq", [(1, 16), (3, 9)])
def test_gpt2_forward_flops_equal_jaxpr_count(batch, seq):
    model = jax_get_model("gpt2_124m", **GPT2)
    x = jnp.zeros((batch, seq), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), x, train=False)["params"]
    want = jflops.jaxpr_matmul_flops(
        lambda p, ids: model.apply({"params": p}, ids, train=False),
        params, x)
    ours = get_model("gpt2_124m", **GPT2)
    ids = torch.zeros((batch, seq), dtype=torch.long)
    with torch.no_grad():
        got = flops.matmul_flops(ours, ids)
    assert got == want > 0
    # on meta tensors, without computing, the same count
    meta = get_model("gpt2_124m", device="meta", **GPT2)
    assert flops.matmul_flops(meta, ids.to("meta")) == want


@pytest.mark.parametrize("kw", [dict(num_filters=4, cifar_stem=True),
                                dict(num_filters=4)],
                         ids=["cifar", "imagenet"])
def test_resnet_forward_flops_equal_jaxpr_count(kw):
    model = jax_get_model("resnet18", **kw)
    x = jnp.zeros((2, 32, 32, 3))
    variables = model.init(jax.random.PRNGKey(0), x, train=False)
    want = jflops.jaxpr_matmul_flops(
        lambda v, img: model.apply(v, img, train=False), variables, x)
    ours = get_model("resnet18", **kw).eval()
    with torch.no_grad():
        got = flops.matmul_flops(ours, torch.zeros((2, 32, 32, 3)))
    assert got == want > 0


@pytest.mark.parametrize("flops_per_step", [None, 0.0, 1e9, 3.5e12, 8e14])
@pytest.mark.parametrize("steps_per_sec", [0.0, 0.5, 12.0, 480.0])
@pytest.mark.parametrize("peak", [None, 197.0, 989.0])
def test_mfu_and_its_check_equal_jax(flops_per_step, steps_per_sec, peak):
    ours = flops.mfu_pct(flops_per_step, steps_per_sec, peak)
    want = jflops.mfu_pct(flops_per_step, steps_per_sec, peak)
    assert ours == want
    if want is not None and want > 100.0:
        with pytest.raises(flops.MeasurementError) as e1:
            flops.check_mfu(ours, "ctx")
        with pytest.raises(jflops.MeasurementError) as e2:
            jflops.check_mfu(want, "ctx")
        assert str(e1.value) == str(e2.value)
    else:
        assert flops.check_mfu(ours, "ctx") == jflops.check_mfu(want, "ctx")


def test_check_mfu_thresholds():
    assert flops.check_mfu(None) is None
    assert flops.check_mfu(60.0) is None
    assert "above the ~60%" in flops.check_mfu(60.1, "x")
    with pytest.raises(flops.MeasurementError, match="exceeds hardware"):
        flops.check_mfu(100.01)


def test_chip_peak_rule(monkeypatch):
    monkeypatch.delenv(flops.PEAK_ENV_VAR, raising=False)
    assert flops.chip_peak_tflops("cpu") is None
    assert flops.CHIP_PEAK_TFLOPS_BF16["NVIDIA H100 80GB HBM3"] == 989.0
    if not torch.cuda.is_available():
        assert flops.chip_peak_tflops() is None
    monkeypatch.setenv(flops.PEAK_ENV_VAR, "123.5")
    assert flops.chip_peak_tflops("cpu") == 123.5
    assert jflops.chip_peak_tflops() == 123.5       # the JAX rule


def test_step_line_reports_mfu(capsys):
    """With a reference set, every print line ends in ``  MFU: x.x%``,
    100 x samples/s x FLOPs a sample / peak FLOP/s; without, no suffix."""
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    batches = [{"input_ids": torch.from_numpy(
        rng.randint(0, 97, (4, 16)).astype(np.int64)),
        "weight": torch.ones(4)} for _ in range(4)]

    def epoch(reference):
        model = get_model("gpt2_124m", **GPT2)
        model.reset_parameters(torch.Generator().manual_seed(0))
        trainer = Trainer(LanguageModelingTask(),
                          TrainConfig(print_freq=2), device="cpu")
        if reference:
            # MFU = samples/s: FLOPs a sample = peak / 100
            trainer.set_mfu_reference(1e12, 1e14)
        state = trainer.init_state(model, make_optimizer("sgd", 0.01))
        trainer.train_epoch(state, batches, 0, 4,
                            samples_per_step=[4] * 4)
        return [ln for ln in capsys.readouterr().out.splitlines()
                if "Throughput" in ln]

    lines = epoch(True)
    assert len(lines) == 2
    for ln in lines:
        m = re.search(r"Throughput: ([\d.]+) samples/s \(global\)  "
                      r"MFU: ([\d.]+)%$", ln)
        assert m, ln
        assert abs(float(m[2]) - float(m[1])) <= 0.051
    assert all(ln.endswith("samples/s (global)") for ln in epoch(False))
