"""Tiny training rigs of the port for the checkpoint and resilience tests:
a ResNet-18 of 4 filters (BatchNorm, SGD with momentum, augmentation on)
and a 2-block GPT-2 (AdamW), each on the CPU over a synthetic dataset
made from a seed, with the helpers that compare two states bitwise; and
``port_process_state``, the autouse fixture every test file that runs the
port's ``train.main`` (or installs its preemption guard) imports by name.
Imports no JAX."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from distributed_pytorch_training_tpu_torch.data.datasets import (  # noqa
    IMAGE_STATS, synthetic_image_dataset,
)
from distributed_pytorch_training_tpu_torch.data.loader import (  # noqa
    ShardedLoader,
)
from distributed_pytorch_training_tpu_torch.data.text import (  # noqa
    TokenLoader, synthetic_token_dataset,
)
from distributed_pytorch_training_tpu_torch.models import get_model  # noqa
from distributed_pytorch_training_tpu_torch.training import (  # noqa: E402
    TrainConfig, Trainer, make_optimizer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (  # noqa
    ImageClassificationTask, LanguageModelingTask,
)

RESNET = dict(num_classes=10, num_filters=4)


def reset_port_process_state() -> None:
    """Take down what the port's ``train.main`` leaves in the process, as
    the JAX entry leaves it too: its preemption guard's SIGTERM and SIGINT
    handlers (the handlers it replaced are put back, so a JAX guard
    installed before it gets its signals again), the telemetry stream and
    the metrics endpoint."""
    from distributed_pytorch_training_tpu_torch import telemetry
    from distributed_pytorch_training_tpu_torch.training.preemption import (
        PreemptionGuard,
    )

    PreemptionGuard.uninstall()
    telemetry.reset()
    telemetry.stop_metrics_server()


@pytest.fixture(autouse=True)
def port_process_state():
    """After each test, `reset_port_process_state`: a later test in the
    same worker process, the JAX package's among them, starts with the
    signal handlers and telemetry globals the port found."""
    yield
    reset_port_process_state()
GPT2 = dict(vocab_size=97, hidden_dim=32, depth=2, num_heads=2,
            max_position=16)


def rig(kind: str = "resnet", n: int = 32, batch: int = 8, seed: int = 0):
    """(trainer, state_factory, make_loader): ``make_loader(fault_hook)``
    builds a fresh loader over the same data and seed (the same batch
    order) with the given loader hook."""
    if kind == "resnet":
        ds = synthetic_image_dataset(n, seed=seed)
        mean, std = IMAGE_STATS["cifar10"]
        task = ImageClassificationTask(mean=mean, std=std, augment=True)
        tx = make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=5e-4)
        kwargs, loader_cls = RESNET, ShardedLoader
    else:
        ds = synthetic_token_dataset(n, GPT2["max_position"],
                                     GPT2["vocab_size"], seed=seed)
        task = LanguageModelingTask()
        tx = make_optimizer("adamw", 3e-3, weight_decay=0.01)
        kwargs, loader_cls = GPT2, TokenLoader
    model_name = "resnet18" if kind == "resnet" else "gpt2_124m"
    trainer = Trainer(task, TrainConfig(seed=seed, print_freq=1000),
                      device="cpu")

    def state_factory():
        model = get_model(model_name, **kwargs)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return trainer.init_state(model, tx)

    def make_loader(fault_hook=None):
        return loader_cls(ds, batch, shuffle=True, seed=seed,
                          fault_hook=fault_hook)

    return trainer, state_factory, make_loader


def control(trainer, state_factory, loader, epochs: int):
    """The uninterrupted same-seed trajectory."""
    state = state_factory()
    spe = len(loader)
    for epoch in range(epochs):
        state, *_ = trainer.train_epoch(state, loader.epoch(epoch), epoch,
                                        spe)
    return state


def flat_state(state) -> dict:
    """Every tensor a checkpoint holds, by name, on the CPU: parameters
    and buffers, optimizer state and the residual."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for idx, slots in state.optimizer.state_dict()["state"].items():
        for key, v in slots.items():
            out[f"opt/{idx}/{key}"] = v
    for key, v in state.grad_sync.items():
        if isinstance(v, dict):      # per leaf or layer group
            out.update({f"grad_sync/{key}/{k}": r for k, r in v.items()})
        else:
            out[f"grad_sync/{key}"] = v
    return {k: torch.as_tensor(v).detach().cpu().clone()
            for k, v in out.items()}


def assert_bitwise_equal(a, b) -> None:
    """Two states, or two flat_state dicts, hold bitwise-equal tensors."""
    fa = a if isinstance(a, dict) else flat_state(a)
    fb = b if isinstance(b, dict) else flat_state(b)
    assert fa.keys() == fb.keys()
    for key, x in fa.items():
        y = fb[key]
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=key)
