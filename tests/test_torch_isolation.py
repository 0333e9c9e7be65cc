"""The PyTorch port stands alone and never runs on the CPU by accident.

* An AST scan: no module of ``distributed_pytorch_training_tpu_torch`` and
  not ``chip_smoke.py`` imports ``jax``, ``flax`` or the JAX package.
* Entry points called with no device raise on a machine with no CUDA,
  instead of running on the CPU.
"""

import ast
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "distributed_pytorch_training_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "distributed_pytorch_training_tpu")
TINY = dict(vocab_size=97, hidden_dim=32, depth=2, num_heads=2)


def port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_scan_covers_the_port():
    names = {p.relative_to(REPO).as_posix() for p in port_sources()}
    port = "distributed_pytorch_training_tpu_torch/"
    for must in ("chip_smoke.py", port + "ops/quantize.py",
                 port + "serving/engine.py",
                 # the continuous-serving slice's modules
                 *(port + f"serving/{m}.py" for m in (
                     "continuous", "paged", "speculative", "router")),
                 port + "utils/prng.py", port + "experiments/harness.py",
                 # the BERT and ViT slice's models
                 port + "models/bert.py", port + "models/vit.py",
                 # the sequence-parallel slice's modules
                 port + "parallel/mesh.py", port + "ops/ring_attention.py",
                 port + "ops/ulysses_attention.py",
                 # the tensor-parallel slice's modules
                 port + "parallel/collectives.py",
                 port + "parallel/sharding.py", port + "models/layers.py",
                 port + "models/gpt2.py", port + "convert.py",
                 port + "training/loop.py", port + "training/checkpoint.py",
                 # the pipeline and MoE slice's modules
                 port + "parallel/pipeline.py", port + "models/gpt2_pipe.py",
                 port + "models/moe.py", port + "training/tasks.py",
                 # the telemetry slice's modules
                 port + "utils/locktrace.py", port + "utils/profiling.py",
                 port + "experiments/trace_analysis.py",
                 *(port + f"telemetry/{m}.py" for m in (
                     "__init__", "recorder", "flight", "watchdog",
                     "aggregate", "metrics_http", "__main__", "device"))):
        assert must in names


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom distributed_pytorch_training_tpu.ops "
                 "import quantize\n")
    assert "distributed_pytorch_training_tpu" in imported_roots(f)


def test_package_import_pulls_in_no_jax():
    """Importing every port module in a fresh interpreter adds no jax
    module to ``sys.modules`` (compared with what the interpreter had
    loaded before, so a site hook that preloads jax does not count)."""
    import subprocess

    mods = sorted(
        "distributed_pytorch_training_tpu_torch."
        + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\npre = set(sys.modules)\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in set(sys.modules) - pre if m.split('.')[0] "
            + f"in {FORBIDDEN!r}]\nassert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-device default "
                    "runs there")


def test_resolve_device_defaults_to_cuda_and_raises(no_cuda):
    from distributed_pytorch_training_tpu_torch.runtime import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_serving_engine_without_device_raises(no_cuda):
    from distributed_pytorch_training_tpu_torch.experiments.harness import (
        build_serving_engine,
    )

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serving_engine("gpt2_124m", model_overrides=TINY)


def test_engine_without_device_raises(no_cuda):
    from distributed_pytorch_training_tpu_torch.models import GPT2LMHead
    from distributed_pytorch_training_tpu_torch.serving import (
        InferenceEngine, ServeConfig,
    )

    model = GPT2LMHead(**TINY, max_position=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, ServeConfig(buckets=(8,), max_new_tokens=4),
                        dict(model.named_parameters()))


def test_smoke_cli_without_device_raises(no_cuda):
    from distributed_pytorch_training_tpu_torch.serving.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["smoke", "--no-telemetry", "--model-overrides",
              "vocab_size=97,hidden_dim=32,depth=2,num_heads=2"])
