"""One rank of the port's data-parallel tests: runs a list of jobs over a
gloo process group and writes what each produced. Imports no JAX, as a
rank of the port would not.

    python tests/_torch_dp_worker.py RANK WORLD STORE JOBS OUT

(``run_ranks`` starts one such process per rank and collects them.)

``STORE`` is a ``file://`` rendezvous path (under the test's tmp_path, so
parallel test workers never race for a port); ``JOBS`` a pickle the test
wrote; ``OUT`` the pickle this rank writes. Jobs:

* ``("reduce", spec)``: ``reduce_flat`` over this rank's row of
  ``spec["contribs"]`` for ``spec["calls"]`` calls, feeding the residual
  back; returns the sums, the residuals, and every K1 call's input and
  output (codes and scales on the wire);
* ``("train", spec)``: the port's Trainer from the given flax weights over
  ``spec["batches"]`` (this rank's rows of each global batch): a ResNet
  with the image task, with ``spec["lm"]`` a GPT-2 with the causal LM
  task, or with ``spec["mlm"]`` (the task's keywords) a BERT with the
  masked LM task; returns the per-step metrics and the final flax params,
  batch_stats and residual;
  ``spec["optimizer"]`` is ``(name, kwargs)`` (default SGD, momentum
  0.9); the state's per-rank at-rest sizes come back too;
* ``("codec", spec)``: the sharded update's scatters and gathers
  (``spec["ops"]``: (name, function of ``grad_sync``, arguments; arrays
  stacked by rank, ``"HIER"`` for this rank's HierSpec over
  ``spec["slices"]`` slices); returns each output and every K1
  call's input and output;
* ``("bn", spec)``: one BatchNorm over the ranks (``sync_group``), train
  mode, on this rank's rows of ``spec["x"]``, backward from its rows of
  ``spec["dy"]``; returns the output, the new statistics and the
  gradients of x, scale and bias;
* ``("scalars", spec)``: ``reduce_scalar`` of ``rank + 1`` by each op;
* ``("cli", spec)``: the port's entry, ``train.main(spec["argv"][rank])``
  (each rank its own command line), which leaves the process group at
  its end, so it is a process's last job; returns the final step and
  every tensor of the state (``_torch_rig.flat_state``).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from distributed_pytorch_training_tpu_torch.convert import (  # noqa: E402
    batch_stats_to_flax, load_flax_params, torch_to_flax,
)
from distributed_pytorch_training_tpu_torch.models import get_model  # noqa
from distributed_pytorch_training_tpu_torch.models.resnet import (  # noqa
    BatchNorm,
)
from distributed_pytorch_training_tpu_torch.parallel import (  # noqa: E402
    grad_sync,
)
from distributed_pytorch_training_tpu_torch.parallel.collectives import (  # noqa
    reduce_scalar,
)
from distributed_pytorch_training_tpu_torch.runtime import (  # noqa: E402
    cleanup_distributed, setup_distributed,
)
from distributed_pytorch_training_tpu_torch.training import (  # noqa: E402
    TrainConfig, Trainer, make_optimizer,
)
from distributed_pytorch_training_tpu_torch.training.tasks import (  # noqa
    ImageClassificationTask, LanguageModelingTask, MaskedLMTask,
)


def run_reduce(spec, rank, world):
    plan = grad_sync.BucketPlan(spec["total"], tuple(spec["bounds"]))
    flat = torch.from_numpy(spec["contribs"][rank])
    residual = (torch.from_numpy(spec["residual"][rank])
                if spec["residual"] is not None else None)
    k1 = []
    real = grad_sync.quantize_int8_rows

    def recording(rows):
        q, s = real(rows)
        k1.append((rows.numpy().copy(), q.numpy().copy(), s.numpy().copy()))
        return q, s

    grad_sync.quantize_int8_rows = recording
    try:
        sums, residuals = [], []
        for _ in range(spec["calls"]):
            out, residual = grad_sync.reduce_flat(flat, plan, world,
                                                  spec["wire"], residual)
            sums.append(out.numpy().copy())
            residuals.append(None if residual is None
                             else residual.numpy().copy())
    finally:
        grad_sync.quantize_int8_rows = real
    return {"sums": sums, "residuals": residuals, "k1": k1}


def run_train(spec, rank, world):
    if spec.get("lm"):
        model = get_model("gpt2_124m", **spec["model_kwargs"])
        task = LanguageModelingTask()
    elif spec.get("mlm"):
        model = get_model("bert_base", **spec["model_kwargs"])
        task = MaskedLMTask(**spec["mlm"])
    else:
        model = get_model("resnet18", **spec["model_kwargs"])
        task = ImageClassificationTask(spec["mean"], spec["std"],
                                       augment=False)
    load_flax_params(model, spec["params"], spec.get("batch_stats"))
    trainer = Trainer(task, TrainConfig(seed=0, print_freq=1000,
                                        **spec["config"]), device="cpu")
    name, kwargs = spec.get("optimizer", ("sgd", dict(momentum=0.9,
                                                      weight_decay=5e-4)))
    state = trainer.init_state(model, make_optimizer(name, spec["lr"],
                                                     **kwargs))
    metrics = []
    for batch in spec["batches"]:
        local = {k: torch.from_numpy(np.ascontiguousarray(
            np.split(v, world)[rank])) for k, v in batch.items()}
        m = trainer.train_step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    at_rest = {
        "params": [p.numel() for p in state.params],
        "opt": [t.numel() for slots in state.optimizer.state.values()
                for t in slots.values() if t.dim() >= 1]}
    with trainer.materialized(state):
        snap = snapshot(state)
    return {"metrics": metrics, "step": state.step, "at_rest": at_rest,
            **snap}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def snapshot(state):
    """Flax params, batch_stats and the residual of a TrainState."""
    return {"params": torch_to_flax(state.model),
            "batch_stats": batch_stats_to_flax(state.model),
            "ef": _numpy(state.grad_sync)}


def run_codec(spec, rank, world):
    hier = (grad_sync.build_hier_spec(world, rank, spec["slices"])
            if spec.get("slices", 1) > 1 else None)
    k1 = []
    real = grad_sync.quantize_int8_rows

    def recording(rows):
        q, s = real(rows)
        k1.append((rows.numpy().copy(), q.numpy().copy(), s.numpy().copy()))
        return q, s

    grad_sync.quantize_int8_rows = recording
    out = {}
    try:
        for name, fn, args in spec["ops"]:
            k1.clear()
            # arrays are stacked by rank; "HIER" stands for the spec
            mine = [torch.from_numpy(np.ascontiguousarray(a[rank]))
                    if isinstance(a, np.ndarray)
                    else hier if isinstance(a, str) and a == "HIER" else a
                    for a in args]
            res = getattr(grad_sync, fn)(*mine)
            res = res if isinstance(res, tuple) else (res,)
            out[name] = {"out": [None if r is None else r.numpy().copy()
                                 for r in res], "k1": list(k1)}
    finally:
        grad_sync.quantize_int8_rows = real
    return out


def run_bn(spec, rank, world):
    bn = BatchNorm(spec["x"].shape[1])
    bn.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(spec["scale"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    bn.sync_group = dist.group.WORLD
    x = torch.from_numpy(np.split(spec["x"], world)[rank]).requires_grad_()
    dy = torch.from_numpy(np.split(spec["dy"], world)[rank])
    new_stats = {}
    y = bn(x, new_stats)
    (y * dy).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dscale": bn.scale.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            **{k: v.numpy() for k, v in new_stats.items()}}


def run_scalars(spec, rank, world):
    return {op: reduce_scalar(rank + 1, op) for op in ("sum", "max", "mean")}


def run_ranks(tmp_path: Path, world: int, jobs: dict, timeout=240) -> list:
    """Run ``jobs`` on ``world`` gloo ranks (one worker process each);
    returns every rank's results."""
    jobs_path = tmp_path / "jobs.pkl"
    with open(jobs_path, "wb") as f:
        pickle.dump(jobs, f)
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), str(world),
         str(store), str(jobs_path), str(outs[r])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def run_cli(spec, rank, world):
    from _torch_rig import flat_state
    from distributed_pytorch_training_tpu_torch import train

    state = train.main(spec["argv"][rank])
    return {"step": state.step,
            "state": {k: v.numpy() for k, v in flat_state(state).items()}}


RUNNERS = {"reduce": run_reduce, "train": run_train, "bn": run_bn,
           "scalars": run_scalars, "cli": run_cli, "codec": run_codec}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, jobs_path, out_path = sys.argv[3:6]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    setup_distributed(torch.device("cpu"), init_method=f"file://{store}")
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    results = {}
    for name, (kind, spec) in jobs.items():
        results[name] = RUNNERS[kind](spec, rank, world)
    cleanup_distributed()
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main()
