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
  every tensor of the state (``_torch_rig.flat_state``);
* ``("clis", spec)``: ``train.main`` once for each of ``spec["runs"]``
  (a list of per-rank command lines) with the process group kept between
  the runs; returns each run's final step and state, and the metrics of
  every step (its own process, as ``cli``);
* ``("lm_logits", spec)``: GPT-2 from ``spec["params"]`` (flax) with the
  ``spec["attention"]`` ("ring" or "ulysses") attention over the mesh
  ``spec["mesh"]`` (MeshSpec keywords) on this rank's rows and sequence
  shard of ``spec["ids"]``; returns the logits of that block;
* ``("tp_ops", spec)``: tensor parallelism's region operators and the
  parallel-vocab cross-entropy over the model group of the mesh
  ``spec["mesh"]`` (MeshSpec keywords): ``copy_to_tp`` and
  ``reduce_from_tp`` of this model shard's ``spec["a"][m]`` with its
  cotangent ``spec["g"][m]``, ``reduce_from_tp``
  of its ``spec["a"][m]`` in bf16, and ``tp_parallel_cross_entropy`` of
  its columns of ``spec["logits"]`` against ``spec["targets"]`` with the
  gradient of the summed CE; returns the outputs and gradients;
* ``("tp_model", spec)``: the GPT-2 of ``spec["params"]`` (flax, global)
  cut to this rank's TP-local model on ``spec["mesh"]``: the logits (this
  shard's columns when vocab-parallel), the causal LM loss of
  ``spec["ids"]`` and its gradients (TP-local, flax paths), and the
  all-reduces over the model group that one forward and backward made;
  with ``spec["model"]`` ``bert_base`` the masked LM loss of
  ``spec["ids"]`` under the step key ``spec["key"]`` (its uint32 words),
  with ``vit_b16`` the image task's loss of ``spec["images"]`` (uint8
  NHWC, ``spec["labels"]``, ``spec["stats"]`` the mean and std, no
  augmentation);
* ``("tp_train", spec)``: the Trainer on ``spec["mesh"]`` from the global
  flax ``spec["params"]`` over ``spec["batches"]`` (this rank's batch
  coordinate's rows), ``spec["config"]`` and ``spec["optimizer"]``
  (``spec["model"]`` and, for BERT, ``spec["mlm"]`` the masked LM task's
  keywords);
  returns the per-step metrics, the final TP-local parameters (flax
  paths; materialized under FSDP), the residuals' total and the at-rest
  sizes;
* ``("pipe_ops", spec)``: ``pipeline_apply`` of a toy residual layer
  (``h + gelu(h) @ kernel + bias``) over the ``pipe`` axis of
  ``spec["mesh"]``: this stage's slice of ``spec["stacked"]`` ((L, ...)
  leaves), ``spec["x"]``, ``spec["microbatches"]``, backward from the
  cotangent ``spec["ct"]``, in float32 and bf16; returns the output and
  the gradients of x and of this stage's leaves;
* ``("split_model", spec)``: the pipelined GPT-2 (``spec["kind"]``
  "pipe") or gpt2_moe ("moe") of the global flax ``spec["params"]`` cut
  to this rank's part on ``spec["mesh"]`` (a pipe or an expert axis):
  the causal LM loss of ``spec["ids"]`` (the router loss added for the
  MoE), its gradients (local, flax paths), the aux losses and the
  logits;
* ``("split_train", spec)``: the Trainer on ``spec["mesh"]`` from the
  global ``spec["params"]`` of that model over ``spec["batches"]``;
  returns the per-step metrics, the final local parameters and each
  leaf's split dim;
* ``("mesh_train", spec)``: the Trainer on ``spec["mesh"]`` (any of the
  fsdp axis, ZeRO-1 on a model mesh, seq x model, gpt2_moe on model or
  seq) from the global flax ``spec["params"]`` of ``spec["model"]``
  (``spec["attention"]`` "ring" or "ulysses" over seq) over
  ``spec["batches"]`` (this rank's batch coordinate's rows; the causal
  LM task over its sequence shard, with the router loss for the MoE);
  returns the per-step metrics, aux losses and MoE dispatch slots, the
  final global parameters (``checkpoint.global_params``), each
  parameter's and moment's elements at rest, and the logits of
  ``spec["ids"]`` from the initial weights (this rank's rows and
  positions; its columns when vocab-split); with ``spec["error"]`` it
  only builds the Trainer and returns the error's message;
* ``("moe_seq_layer", spec)``: one ``MoeMlp`` (``spec["layer"]`` its
  keywords, ``spec["params"]`` its tensors) over the seq line of
  ``spec["mesh"]`` on this rank's sequence shard of ``spec["x"]``,
  backward from its shard of ``spec["g"]``; returns the output, the
  input's gradient, the dispatch slots and the aux loss;
* ``("seq_attention", spec)``: sequence-parallel attention over the
  default group, one sequence shard a rank: for each case ``(label, op,
  causal, use_kernels, dtype)`` of ``spec["cases"]``, ``op`` ("ring" or
  "ulysses") on this rank's shard of ``spec["q"]``, ``["k"]``, ``["v"]``
  (B, S, H, D), backward from its shard of ``spec["g"]``; returns the
  output and dq, dk, dv shards as float32, and ``ppermute_ring`` and the
  tiled ``all_to_all`` of small rank-stamped tensors (float32 and bf16).
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
from distributed_pytorch_training_tpu_torch.data.augment import (  # noqa
    normalize_images,
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


def run_clis(spec, rank, world):
    from _torch_rig import flat_state
    from distributed_pytorch_training_tpu_torch import train
    from distributed_pytorch_training_tpu_torch.training import (
        Trainer as PortTrainer,
    )

    step = PortTrainer.train_step
    cleanup = train.cleanup_distributed
    metrics = []

    def recording(self, state, batch):
        m = step(self, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        return m

    PortTrainer.train_step = recording
    train.cleanup_distributed = lambda: None
    out = []
    try:
        for argv in spec["runs"]:
            metrics.clear()
            state = train.main(argv[rank])
            out.append({"step": state.step, "metrics": list(metrics),
                        "state": {k: v.numpy() for k, v in
                                  flat_state(state).items()}})
    finally:
        PortTrainer.train_step = step
        train.cleanup_distributed = cleanup
    return out


def run_lm_logits(spec, rank, world):
    from distributed_pytorch_training_tpu_torch.ops import (
        make_ring_attention_fn, make_ulysses_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.parallel.mesh import (
        SEQ, MeshSpec, build_mesh,
    )

    mesh = build_mesh(MeshSpec(**spec["mesh"]))
    make = (make_ring_attention_fn if spec["attention"] == "ring"
            else make_ulysses_attention_fn)
    model = get_model("gpt2_124m", attention_fn=make(mesh, causal=True),
                      **spec["model_kwargs"])
    load_flax_params(model, spec["params"])
    ids = np.split(spec["ids"], mesh.shape["data"])[mesh.batch_index]
    n, i = mesh.shape[SEQ], mesh.coords()[SEQ]
    width = ids.shape[1] // n
    with torch.no_grad():
        logits = model(torch.from_numpy(ids[:, i * width:(i + 1) * width])
                       .long(), pos_offset=i * width)
    return logits.numpy()


def run_seq_attention(spec, rank, world):
    import importlib

    from distributed_pytorch_training_tpu_torch.parallel.collectives import (
        AxisGroup, all_to_all, ppermute_ring, ppermute_ring_many,
    )

    ops = "distributed_pytorch_training_tpu_torch.ops."
    ra = importlib.import_module(ops + "ring_attention")
    ua = importlib.import_module(ops + "ulysses_attention")
    axis = AxisGroup(None)
    out = {}
    for label, op, causal, use_kernels, dtype in spec["cases"]:
        dt = getattr(torch, dtype)
        q, k, v, g = (torch.from_numpy(np.ascontiguousarray(
            np.split(spec[n], world, axis=1)[rank])).to(dt)
            for n in "qkvg")
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        fn = (ra.ring_attention_sharded if op == "ring"
              else ua.ulysses_attention_sharded)
        o = fn(q, k, v, axis, causal, use_kernels=use_kernels)
        grads = torch.autograd.grad(o, (q, k, v), g)
        out[label] = [t.detach().float().numpy()
                      for t in (o, *grads)]
    stamp = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out["rotate"] = {
        shift: ppermute_ring(stamp, None, shift).numpy()
        for shift in (1, -1, 2)}
    many = ppermute_ring_many([stamp, stamp.to(torch.bfloat16)[:1]])
    out["rotate_many"] = [t.float().numpy() for t in many]
    blocks = (torch.arange(world * 4, dtype=torch.float32).reshape(
        1, world * 2, 2) + 10 * rank).to(torch.bfloat16)
    out["all_to_all"] = all_to_all(blocks, None, 1, 2).float().numpy()
    return out


def _tp_mesh(spec):
    from distributed_pytorch_training_tpu_torch.parallel.mesh import (
        MeshSpec, build_mesh,
    )

    return build_mesh(MeshSpec(**spec["mesh"]))


def run_tp_ops(spec, rank, world):
    from distributed_pytorch_training_tpu_torch.parallel.collectives import (
        TpShardedLogits, copy_to_tp, reduce_from_tp,
        tp_parallel_cross_entropy,
    )

    mesh = _tp_mesh(spec)
    tp = mesh.tp()
    m = tp.index
    out = {"index": m, "batch_index": mesh.batch_index}
    for name, op in (("copy", lambda a: copy_to_tp(a, tp)),
                     ("reduce", lambda a: reduce_from_tp(a, tp))):
        a = torch.from_numpy(spec["a"][m]).requires_grad_()
        y = op(a)
        g = torch.from_numpy(spec["g"][m])
        (ga,) = torch.autograd.grad(y, a, g)
        out[name] = (y.detach().numpy(), ga.numpy())
    out["reduce bf16"] = reduce_from_tp(
        torch.from_numpy(spec["a"][m]).to(torch.bfloat16), tp
    ).float().numpy()
    full = spec["logits"]
    rows = full.shape[-1] // tp.size
    local = torch.from_numpy(np.ascontiguousarray(
        full[..., m * rows:(m + 1) * rows])).requires_grad_()
    ce, correct = tp_parallel_cross_entropy(
        TpShardedLogits(local, tp, rows, full.shape[-1]),
        torch.from_numpy(spec["targets"]))
    (gl,) = torch.autograd.grad(ce.sum(), local)
    out["ce"] = (ce.detach().numpy(), correct.numpy(), gl.numpy())
    return out


def _named_flax(named):
    from distributed_pytorch_training_tpu_torch.convert import (
        name_to_flax_path,
    )

    return {"/".join(name_to_flax_path(n)): t.detach().float().numpy().copy()
            for n, t in named}


def run_tp_model(spec, rank, world):
    from distributed_pytorch_training_tpu_torch.convert import (
        load_tp_params,
    )
    from distributed_pytorch_training_tpu_torch.parallel.collectives import (
        TpShardedLogits,
    )
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        tp_split_dims,
    )

    from distributed_pytorch_training_tpu_torch.training.tasks import (
        StepKey,
    )

    mesh = _tp_mesh(spec)
    tp = mesh.tp()
    name = spec.get("model", "gpt2_124m")
    full = get_model(name, **spec["model_kwargs"])
    load_flax_params(full, spec["params"])
    split = tp_split_dims(list(full.named_parameters()),
                          full.partition_rules(), tp.size)
    model = full.clone(tp=tp)
    load_tp_params(model, spec["params"], split)
    key = None
    if name == "vit_b16":
        x = torch.from_numpy(spec["images"])
        batch = {"image": x, "label": torch.from_numpy(spec["labels"]),
                 "weight": torch.ones(x.shape[0])}
        task = ImageClassificationTask(*spec["stats"], augment=False)
        inputs = normalize_images(x, *spec["stats"])
    else:
        x = torch.from_numpy(spec["ids"]).long()
        batch = {"input_ids": x, "weight": torch.ones(x.shape[0])}
        task, inputs = LanguageModelingTask(), x
        if name == "bert_base":
            key = StepKey(torch.from_numpy(spec["key"]))
            task = MaskedLMTask(vocab_size=spec["model_kwargs"]["vocab_size"])
            inputs = task.mask(x, key)[1]
    calls = []
    real = dist.all_reduce

    def counting(t, *args, **kwargs):
        calls.append(kwargs.get("group"))
        return real(t, *args, **kwargs)

    dist.all_reduce = counting
    try:
        loss, metrics, _ = task.loss_and_metrics(model, batch, True, key=key)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        dist.all_reduce = real
    with torch.no_grad():
        logits = model(inputs)
    local = (logits.local if isinstance(logits, TpShardedLogits)
             else logits)
    return {"index": tp.index, "batch_index": mesh.batch_index,
            "logits": local.numpy(),
            "loss": float(loss), "correct": float(metrics["correct"]),
            "grads": _named_flax(zip((n for n, _ in
                                      model.named_parameters()), grads)),
            "all_reduces": sum(g is tp.group for g in calls),
            "tp_vocab": getattr(model, "tp_vocab", False)}


def run_tp_train(spec, rank, world):
    mesh = _tp_mesh(spec)
    model = get_model(spec.get("model", "gpt2_124m"), **spec["model_kwargs"])
    load_flax_params(model, spec["params"])
    task = (MaskedLMTask(**spec["mlm"]) if "mlm" in spec
            else LanguageModelingTask())
    trainer = Trainer(task, TrainConfig(
        seed=0, print_freq=1000, **spec["config"]), device="cpu", mesh=mesh)
    name, kwargs = spec["optimizer"]
    state = trainer.init_state(model, make_optimizer(name, spec["lr"],
                                                     **kwargs))
    n_batch = len(mesh.line(("slice", "data", "fsdp")))
    metrics = []
    for batch in spec["batches"]:
        local = {k: torch.from_numpy(np.ascontiguousarray(
            np.split(v, n_batch)[mesh.batch_index])) for k, v in batch.items()}
        m = trainer.train_step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    at_rest = {"params": [p.numel() for p in state.params],
               "opt": [t.numel() for slots in state.optimizer.state.values()
                       for t in slots.values() if t.dim() >= 1]}
    ef = state.grad_sync.get("ef") or {}
    with trainer.materialized(state):
        params = _named_flax(state.model.named_parameters())
    return {"index": mesh.tp().index, "batch_index": mesh.batch_index,
            "metrics": metrics, "params": params, "at_rest": at_rest,
            "ef_abs_sum": float(sum(r.abs().sum() for r in ef.values())),
            "ef_groups": sorted(ef)}


def run_mesh_train(spec, rank, world):
    from distributed_pytorch_training_tpu_torch.convert import (
        flax_ordered, name_to_flax_path,
    )
    from distributed_pytorch_training_tpu_torch.ops import (
        make_ring_attention_fn, make_ulysses_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.parallel.collectives import (
        TpShardedLogits,
    )
    from distributed_pytorch_training_tpu_torch.parallel.mesh import (
        BATCH_AXES, SEQ,
    )
    from distributed_pytorch_training_tpu_torch.training.checkpoint import (
        global_params,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        MoeLanguageModelingTask,
    )

    mesh = _tp_mesh(spec)
    name = spec.get("model", "gpt2_124m")
    kw = dict(spec["model_kwargs"])
    attention = spec.get("attention")
    if attention:
        make = (make_ring_attention_fn if attention == "ring"
                else make_ulysses_attention_fn)
        kw["attention_fn"] = make(mesh, causal=True)
    moe = "moe" in name
    if moe:
        kw.update(seq=mesh.axis_shard(SEQ), batch=mesh.line_shard(BATCH_AXES))
    model = get_model(name, **kw)
    load_flax_params(model, spec["params"])
    coords = mesh.coords()
    task_kw = dict(seq_index=coords[SEQ], seq_shards=mesh.shape[SEQ])
    task = (MoeLanguageModelingTask(**task_kw) if moe
            else LanguageModelingTask(**task_kw))
    config = TrainConfig(seed=0, print_freq=1000, **spec["config"])
    rules = type(model).partition_rules()
    if "error" in spec:
        try:
            trainer = Trainer(task, config, device="cpu", mesh=mesh,
                              rules=rules)
            opt_name, kwargs = spec["optimizer"]
            trainer.init_state(model, make_optimizer(opt_name, spec["lr"],
                                                     **kwargs))
        except (ValueError, NotImplementedError) as e:
            return {"error": f"{type(e).__name__}: {e}"}
        return {"error": None}
    trainer = Trainer(task, config, device="cpu", mesh=mesh, rules=rules)
    opt_name, kwargs = spec["optimizer"]
    state = trainer.init_state(model, make_optimizer(opt_name, spec["lr"],
                                                     **kwargs))
    local_model = state.model
    n_batch = len(mesh.line(BATCH_AXES))
    out = {"coords": coords, "batch_index": mesh.batch_index}
    if "ids" in spec:
        ids = np.split(spec["ids"], n_batch)[mesh.batch_index]
        width = ids.shape[1] // mesh.shape[SEQ]
        lo = coords[SEQ] * width
        with torch.no_grad():
            logits = local_model(torch.from_numpy(ids[:, lo:lo + width]),
                                 pos_offset=lo)
        out["logits"] = (logits.local if isinstance(logits, TpShardedLogits)
                         else logits).numpy()
    metrics, aux, dispatch = [], [], []
    for batch in spec["batches"]:
        local = {k: torch.from_numpy(np.ascontiguousarray(
            np.split(v, n_batch)[mesh.batch_index])) for k, v in batch.items()}
        m = trainer.train_step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
        if moe:
            aux.append([float(a) for a in local_model.aux_losses])
            dispatch.append([b.moe.last_dispatch.numpy()
                             for b in local_model.blocks
                             if hasattr(b, "moe")])
    targets = (state.sharding.shards if state.sharding is not None
               else [p for _, p in flax_ordered(
                   local_model.named_parameters())])
    paths = ["/".join(name_to_flax_path(n)) for n, _ in flax_ordered(
        local_model.named_parameters())]
    by_id = {id(t): path for t, path in zip(targets, paths)}
    at_rest = {"params": {path: p.numel() for path, (_, p) in zip(
                   paths, flax_ordered(local_model.named_parameters()))},
               "opt": {by_id[id(p)]: [t.numel() for t in
                                      state.optimizer.state[p].values()
                                      if t.dim() >= 1]
                       for g in state.optimizer.param_groups
                       for p in g["params"]}}
    out.update(metrics=metrics, aux=aux, dispatch=dispatch, at_rest=at_rest,
               params=_named_flax(global_params(state).items()),
               fsdp=(dict(zip(paths, state.fsdp.dims))
                     if state.fsdp is not None else None))
    return out


def run_moe_seq_layer(spec, rank, world):
    from distributed_pytorch_training_tpu_torch.models.moe import MoeMlp
    from distributed_pytorch_training_tpu_torch.parallel.mesh import SEQ

    mesh = _tp_mesh(spec)
    seq = mesh.axis_shard(SEQ)
    layer = MoeMlp(**spec["layer"], seq=seq)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(spec["params"][name]))
    width = spec["x"].shape[1] // seq.size
    part = slice(seq.index * width, (seq.index + 1) * width)
    x = torch.from_numpy(spec["x"][:, part]).requires_grad_()
    y = layer(x)
    (y * torch.from_numpy(spec["g"][:, part])).sum().backward()
    return {"index": seq.index, "y": y.detach().numpy(),
            "dx": x.grad.numpy(), "dispatch": layer.last_dispatch.numpy(),
            "aux": float(layer.last_aux)}


def _split_axis(spec):
    """(mesh, the axis the model splits over, its TpAxis)."""
    mesh = _tp_mesh(spec)
    name = "pipe" if mesh.shape["pipe"] > 1 else "expert"
    return mesh, name, mesh.axis_shard(name)


def run_pipe_ops(spec, rank, world):
    from distributed_pytorch_training_tpu_torch.models.layers import gelu
    from distributed_pytorch_training_tpu_torch.parallel.pipeline import (
        pipeline_apply, stack_to_stages,
    )

    mesh = _tp_mesh(spec)
    ax = mesh.axis_shard("pipe")
    stages = stack_to_stages(
        {k: torch.from_numpy(v) for k, v in spec["stacked"].items()},
        ax.size)
    params = {k: v[ax.index:ax.index + 1].clone().requires_grad_()
              for k, v in stages.items()}

    def apply_layer(p, h):
        return h + gelu(h) @ p["kernel"] + p["bias"]

    out = {"index": ax.index}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(spec["x"]).to(dtype).requires_grad_()
        y = pipeline_apply(apply_layer, {k: v.to(dtype)
                                         for k, v in params.items()},
                           x, ax, spec["microbatches"])
        grads = torch.autograd.grad(
            (y.float() * torch.from_numpy(spec["ct"])).sum(),
            [x] + [params[k] for k in sorted(params)])
        out[str(dtype)] = {
            "y": y.detach().float().numpy(),
            "g_x": grads[0].float().numpy(),
            "g": {k: g.numpy() for k, g in zip(sorted(params), grads[1:])}}
    return out


def _split_global_model(spec):
    from distributed_pytorch_training_tpu_torch.models import (
        GPT2PipeLMHead,
    )

    if spec["kind"] == "pipe":
        model = GPT2PipeLMHead(**spec["model_kwargs"])
    else:
        model = get_model("gpt2_moe", **spec["model_kwargs"])
    load_flax_params(model, spec["params"])
    return model


def _split_local(spec, model):
    from distributed_pytorch_training_tpu_torch.convert import (
        load_tp_params,
    )
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        tp_split_dims,
    )

    mesh, name, ax = _split_axis(spec)
    split = tp_split_dims(list(model.named_parameters()),
                          model.partition_rules(), ax.size, name)
    local = model.clone(**{"pipe" if name == "pipe" else "expert": ax})
    load_tp_params(local, spec["params"], split, ax)
    return mesh, ax, local


def _split_task(spec):
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        MoeLanguageModelingTask,
    )

    return (LanguageModelingTask() if spec["kind"] == "pipe"
            else MoeLanguageModelingTask())


def run_split_model(spec, rank, world):
    mesh, ax, model = _split_local(spec, _split_global_model(spec))
    ids = torch.from_numpy(spec["ids"]).long()
    batch = {"input_ids": ids, "weight": torch.ones(ids.shape[0])}
    loss, metrics, _ = _split_task(spec).loss_and_metrics(model, batch, True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    aux = [float(a) for a in getattr(model, "aux_losses", [])]
    with torch.no_grad():
        logits = model(ids)
    return {"index": ax.index, "loss": float(loss),
            "loss_sum": float(metrics["loss_sum"]), "aux": aux,
            "logits": logits.numpy(), "grads": _named_flax(zip(names, grads))}


def run_split_train(spec, rank, world):
    mesh = _tp_mesh(spec)
    model = _split_global_model(spec)
    trainer = Trainer(_split_task(spec), TrainConfig(
        seed=0, print_freq=1000), device="cpu", mesh=mesh)
    name, kwargs = spec["optimizer"]
    state = trainer.init_state(model, make_optimizer(name, spec["lr"],
                                                     **kwargs))
    metrics = []
    for batch in spec["batches"]:
        local = {k: torch.from_numpy(v) for k, v in batch.items()}
        m = trainer.train_step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"index": state.tp.axis.index, "metrics": metrics,
            "params": _named_flax(state.model.named_parameters()),
            "split": dict(zip(state.tp.names, state.tp.split_dims))}


def run_cli(spec, rank, world):
    from _torch_rig import flat_state
    from distributed_pytorch_training_tpu_torch import train

    state = train.main(spec["argv"][rank])
    return {"step": state.step,
            "state": {k: v.numpy() for k, v in flat_state(state).items()}}


RUNNERS = {"reduce": run_reduce, "train": run_train, "bn": run_bn,
           "scalars": run_scalars, "cli": run_cli, "codec": run_codec,
           "clis": run_clis, "seq_attention": run_seq_attention,
           "lm_logits": run_lm_logits, "tp_ops": run_tp_ops,
           "tp_model": run_tp_model, "tp_train": run_tp_train,
           "pipe_ops": run_pipe_ops, "split_model": run_split_model,
           "split_train": run_split_train, "mesh_train": run_mesh_train,
           "moe_seq_layer": run_moe_seq_layer}


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
