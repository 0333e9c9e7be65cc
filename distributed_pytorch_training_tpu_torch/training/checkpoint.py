"""Checkpoint and resume (the JAX package's training/checkpoint.py, with
``torch.save`` in place of orbax).

Layout under the checkpoint directory, the JAX package's protocol:

* ``<label>/`` holds one checkpoint: ``params.pt`` (the parameters by
  name, in flax order), ``batch_stats.pt``, ``opt_state.pt``
  (``optimizer.state_dict()``: SGD momentum buffers; AdamW ``exp_avg``,
  ``exp_avg_sq`` and ``step``), ``grad_sync.pt`` (the int8 wires'
  error-feedback residuals, one row per rank, only when non-empty) and
  ``meta.json`` (``step``, ``epoch``, ``step_in_epoch``, the optimizer's
  class, the parameters' shapes and, when the manager was given one, the
  run's mesh: every axis's size). It is written under a temporary name
  and renamed into place, so a label directory is a committed write.
  Files are read back with ``torch.load(weights_only=True)``.
* ``.manifests/<label>.json``: ``step``, ``epoch``, ``step_in_epoch``,
  ``world_size``, the saved shapes, and per file its ``size`` and chunked
  ``sha256``, with a tree digest over them. ``restore_latest`` verifies
  it before trusting a checkpoint: a torn one (truncated, corrupt) is
  skipped with a loud log line naming it.
* ``.manifests/<label>.pending``: written before the write starts and
  removed after the manifest, so a writer that died between the commit
  and the manifest leaves a checkpoint that verifies as torn.

Snapshot, then write. ``save`` copies every tensor to host memory on the
caller's thread (the optimizer updates the parameters and moments in
place, so a writer holding references would write a later step's
values); one background writer then writes the files, hashes them and
writes the manifest while training goes on. The next ``save``, ``wait``,
``close`` and every restore join it first; a failed write is raised by
the next ``save`` or ``wait`` (logged by the others).

Several ranks (``torch.distributed``): the parameters, BatchNorm
statistics and optimizer state are the same on every rank, so rank 0
writes them; the error-feedback residual is per rank, so ``save``
gathers every rank's row to rank 0 (a collective). The sharded update
(``TrainState.sharding``) is saved as the JAX package's global arrays:
ZeRO-1's moments, and explicit FSDP's parameters and moments, as each
leaf's whole flat-padded vector (the chunks gathered to rank 0 in chunk
order), its residuals as ``{"ef": {leaf or layer group: (n, R)}}``;
``meta.json`` records the ``layout`` (``replicated``, ``zero1`` or
``fsdp``) and the parameters' model shapes. Each rank restores its own
chunk. Under tensor parallelism (``TrainState.tp``) the checkpoint holds
the global model too: on the implicit path each leaf and its moments
gathered over the model ranks along the split dim (JAX's GSPMD arrays),
under explicit FSDP the model-major flat layout (over the model shards,
each shard's flat-padded slice in chunk order), the residual rows in the
same order; ``meta.json`` records ``model_shards``, and a restore at
another model degree raises with ``LAYOUT_HINT``. A pipelined model
(``pipe``) and an expert-parallel one (``expert``) are saved the same
way, as the JAX global arrays: the stage-stacked (P, L/P, ...) blocks
gathered over ``pipe``, ``wi`` and ``wo`` over ``expert``
(``pipe_shards``, ``expert_shards``). A checkpoint restores only into the layout and world size it was
written for (resharding is the elastic slice's). Every rank calls
``save``, ``wait`` and the restores at the same points: ``save`` and
``wait`` agree on a failed write (one MAX reduction, so every rank
raises), and a restore begins with a barrier, after rank 0's writer has
finished. Each rank restores its own residual row.

Instruments: ``save_blocked_ms`` (caller-thread ms inside ``save`` and
``wait``), ``snapshot_ms`` (of which the host copy), ``saves_started``,
``bytes_written`` and ``hash_ms`` (the writer's sha256 time). On the
telemetry stream, as in the JAX package: a ``save_blocked`` span for each
``save`` and ``wait``, a ``restore`` span, and a
``torn_checkpoint_skipped`` event for each torn checkpoint a restore
skips.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import telemetry
from ..convert import flax_ordered
from ..parallel.collectives import all_gather, reduce_scalar, world_size
from ..parallel.mesh import SPLIT_AXES
from ..parallel.sharding import (chunk_of, flatten_pad, fsdp_slice, tp_join,
                                 tp_slice, tp_split_dims, tp_unflatten_leaf,
                                 unflatten_padded)
from ..utils.logging import log_main
from .train_state import TrainState

# the hint the JAX entry gives when a checkpoint's layout is not the run's
LAYOUT_HINT = ("resume with the SAME --mesh, --zero1 and --fsdp-explicit "
               "settings (vocab padding for TP follows the model axis; zero1 "
               "stores optimizer state flat-sharded, fsdp-explicit stores "
               "params flat-sharded too, the replicated path stores both "
               "param-shaped)")

_MANIFEST_DIRNAME = ".manifests"
_MANIFEST_FORMAT = 1
_META = "meta.json"
_TENSOR_KEYS = ("params", "batch_stats", "opt_state", "grad_sync")


class CheckpointWorldSizeMismatch(RuntimeError):
    """A checkpoint that carries error-feedback residuals (one row per
    rank) or a sharded update's flat-padded layout restored at another
    world size. ``label`` and ``world_size``
    name the checkpoint and the world it was written at; resharding it is
    the elastic slice's work."""

    label: Optional[int] = None
    world_size: Optional[int] = None


def _file_sha256(path: Path) -> str:
    # chunked: a whole-file read would hold the checkpoint's size in RAM
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _to_host(tree):
    """A copy of ``tree`` whose tensors live in host memory: CUDA tensors
    into pinned buffers with non-blocking copies (the caller synchronizes
    once), CPU tensors cloned."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.device.type == "cpu":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Step-granular save and restore of the newest valid checkpoint.

    ``label`` orders checkpoints (``epoch * steps_per_epoch + step``, so a
    mid-epoch save sorts between the epoch boundaries); the restored
    ``(epoch, step_in_epoch)`` says where to resume. Saves write on the
    background writer; ``save(..., wait=True)`` waits for the write (the
    preemption saves, whose process is about to exit).

    ``post_save_hook(label, step_dir)`` fires after a save and its
    manifest finalized (the ``torn_ckpt`` injection point);
    ``pre_finalize_hook(label)`` between the commit and the manifest (the
    ``crash_during_save`` point). Both run where the files are written,
    on rank 0. ``last_skipped`` lists the labels the latest restore
    rejected; ``last_restored`` is the label it restored."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 post_save_hook: Optional[Callable[[int, Path], None]]
                 = None,
                 pre_finalize_hook: Optional[Callable[[int], None]] = None,
                 mesh: Optional[Dict[str, int]] = None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self._dir = Path(directory).resolve()
        self._max_to_keep = max_to_keep
        self._post_save_hook = post_save_hook
        self._pre_finalize_hook = pre_finalize_hook
        self._mesh = dict(mesh) if mesh is not None else None
        self._world = world_size()
        self._rank = dist.get_rank() if self._world > 1 else 0
        if self._rank == 0:
            self._dir.mkdir(parents=True, exist_ok=True)
        self.last_skipped: List[int] = []
        self.last_restored: Optional[int] = None
        # labels proven torn (label -> problem): a torn checkpoint stays
        # torn, so later restores do not hash it again; cleared on re-save
        self._known_bad: Dict[int, str] = {}
        # the one write in flight and its failure. The writer thread sets
        # _writer_error/_writer_label; the caller reads them only after
        # joining it, and at most one writer exists at a time.
        self._writer: Optional[threading.Thread] = None
        self._writer_label: Optional[int] = None
        self._writer_error: Optional[BaseException] = None
        self.save_blocked_ms = 0.0
        self.snapshot_ms = 0.0
        self.saves_started = 0
        self.bytes_written = 0
        self.hash_ms = 0.0

    # -- layout ---------------------------------------------------------------

    def _step_dir(self, label: int) -> Path:
        return self._dir / str(label)

    def _manifest_path(self, label: int) -> Path:
        return self._dir / _MANIFEST_DIRNAME / f"{label}.json"

    def _pending_path(self, label: int) -> Path:
        return self._dir / _MANIFEST_DIRNAME / f"{label}.pending"

    def all_steps(self) -> List[int]:
        """The committed labels, ascending."""
        if not self._dir.is_dir():
            return []
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    # -- manifest -------------------------------------------------------------

    @staticmethod
    def _shape_summary(snapshot: dict) -> dict:
        """Sorted shape multisets of the saved parameters, optimizer state
        and residuals."""
        return {key: sorted(list(t.shape) for t in _tensors(snapshot[key]))
                for key in ("params", "opt_state", "grad_sync")
                if key in snapshot}

    def _write_manifest(self, label: int, meta: dict,
                        shapes: dict) -> None:
        step_dir = self._step_dir(label)
        files = {}
        tree = hashlib.sha256()
        t0 = time.perf_counter()
        for p in sorted(step_dir.rglob("*")):
            if not p.is_file():
                continue
            rel = p.relative_to(step_dir).as_posix()
            digest = _file_sha256(p)
            size = p.stat().st_size
            files[rel] = {"size": size, "sha256": digest}
            tree.update(f"{rel}\0{size}\0{digest}\0".encode())
        self.hash_ms += (time.perf_counter() - t0) * 1e3
        manifest = {"format": _MANIFEST_FORMAT, "label": label,
                    "step": meta["step"], "epoch": meta["epoch"],
                    "step_in_epoch": meta["step_in_epoch"],
                    "n_files": len(files), "tree_digest": tree.hexdigest(),
                    "files": files, "shapes": shapes}
        if meta.get("world_size") is not None:
            manifest["world_size"] = meta["world_size"]
        path = self._manifest_path(label)
        path.parent.mkdir(parents=True, exist_ok=True)
        # atomic: a manifest torn by a crash must read as invalid, never
        # as a half-truth that vouches for a half-checkpoint
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(manifest, sort_keys=True))
        os.replace(tmp, path)
        # manifests and pending markers of pruned checkpoints go too
        live = {str(s) for s in self.all_steps()}
        for stale in list(path.parent.glob("*.json")) \
                + list(path.parent.glob("*.pending")):
            if stale.stem not in live:
                stale.unlink(missing_ok=True)

    def verify(self, label: int) -> Optional[str]:
        """None when intact (or legacy: no manifest and no pending
        marker, restored unverified); otherwise what is wrong. Failures
        are cached per label."""
        if label in self._known_bad:
            return self._known_bad[label]
        problem = self._verify_uncached(label)
        if problem is not None:
            self._known_bad[label] = problem
        return problem

    def _verify_uncached(self, label: int) -> Optional[str]:
        path = self._manifest_path(label)
        if not path.exists():
            if self._pending_path(label).exists():
                return ("async save never finalized (pending marker "
                        "present, no manifest: the writer died between "
                        "the commit and the manifest)")
            return None  # legacy checkpoint
        try:
            manifest = json.loads(path.read_text())
            files = manifest["files"]
        except Exception as e:
            return f"unreadable manifest ({e})"
        step_dir = self._step_dir(label)
        for rel, info in files.items():
            p = step_dir / rel
            if not p.is_file():
                return f"file {rel} missing"
            size = p.stat().st_size
            if size != info["size"]:
                return (f"file {rel} truncated ({size} bytes, manifest "
                        f"says {info['size']})")
            if _file_sha256(p) != info["sha256"]:
                return f"file {rel} corrupt (digest mismatch)"
        return None

    # -- the background writer ------------------------------------------------

    def _join_writer(self) -> Tuple[Optional[BaseException], Optional[int]]:
        """Join the write in flight; returns its failure and label
        (cleared)."""
        t = self._writer
        if t is not None:
            t.join()
            self._writer = None
        err, self._writer_error = self._writer_error, None
        label, self._writer_label = self._writer_label, None
        return err, label

    def _join_logged(self) -> None:
        """Join the writer for a read: a failed save is a torn or absent
        checkpoint, which verification handles, so it is logged."""
        err, label = self._join_writer()
        if err is not None:
            log_main(f"CHECKPOINT: async save of checkpoint {label} failed "
                     f"({type(err).__name__}: {err}); it will be skipped "
                     "by integrity verification")

    def _join_agreed(self) -> None:
        """Join the writer and raise its failure; on several ranks, every
        rank raises when any rank's write failed (a collective)."""
        err, _ = self._join_writer()
        if self._world > 1:
            failed = reduce_scalar(float(err is not None), "max") > 0
            if failed and err is None:
                err = RuntimeError("a checkpoint write failed on another "
                                   "rank")
        if err is not None:
            raise err

    def _write_job(self, label: int, snapshot: dict, meta: dict) -> None:
        """Everything after the snapshot, on the writer thread: the files,
        the commit, pruning, the manifest, the pending marker's removal
        and the hooks."""
        tmp = self._dir / f".{label}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        for key in _TENSOR_KEYS:
            if key in snapshot:
                torch.save(snapshot[key], tmp / f"{key}.pt")
        (tmp / _META).write_text(json.dumps(meta, sort_keys=True))
        self.bytes_written += sum(p.stat().st_size for p in tmp.iterdir())
        os.replace(tmp, self._step_dir(label))
        for old in self.all_steps()[:-self._max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if self._pre_finalize_hook is not None:
            # the crash_during_save window: committed, no manifest yet
            self._pre_finalize_hook(label)
        self._write_manifest(label, meta, self._shape_summary(snapshot))
        self._pending_path(label).unlink(missing_ok=True)
        if self._post_save_hook is not None:
            self._post_save_hook(label, self._step_dir(label))

    def _writer_main(self, label: int, snapshot: dict, meta: dict) -> None:
        try:
            self._write_job(label, snapshot, meta)
        except BaseException as e:  # raised at the next barrier
            self._writer_error = e
            self._writer_label = label

    # -- save -----------------------------------------------------------------

    @staticmethod
    def _layout(state: TrainState) -> str:
        return state.sharding.mode if state.sharding is not None \
            else "replicated"

    @staticmethod
    def _gather_rows(tensors: List[torch.Tensor], group=None
                     ) -> List[torch.Tensor]:
        """Every rank's copy of each float32 tensor, stacked in rank order
        ((n, *shape) each), in ONE all-gather of their concatenation over
        ``group`` (the default group when None; a collective)."""
        if not tensors:
            return []
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        rows = all_gather(flat[None], group)
        out, offset = [], 0
        for t in tensors:
            out.append(rows[:, offset:offset + t.numel()]
                       .reshape(rows.shape[0], *t.shape).to(t.dtype))
            offset += t.numel()
        return out

    def _snapshot(self, state: TrainState, epoch: int,
                  step_in_epoch: int) -> dict:
        """Host copies of what a checkpoint holds (the residual rows of
        every rank, and the sharded update's chunks, gathered: a
        collective); only rank 0 copies the replicated state, which only
        it writes."""
        model, sh, tp = state.model, state.sharding, state.tp
        if (state.fsdp is not None or (tp is not None and sh is None)
                or (tp is not None and sh.mode == "zero1")):
            return self._snapshot_tp(state, epoch, step_in_epoch)
        ef = state.grad_sync.get("ef")
        ef_keys = sorted(ef) if isinstance(ef, dict) else []
        ef_list = ([ef[k] for k in ef_keys] if isinstance(ef, dict)
                   else [ef] if ef is not None else [])
        named = flax_ordered(model.named_parameters())
        opt = state.optimizer.state_dict()
        # the sharded update's chunks: FSDP's parameters, every optimizer
        # tensor of a chunk (not the 0-d step counts)
        chunked = []
        if sh is not None:
            if sh.mode == "fsdp":
                chunked += [p for _, p in named]
            chunked += [t for slots in opt["state"].values()
                        for t in slots.values()
                        if isinstance(t, torch.Tensor) and t.dim() >= 1]
        gathered = self._gather_rows(ef_list + chunked)
        ef_rows, chunk_rows = gathered[:len(ef_list)], gathered[len(ef_list):]
        if self._rank != 0:
            return {}
        if sh is not None:
            order = self._chunk_order(state)
            # global arrays: the chunks in chunk order (model-major under
            # tensor parallelism)
            chunk_rows = [r[order].reshape(-1) for r in chunk_rows]
            if tp is not None:
                ef_rows = [r[order] for r in ef_rows]
            it = iter(chunk_rows)
            params = OrderedDict(
                (name, next(it) if sh.mode == "fsdp" else p)
                for name, p in named)
            opt = {"state": {idx: {k: (next(it) if isinstance(
                       t, torch.Tensor) and t.dim() >= 1 else t)
                       for k, t in slots.items()}
                       for idx, slots in opt["state"].items()},
                   "param_groups": opt["param_groups"]}
            shapes = dict(zip(sh.names, (list(s) for s in (
                tp.shapes if tp is not None else sh.shapes))))
        else:
            params = OrderedDict(named)
            shapes = {name: list(p.shape) for name, p in named}
        if isinstance(ef, dict):
            grad_sync = {"ef": dict(zip(ef_keys, ef_rows))}
        else:
            grad_sync = {"ef": ef_rows[0]} if ef_rows else None
        return self._finish_snapshot(state, epoch, step_in_epoch, params,
                                     opt, grad_sync, shapes)

    def _finish_snapshot(self, state: TrainState, epoch: int,
                         step_in_epoch: int, params, opt, grad_sync,
                         shapes: dict) -> dict:
        snapshot = _to_host({
            "params": params,
            "batch_stats": OrderedDict(state.batch_stats),
            "opt_state": opt,
            **({"grad_sync": grad_sync} if grad_sync else {}),
        })
        device = next(state.model.parameters()).device
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the non-blocking copies
        snapshot["meta"] = {
            "step": int(state.step), "epoch": int(epoch),
            "step_in_epoch": int(step_in_epoch),
            "optimizer": type(state.optimizer).__name__,
            "layout": self._layout(state),
            "param_shapes": shapes,
            **{f"{a}_shards": self._shards(state, a) for a in SPLIT_AXES},
        }
        return snapshot

    @staticmethod
    def _shards(state: TrainState, axis: str) -> int:
        """The ways the state's model splits over the mesh axis ``axis``
        (``model``, ``pipe`` or ``expert``)."""
        tp = state.tp
        return tp.axis.size if tp is not None and tp.axis_name == axis \
            else 1

    @staticmethod
    def _chunk_order(state: TrainState) -> List[int]:
        """The ranks in the global array's chunk order: chunk order over
        the batch ranks, model shard after model shard under tensor
        parallelism (the default group's ranks)."""
        sh, tp = state.sharding, state.tp
        chunks = sorted(range(sh.n_shards), key=sh.owners.__getitem__)
        if tp is None:
            return chunks
        return [ranks[b] for ranks in tp.ranks for b in chunks]

    @staticmethod
    def _leaf_dims(state: TrainState) -> List[Tuple[Optional[int],
                                                   Optional[int]]]:
        """(split dim over the model's split axis, dim over fsdp) of
        every parameter, flax order."""
        n = len(list(state.model.parameters()))
        tp = state.tp.split_dims if state.tp is not None else (None,) * n
        fsdp = state.fsdp.dims if state.fsdp is not None else (None,) * n
        return list(zip(tp, fsdp))

    def _opt_dims(self, state: TrainState
                  ) -> Dict[int, Tuple[Optional[int], Optional[int]]]:
        """{optimizer state index: its parameter's `_leaf_dims`}."""
        by_id = {id(p): d for (_, p), d in zip(
            flax_ordered(state.model.named_parameters()),
            self._leaf_dims(state))}
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        return {i: by_id[id(p)] for i, p in enumerate(params)}

    @staticmethod
    def _globalize(state: TrainState, items) -> List[torch.Tensor]:
        """The global arrays of local tensors ``items`` ((tensor, split
        dim, fsdp dim) each): the fsdp slices joined over the fsdp ranks,
        then the split slices over the split axis (one all-gather each,
        on every rank: collectives)."""
        out = [t for t, _, _ in items]
        for layout, k in ((state.fsdp, 2), (state.tp, 1)):
            if layout is None:
                continue
            idx = [i for i, it in enumerate(items) if it[k] is not None]
            rows = CheckpointManager._gather_rows([out[i] for i in idx],
                                                  layout.axis.group)
            for i, r in zip(idx, rows):
                out[i] = tp_join(r.unbind(0), items[i][k])
        return out

    @staticmethod
    def _localize(state: TrainState, t: torch.Tensor, dims) -> torch.Tensor:
        """This rank's part of a global array (the inverse of
        `_globalize`): its split slice, then its fsdp slice."""
        tp_dim, fsdp_dim = dims
        if state.tp is not None:
            t = tp_slice(t, tp_dim, state.tp.axis.size, state.tp.axis.index)
        if state.fsdp is not None:
            ax = state.fsdp.axis
            t = fsdp_slice(t, fsdp_dim, ax.size, ax.index)
        return t

    def _snapshot_tp(self, state: TrainState, epoch: int,
                     step_in_epoch: int) -> dict:
        """`_snapshot` of the implicit path on a split model, the fsdp
        axis, or ZeRO-1 on a model mesh: every parameter and moment
        joined into its global array (collectives), written by rank 0.
        ZeRO-1's moments are this rank's chunks of the TP-local leaves'
        flat-padded vectors: gathered over the batch ranks first, and
        written as JAX's layout, each global leaf flat-padded over
        them."""
        sh = state.sharding
        named = flax_ordered(state.model.named_parameters())
        opt = state.optimizer.state_dict()
        # new slot dicts: state_dict() shares the live ones
        opt["state"] = {idx: dict(slots)
                        for idx, slots in opt["state"].items()}
        leaf_dims = self._leaf_dims(state)
        if sh is not None:
            # ZeRO-1 x TP: the optimizer updates the chunks, flax order
            opt_dims = dict(enumerate(leaf_dims))
            local_shapes = dict(enumerate(sh.shapes))
        else:
            opt_dims = self._opt_dims(state)
        moments = [(idx, k, t) for idx, slots in opt["state"].items()
                   for k, t in slots.items()
                   if isinstance(t, torch.Tensor) and t.dim() >= 1]
        tensors = [t for _, _, t in moments]
        if sh is not None:
            rows = self._gather_rows(tensors, sh.group)
            tensors = [unflatten_padded(r.reshape(-1), local_shapes[idx])
                       for r, (idx, _, _) in zip(rows, moments)]
        full = self._globalize(
            state, [(p, *d) for (_, p), d in zip(named, leaf_dims)]
            + [(t, *opt_dims[idx]) for t, (idx, _, _) in zip(tensors,
                                                              moments)])
        if self._rank != 0:
            return {}
        params = OrderedDict((name, t) for (name, _), t in zip(named, full))
        for (idx, k, _), t in zip(moments, full[len(named):]):
            opt["state"][idx][k] = (flatten_pad(t, sh.n_shards)
                                    if sh is not None else t)
        shapes = dict(zip(state.tp.names if state.tp is not None
                          else state.fsdp.names,
                          (list(t.shape) for t in full[:len(named)])))
        return self._finish_snapshot(state, epoch, step_in_epoch, params,
                                     opt, None, shapes)

    def save(self, label: int, state: TrainState, wait: bool = False,
             epoch: Optional[int] = None, step_in_epoch: int = 0,
             world_size: Optional[int] = None) -> None:
        """Snapshot ``state`` now and write it on the background writer;
        ``wait=True`` also waits for the write, as ``wait()`` does.
        ``epoch`` defaults to ``label``; ``world_size`` (the ranks the
        state is laid out for) goes into the manifest. Joins, and raises
        the failure of, the previous write first. Re-saving a label
        replaces it."""
        t0 = time.perf_counter()
        self._join_agreed()
        self._known_bad.pop(label, None)
        t_snap = time.perf_counter()
        snapshot = self._snapshot(state, label if epoch is None else epoch,
                                  step_in_epoch)
        self.snapshot_ms += (time.perf_counter() - t_snap) * 1e3
        self.saves_started += 1
        if self._rank == 0:
            meta = snapshot.pop("meta")
            meta["world_size"] = (None if world_size is None
                                  else int(world_size))
            if self._mesh is not None:
                meta["mesh"] = self._mesh
            if label in self.all_steps():
                # never mix a fresh save into a stale (maybe torn) one
                shutil.rmtree(self._step_dir(label))
                self._manifest_path(label).unlink(missing_ok=True)
            pending = self._pending_path(label)
            pending.parent.mkdir(parents=True, exist_ok=True)
            pending.write_text(json.dumps({"label": label,
                                           "step": meta["step"]}))
            self._writer = threading.Thread(
                target=self._writer_main, args=(label, snapshot, meta),
                name=f"ckpt-writer-{label}", daemon=True)
            self._writer.start()
        if wait:
            self._join_agreed()
        blocked_s = time.perf_counter() - t0
        self.save_blocked_ms += blocked_s * 1e3
        # the save_blocked telemetry span: exactly the caller-thread stall
        # this save cost the train loop
        telemetry.span_event("save_blocked", blocked_s, label=label,
                             phase="save", async_save=not wait)

    def wait(self) -> None:
        """Barrier: join the writer and raise a failed write (a shutdown
        must not drop a lost save silently)."""
        t0 = time.perf_counter()
        try:
            self._join_agreed()
        finally:
            blocked_s = time.perf_counter() - t0
            self.save_blocked_ms += blocked_s * 1e3
            telemetry.span_event("save_blocked", blocked_s, phase="wait")

    def close(self) -> None:
        self._join_logged()

    # -- restore --------------------------------------------------------------

    def checkpoint_world_size(self, label: Optional[int]) -> Optional[int]:
        """The world size checkpoint ``label`` was saved for, from its
        manifest (None when not recorded)."""
        if label is None:
            return None
        manifest = self.manifest(label)
        w = (manifest or {}).get("world_size")
        return int(w) if w is not None else None

    def _verified_labels(self, among=None):
        """Candidate labels, newest first, that pass verification; joins
        the writer (then, on several ranks, a barrier), records
        ``last_skipped`` and logs every torn skip."""
        self._join_logged()
        if self._world > 1:
            dist.barrier()
        self.last_skipped = []
        labels = sorted((label for label in self.all_steps()
                         if among is None or label in among), reverse=True)
        for label in labels:
            problem = self.verify(label)
            if problem is not None:
                log_main(f"CHECKPOINT INTEGRITY: checkpoint {label} is "
                         f"torn ({problem}) — skipping it and trying the "
                         "previous one")
                telemetry.emit("event", "torn_checkpoint_skipped",
                               label=label, problem=problem)
                self.last_skipped.append(label)
                continue
            yield label

    def restore_latest(self, template: TrainState, among=None,
                       template_world_size: Optional[int] = None
                       ) -> Optional[Tuple[TrainState, int, int]]:
        """``(state, epoch, step_in_epoch)`` from the newest checkpoint
        that passes verification (written into ``template``, a fresh
        state of the same model and optimizer), or None when there is
        none. ``among`` restricts the candidates (the supervisor of a run
        without ``--resume`` passes the labels it wrote). A checkpoint
        carrying residual rows restored into a template that carries a
        residual, at another world size than it was written at, raises
        :class:`CheckpointWorldSizeMismatch`; so does one whose manifest
        records another world than ``template_world_size``."""
        for label in self._verified_labels(among):
            return self._restore(label, template, template_world_size)
        if self.last_skipped:
            log_main(f"CHECKPOINT INTEGRITY: every checkpoint "
                     f"({self.last_skipped}) failed verification — "
                     "nothing to restore")
        return None

    def _load(self, label: int, key: str):
        return torch.load(self._step_dir(label) / f"{key}.pt",
                          map_location="cpu", weights_only=True)

    def _mismatch(self, label: int, saved: int, here: int):
        err = CheckpointWorldSizeMismatch(
            f"checkpoint {label} was written at world size {saved}, but "
            f"this run has {here} ranks: its error-feedback residuals and "
            "flat-padded layouts hold one row or chunk per rank. Resume at "
            f"world size {saved} (resharding comes with the elastic slice)")
        err.label, err.world_size = label, saved
        return err

    def _restore(self, label: int, template: TrainState,
                 template_world_size: Optional[int]
                 ) -> Tuple[TrainState, int, int]:
        with telemetry.span("restore", label=label):
            return self._restore_inner(label, template, template_world_size)

    @torch.no_grad()
    def _restore_inner(self, label: int, template: TrainState,
                       template_world_size: Optional[int]
                       ) -> Tuple[TrainState, int, int]:
        meta = json.loads((self._step_dir(label) / _META).read_text())
        has_ef = (self._step_dir(label) / "grad_sync.pt").exists()
        recorded = meta.get("world_size")
        layout = meta.get("layout", "replicated")
        want = self._layout(template)
        if layout != want:
            raise ValueError(
                f"checkpoint {label} holds the {layout} update's layout, "
                f"but the restore template is {want}: {LAYOUT_HINT}")
        sh, tp = template.sharding, template.tp
        model_n = tp.axis.size if tp is not None else 1
        for axis in SPLIT_AXES:
            saved, here = (meta.get(f"{axis}_shards", 1),
                           self._shards(template, axis))
            if saved != here:
                raise ValueError(
                    f"checkpoint {label} holds a model split {saved} ways "
                    f"over {axis}, but this run's mesh has {axis}={here}: "
                    f"{LAYOUT_HINT}")
        if ((has_ef or sh is not None)
                and template_world_size is not None
                and recorded is not None
                and recorded != template_world_size):
            raise self._mismatch(label, recorded, template_world_size)
        if sh is not None and recorded is not None \
                and recorded != self._world:
            raise self._mismatch(label, recorded, self._world)
        want_opt = type(template.optimizer).__name__
        if meta["optimizer"] != want_opt:
            raise ValueError(
                f"checkpoint {label} holds {meta['optimizer']} state, but "
                f"the restore template's optimizer is {want_opt}: pass the "
                "training run's --optimizer")
        ef = None
        if has_ef and "ef" in template.grad_sync:
            rows = self._load(label, "grad_sync")["ef"]
            first = next(iter(rows.values())) if isinstance(rows, dict) \
                else rows
            if first.shape[0] != self._world:
                raise self._mismatch(label, first.shape[0], self._world)
            mine = (self._chunk_order(template).index(self._rank)
                    if sh is not None and tp is not None else self._rank)
            ef = ({k: r[mine] for k, r in rows.items()}
                  if isinstance(rows, dict) else rows[mine])
        params = self._load(label, "params")
        own = dict(template.model.named_parameters())
        shapes = ({n: list(s) for n, s in zip(tp.names, tp.shapes)}
                  if tp is not None else
                  {n: list(s) for n, s in zip(template.fsdp.names,
                                              template.fsdp.shapes)}
                  if template.fsdp is not None else
                  {n: list(s) for n, s in zip(sh.names, sh.shapes)}
                  if sh is not None else
                  {n: list(p.shape) for n, p in own.items()})
        if set(params) != set(own) or meta["param_shapes"] != shapes:
            raise ValueError(
                f"checkpoint {label}'s parameters do not match the restore "
                "template's model: resume with the training run's --model "
                "and --model-overrides")

        def chunk(t):
            # this rank's chunk of a global flat array (model-major under
            # tensor parallelism)
            m = tp.axis.index if tp is not None else 0
            return t.reshape(model_n * sh.n_shards, -1)[
                m * sh.n_shards + sh.owner]

        leaf_dims = dict(zip(
            (n for n, _ in flax_ordered(own.items())),
            self._leaf_dims(template)))
        for name, p in own.items():
            p.copy_(chunk(params[name]) if layout == "fsdp"
                    else self._localize(template, params[name],
                                        leaf_dims[name]))
        template.set_batch_stats(self._load(label, "batch_stats"))
        opt = self._load(label, "opt_state")
        if sh is not None and tp is not None and sh.mode == "zero1":
            # ZeRO-1 x TP: JAX's global flat leaves -> this rank's chunk
            # of its TP-local leaf's flat-padded vector
            gshapes = dict(enumerate(tp.shapes))
            dims_of = dict(enumerate(self._leaf_dims(template)))
            opt["state"] = {idx: {k: (chunk_of(self._localize(
                template, unflatten_padded(t, gshapes[idx]), dims_of[idx]),
                sh.n_shards, sh.owner) if isinstance(
                t, torch.Tensor) and t.dim() >= 1 else t)
                for k, t in slots.items()}
                for idx, slots in opt["state"].items()}
        elif sh is not None:
            opt["state"] = {idx: {k: (chunk(t) if isinstance(
                t, torch.Tensor) and t.dim() >= 1 else t)
                for k, t in slots.items()}
                for idx, slots in opt["state"].items()}
        elif tp is not None or template.fsdp is not None:
            opt_dims = self._opt_dims(template)
            opt["state"] = {idx: {k: (
                self._localize(template, t, opt_dims[idx])
                if isinstance(t, torch.Tensor) and t.dim() >= 1 else t)
                for k, t in slots.items()}
                for idx, slots in opt["state"].items()}
        template.optimizer.load_state_dict(opt)
        if ef is not None:
            old = template.grad_sync["ef"]
            template.grad_sync = {"ef": (
                {k: r.to(old[k].device) for k, r in ef.items()}
                if isinstance(ef, dict) else ef.to(old.device))}
        if sh is not None and sh.shards is not None:
            # ZeRO-1's chunk tensors follow the restored parameters
            for t, (_, p) in zip(sh.shards, flax_ordered(
                    template.model.named_parameters())):
                t.copy_(chunk_of(p, sh.n_shards, sh.owner) if tp is not None
                        else chunk(flatten_pad(p, sh.n_shards)))
        template.step = int(meta["step"])
        self.last_restored = label
        return template, int(meta["epoch"]), int(meta["step_in_epoch"])

    def restore_params(self, model: torch.nn.Module,
                       layout: str = "replicated",
                       optimizer: Optional[str] = None) -> Optional[dict]:
        """Serving's restore: the newest checkpoint that passes
        verification, parameters and BatchNorm statistics only, written
        into ``model`` (an FSDP checkpoint's flat-padded parameters
        unflattened to the model's shapes, model-major under tensor
        parallelism: ``tp_unflatten_leaf`` along the model's split
        dims). ``layout`` is the update the
        training run used (the serving CLI's ``--zero1`` /
        ``--fsdp-explicit``); another layout raises, as does another
        ``optimizer`` class than the run's, when given. Returns the
        restored ``meta.json``, or None."""
        for label in self._verified_labels():
            meta = json.loads((self._step_dir(label) / _META).read_text())
            if optimizer is not None and meta["optimizer"] != optimizer:
                raise ValueError(
                    f"checkpoint {label} holds {meta['optimizer']} state, "
                    f"but the restore template's optimizer is {optimizer}: "
                    "pass the training run's --optimizer")
            saved = meta.get("layout", "replicated")
            if saved != layout:
                raise ValueError(
                    f"checkpoint {label} holds the {saved} update's "
                    f"layout, but the serving template is {layout}: pass "
                    "the same --zero1/--fsdp-explicit flags as the "
                    "training run")
            params = self._load(label, "params")
            own = dict(model.named_parameters())
            if set(params) != set(own) or meta["param_shapes"] != {
                    n: list(p.shape) for n, p in own.items()}:
                raise ValueError(
                    f"checkpoint {label}'s parameters do not match the "
                    "serving model: pass the training run's --model and "
                    "--model-overrides")
            model_n = meta.get("model_shards", 1)
            dims = (tp_split_dims([(n, tuple(p.shape)) for n, p in
                                   own.items()],
                                  type(model).partition_rules(), model_n)
                    if model_n > 1 else {})
            with torch.no_grad():
                for name, p in own.items():
                    p.copy_(tp_unflatten_leaf(params[name], p.shape,
                                              dims[name], model_n)
                            if layout == "fsdp" and model_n > 1 else
                            unflatten_padded(params[name], p.shape))
                for name, b in self._load(label, "batch_stats").items():
                    dict(model.named_buffers())[name].copy_(b)
            self.last_restored = label
            return meta
        return None

    def manifest(self, label: int) -> Optional[dict]:
        """The integrity manifest of one checkpoint (``tree_digest``, per
        file size and sha256, the coordinates), or None without one."""
        self._join_logged()
        path = self._manifest_path(label)
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text())
        except Exception:
            return None

    def metadata(self, label: Optional[int] = None) -> Optional[dict]:
        """One checkpoint's ``meta.json`` (default: the newest): step,
        coordinates, optimizer class and parameter shapes, without reading
        any tensor."""
        self._join_logged()
        if label is None:
            steps = self.all_steps()
            label = steps[-1] if steps else None
        if label is None:
            return None
        try:
            return json.loads((self._step_dir(label) / _META).read_text())
        except Exception:
            return None

    def latest_metadata(self) -> Optional[dict]:
        return self.metadata()


def global_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """{name: the global array} of every parameter of a state on the
    implicit path or ZeRO-1 (a split model's slices and the fsdp axis's
    joined, as a checkpoint holds them): a collective, on every rank."""
    named = flax_ordered(state.model.named_parameters())
    full = CheckpointManager._globalize(
        state, [(p.detach(), *d) for (_, p), d in zip(
            named, CheckpointManager._leaf_dims(state))])
    return OrderedDict((name, t) for (name, _), t in zip(named, full))
