"""The inference engine over one (model, config, device), in the JAX
package's three serve modes:

* a causal LM (a model with ``init_cache``, GPT-2): bucket -> pack ->
  prefill -> greedy KV-cache decode -> unpack (``serve_tokens``);
* a token batch (a model with ``vocab_size`` and no cache, BERT): one
  bucketed forward, the per-position logits and the last real position's
  row, no tokens (``serve_tokens``). As in the JAX engine no attention
  mask is passed, so the padded positions are attended to;
* an image batch (ResNet, ViT): normalize, one forward in eval mode,
  the logits of the real rows (``serve_images``). A ResNet's BatchNorm
  runs on the running statistics the engine was given (``batch_stats``,
  the model's buffers by name), never on the template's buffers or the
  batch's own statistics.

* **Shapes** come from the bucket ladder (``data/pack.py``): every request
  is padded to the smallest rung that fits, in a batch of ``rows`` rows.
* **Numerics** are the eval forward's. Prefill runs the causal forward
  over the padded prompt and fills the KV cache as a side output; each
  decode step writes one new k/v row at every row's own position.
* **int8 weights** use the gradient-wire codec grid (one max-abs scale per
  trailing-axis row of the flax layout, ``max(amax, 1e-30) * (1/127)``,
  round-half-even, clip), through the hand-written quantizer kernel on the
  GPU. As in the JAX package, the weights are dequantized to fp32 inside
  every prefill and decode call (``q.float() * scale``): at-rest bytes drop
  about 4x, and each step materialises the fp32 weights once more.

The decode loop (``generate``) fetches nothing to the host: tokens and
positions stay on the device, and the one fetch happens after the last
step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from .. import telemetry
from ..data.pack import bucket_for, pack_token_rows, unpack_token_rows
from ..parallel.grad_sync import _quantize_int8_rows
from ..runtime import DeviceLike, resolve_device
from .batching import Result

SERVE_DTYPES = ("fp32", "bf16", "int8")


@dataclasses.dataclass
class ServeConfig:
    """Engine knobs (serving/__main__.py mirrors them)."""

    # Prompt-length bucket ladder (sorted ascending); a request pays
    # padding at most to the next rung.
    buckets: Tuple[int, ...] = (32, 64, 128)
    # Batch rows per engine cycle.
    rows: int = 8
    # Greedy-decode budget per request; the KV cache is sized
    # bucket + max_new_tokens.
    max_new_tokens: int = 16
    # fp32; bf16, the model's compute dtype (build the model with
    # dtype=bf16, the --amp convention; the weights stay float32); or int8
    # weights at rest dequantized at every call.
    serve_dtype: str = "fp32"
    pad_id: int = 0
    # int8: only quantize leaves with >= this many elements (biases and
    # layernorms are all error and no memory win).
    quantize_min_elements: int = 4096

    def __post_init__(self):
        if self.serve_dtype not in SERVE_DTYPES:
            raise ValueError(f"serve_dtype {self.serve_dtype!r} is not one "
                             f"of {SERVE_DTYPES}")
        if not self.buckets:
            raise ValueError("at least one bucket is required")
        self.buckets = tuple(sorted(int(b) for b in self.buckets))
        if self.rows < 1:
            raise ValueError(f"rows must be >= 1, got {self.rows}")


@dataclasses.dataclass
class QuantizedLeaf:
    """An int8-at-rest parameter: int8 codes in the original shape plus one
    fp32 scale per trailing-axis row."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_params(params: Mapping[str, torch.Tensor],
                    min_elements: int = 4096) -> Dict[str, Any]:
    """int8-quantize the weights for serving: every parameter with ndim >= 2
    and >= ``min_elements`` elements becomes a `QuantizedLeaf` (per-row
    scales over the trailing axis, leading axes collapsed: embeddings get
    one scale per vocab row, kernels one per input row); everything else
    stays exact fp32."""
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if leaf.dim() < 2 or leaf.numel() < min_elements:
            out[name] = leaf
            continue
        rows = leaf.float().reshape(-1, leaf.shape[-1]).contiguous()
        q, scales = _quantize_int8_rows(rows)
        out[name] = QuantizedLeaf(q=q.reshape(leaf.shape),
                                  scale=scales.reshape(leaf.shape[:-1]))
    return out


def dequantize_params(served: Mapping[str, Any],
                      like_dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """Inverse of `quantize_params`: codes x per-row scales, cast to the
    parameter dtype. Exact leaves pass through untouched."""
    return {name: ((leaf.q.float() * leaf.scale[..., None]).to(like_dtype)
                   if isinstance(leaf, QuantizedLeaf) else leaf)
            for name, leaf in served.items()}


def int8_weight_bytes(served: Mapping[str, Any]) -> Dict[str, int]:
    """At-rest byte accounting of a served parameter set."""
    quantized = exact = 0
    for leaf in served.values():
        if isinstance(leaf, QuantizedLeaf):
            quantized += leaf.q.numel() + 4 * leaf.scale.numel()
        else:
            exact += leaf.numel() * leaf.element_size()
    return {"quantized_bytes": int(quantized), "exact_bytes": int(exact)}


def stats_kwargs(model) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"batch_stats": the model's buffers}`` for a model with running
    statistics (a ResNet's BatchNorms), ``{}`` otherwise: the keyword an
    engine is built with from a model's own state."""
    stats = {name: b.detach() for name, b in model.named_buffers()}
    return {"batch_stats": stats} if stats else {}


class InferenceEngine:
    """Batched inference of a causal LM, a token model or an image model
    on one device.

    ``params`` maps the model's parameter names to tensors; the engine
    copies them to ``device`` (int8: quantizes them there) and runs the
    model through ``torch.func.functional_call`` with them, so the
    module's own parameters are only its template. ``batch_stats`` maps
    buffer names to the running statistics to serve (a ResNet's; a model
    with buffers needs them). ``device=None`` means CUDA and raises
    without it."""

    def __init__(self, model, config: ServeConfig,
                 params: Mapping[str, torch.Tensor],
                 device: DeviceLike = None,
                 batch_stats: Optional[Mapping[str, torch.Tensor]] = None):
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        # three serve modes, as in the JAX engine: causal LM (prefill +
        # KV-cache decode), token batch (BERT: one bucketed forward),
        # image batch (ResNet, ViT: serve_images)
        self.is_lm = hasattr(model, "init_cache")
        self.is_token = hasattr(model, "vocab_size")
        top = max(config.buckets) + config.max_new_tokens
        if self.is_lm and top > model.max_position:
            raise ValueError(
                f"largest bucket + max_new_tokens = {top} exceeds the "
                f"model's max_position {model.max_position}")
        buffers = [name for name, _ in model.named_buffers()]
        if buffers and batch_stats is None:
            raise ValueError(
                f"{type(model).__name__} normalizes with running statistics"
                f" ({len(buffers)} buffers): pass batch_stats, the ones to "
                "serve")
        # what a checkpoint-built engine serves (from_checkpoint); None
        # for weights handed in directly
        self.checkpoint_info: Optional[dict] = None
        on_device = {name: p.detach().to(self.device)
                     for name, p in params.items()}
        self._batch_stats = {name: b.detach().to(self.device, copy=True)
                             for name, b in (batch_stats or {}).items()}
        self._param_dtype = next(iter(on_device.values())).dtype
        if config.serve_dtype == "int8":
            self._served = quantize_params(
                on_device, min_elements=config.quantize_min_elements)
        else:
            self._served = on_device

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, model, config: ServeConfig,
                        device: DeviceLike = None,
                        layout: str = "replicated",
                        optimizer: Optional[str] = None
                        ) -> "InferenceEngine":
        """Restore the newest manifest-verified checkpoint's parameters
        into ``model`` and build an engine serving them. ``layout`` is the
        training run's update (``replicated``, ``zero1`` or ``fsdp``); an
        FSDP checkpoint's flat-padded parameters are unflattened to the
        model's shapes, as the JAX engine unflattens them through the
        trainer's template; a ResNet's BatchNorm statistics come from the
        checkpoint too. ``optimizer`` (the class name) must be the
        training run's, when given. Torn checkpoints are skipped as a training
        resume skips them. ``checkpoint_info`` names what is served: the
        directory, the label, the step and the manifest's
        ``tree_digest``."""
        from ..training.checkpoint import CheckpointManager

        ckpt = CheckpointManager(ckpt_dir)
        try:
            meta = ckpt.restore_params(model, layout, optimizer)
            if meta is None:
                raise FileNotFoundError(
                    f"no restorable checkpoint under {ckpt_dir} "
                    f"(skipped as torn: {ckpt.last_skipped or 'none'})")
            label = ckpt.last_restored
            manifest = ckpt.manifest(label)
            engine = cls(model, config,
                         {name: p.detach()
                          for name, p in model.named_parameters()},
                         device=device, **stats_kwargs(model))
            engine.checkpoint_info = {
                "dir": str(ckpt_dir),
                "label": label,
                "step": int(meta["step"]),
                "tree_digest": (manifest or {}).get("tree_digest"),
                "verified": manifest is not None,
            }
            return engine
        finally:
            ckpt.close()

    # -- steps ----------------------------------------------------------------

    def _params(self) -> Dict[str, torch.Tensor]:
        """The served parameters (dequantized) and the statistics, by
        name: what ``functional_call`` runs the model with."""
        return {**dequantize_params(self._served,
                                    like_dtype=self._param_dtype),
                **self._batch_stats}

    def _prefill(self, bucket: int, ids: torch.Tensor,
                 lengths: torch.Tensor):
        rows, cache_len = self.config.rows, bucket + self.config.max_new_tokens
        cache0 = self.model.init_cache(rows, cache_len, device=self.device)
        logits, cache = functional_call(self.model, self._params(), (ids,),
                                        {"cache": cache0})
        # greedy first token from the last REAL prompt position; filler
        # rows (length 0) read row 0 — their outputs are never unpacked
        last_pos = torch.clamp(lengths - 1, min=0)
        last = logits[torch.arange(rows, device=self.device), last_pos]
        tok = torch.argmax(last, dim=-1)
        return logits, last, cache, tok, lengths

    def _forward(self, ids: torch.Tensor, lengths: torch.Tensor):
        """A token model's bucketed forward: the per-position logits and
        the row at each row's last real position (filler rows read row
        0)."""
        logits = functional_call(self.model, self._params(), (ids,))
        last_pos = torch.clamp(lengths - 1, min=0)
        return logits, logits[torch.arange(ids.shape[0],
                                           device=self.device), last_pos]

    def _decode(self, cache, tok: torch.Tensor, positions: torch.Tensor):
        logits, new_cache = functional_call(
            self.model, self._params(), (tok[:, None],),
            {"cache": cache, "cache_positions": positions})
        nxt = torch.argmax(logits[:, 0], dim=-1)
        return new_cache, nxt, positions + 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> int:
        """Run every bucket's steps once on pad prompts (a prefill and a
        decode step for a causal LM, the forward for a token model), so
        CUDA's first-call costs stay out of the first request; returns
        the number of forwards run. Image models are served cold, as the
        JAX engine compiles them lazily."""
        if not self.is_token:
            return 0
        rows, runs = self.config.rows, 0
        with torch.inference_mode():
            for b in self.config.buckets:
                ids = torch.full((rows, b), self.config.pad_id,
                                 dtype=torch.long, device=self.device)
                lengths = torch.full((rows,), b, dtype=torch.long,
                                     device=self.device)
                if self.is_lm:
                    _, _, cache, tok, pos = self._prefill(b, ids, lengths)
                    self._decode(cache, tok, pos)
                    runs += 2
                else:
                    self._forward(ids, lengths)
                    runs += 1
            self._sync()
        return runs

    # -- serving --------------------------------------------------------------

    def serve_tokens(self, seqs: Sequence[np.ndarray],
                     max_new_tokens: Optional[int] = None,
                     return_prompt_logits: bool = False) -> List[Result]:
        """Serve one ragged group of token prompts: bucket, pack, prefill,
        greedy-decode, unpack; for a token model that is not an LM, one
        forward and no tokens. All prompts must fit ONE bucket (the
        batching layer groups by bucket before calling)."""
        if not seqs:
            return []
        if not self.is_token:
            raise ValueError(
                "serve_tokens needs a token model (gpt2/bert); image "
                "models serve through serve_images")
        cfg = self.config
        bucket = max(bucket_for(len(s), cfg.buckets) for s in seqs)
        ids, lengths, _w = pack_token_rows(seqs, bucket, cfg.rows,
                                           pad_id=cfg.pad_id)
        if not self.is_lm:
            return self._serve_forward(seqs, bucket, ids, lengths,
                                       return_prompt_logits)
        new_tokens = (cfg.max_new_tokens if max_new_tokens is None
                      else min(int(max_new_tokens), cfg.max_new_tokens))
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(self.device, torch.long)
            len_t = torch.from_numpy(lengths).to(self.device, torch.long)
            t0 = time.perf_counter()
            logits, last, cache, tok, positions = self._prefill(
                bucket, ids_t, len_t)
            self._sync()  # prefill_s is the device's time, not enqueue
            prefill_s = time.perf_counter() - t0
            telemetry.span_event("prefill", prefill_s, bucket=bucket,
                                 rows=len(seqs))
            t0 = time.perf_counter()
            toks, cache = self.generate(cache, tok, positions, new_tokens)
            # ONE host fetch for the whole batch, after the last decode step
            toks_h = toks.to(torch.int32).cpu().numpy()
            last_h = last.cpu().numpy()
            logits_h = logits.cpu().numpy() if return_prompt_logits else None
            decode_s = time.perf_counter() - t0
            telemetry.span_event("decode", decode_s, bucket=bucket,
                                 steps=max(new_tokens - 1, 0),
                                 rows=len(seqs))
        per_req = (unpack_token_rows(logits_h, lengths, len(seqs))
                   if return_prompt_logits else [None] * len(seqs))
        return [Result(tokens=toks_h[i, :new_tokens],
                       last_logits=last_h[i],
                       prompt_logits=per_req[i],
                       bucket=bucket, prefill_s=prefill_s,
                       decode_s=decode_s)
                for i in range(len(seqs))]

    def _serve_forward(self, seqs, bucket: int, ids: np.ndarray,
                       lengths: np.ndarray,
                       return_prompt_logits: bool) -> List[Result]:
        """A token model's serve: one forward, the last real position's
        logits a request (its per-position logits only when asked for),
        an empty token array, one ``prefill`` span."""
        with torch.inference_mode():
            ids_t = torch.from_numpy(ids).to(self.device, torch.long)
            len_t = torch.from_numpy(lengths).to(self.device, torch.long)
            t0 = time.perf_counter()
            logits, last = self._forward(ids_t, len_t)
            # the (rows, bucket, vocab) logits cross to the host only when
            # asked for
            last_h = last.cpu().numpy()
            logits_h = logits.cpu().numpy() if return_prompt_logits else None
            prefill_s = time.perf_counter() - t0
        telemetry.span_event("prefill", prefill_s, bucket=bucket,
                             rows=len(seqs))
        per_req = (unpack_token_rows(logits_h, lengths, len(seqs))
                   if return_prompt_logits else [None] * len(seqs))
        return [Result(tokens=np.zeros((0,), np.int32),
                       last_logits=last_h[i], prompt_logits=per_req[i],
                       bucket=bucket, prefill_s=prefill_s)
                for i in range(len(seqs))]

    def serve_images(self, images: np.ndarray, mean: Sequence[float],
                     std: Sequence[float]) -> np.ndarray:
        """Batched image classification: zero-pad the (n, H, W, C) uint8
        batch to ``rows``, normalize as the eval task does
        (``data/augment.normalize_images``, in the model's dtype), one
        forward in eval mode; the (n, classes) float32 logits of the real
        rows. One ``prefill`` span."""
        from ..data.augment import normalize_images

        if self.is_token:
            raise ValueError(
                "serve_images needs an image model (resnet/vit); token "
                "models serve through serve_tokens")
        n, rows = images.shape[0], self.config.rows
        if n > rows:
            raise ValueError(f"{n} images exceed rows={rows}")
        padded = np.zeros((rows,) + images.shape[1:], images.dtype)
        padded[:n] = images
        with torch.inference_mode():
            t0 = time.perf_counter()
            x = normalize_images(
                torch.from_numpy(padded).to(self.device), mean, std,
                getattr(self.model, "dtype", torch.float32))
            logits = functional_call(self.model, self._params(), (x,))
            logits_h = logits.float().cpu().numpy()
            prefill_s = time.perf_counter() - t0
        telemetry.span_event("prefill", prefill_s, rows=n, image=True)
        return logits_h[:n]

    def generate(self, cache, tok: torch.Tensor, positions: torch.Tensor,
                 new_tokens: int):
        """The decode hot loop: ``new_tokens`` greedy tokens, the first from
        prefill and one more per decode step, with no host fetch inside the
        loop. Returns the (rows, new_tokens) token matrix (on the device)
        and the final cache."""
        out = []
        for k in range(new_tokens):
            out.append(tok)
            if k + 1 < new_tokens:  # K tokens need K-1 steps
                cache, tok, positions = self._decode(cache, tok, positions)
        stacked = (torch.stack(out, dim=1) if out else
                   torch.zeros((self.config.rows, 0), dtype=torch.long,
                               device=self.device))
        return stacked, cache
