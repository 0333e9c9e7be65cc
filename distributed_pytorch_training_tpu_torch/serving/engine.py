"""The inference engine: bucket -> pack -> prefill -> greedy KV-cache decode
-> unpack, over one (model, config, device).

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
from ..runtime import DeviceLike, not_ported, resolve_device
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


class InferenceEngine:
    """Batched greedy inference of a causal LM on one device.

    ``params`` maps the model's parameter names to tensors; the engine
    copies them to ``device`` (int8: quantizes them there) and runs the
    model through ``torch.func.functional_call`` with them, so the
    module's own parameters are only its template. ``device=None`` means
    CUDA and raises without it."""

    def __init__(self, model, config: ServeConfig,
                 params: Mapping[str, torch.Tensor],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        if not hasattr(model, "init_cache"):
            raise not_ported("serving a non-causal-LM model",
                             "a later serving slice")
        top = max(config.buckets) + config.max_new_tokens
        if top > model.max_position:
            raise ValueError(
                f"largest bucket + max_new_tokens = {top} exceeds the "
                f"model's max_position {model.max_position}")
        # what a checkpoint-built engine serves (from_checkpoint); None
        # for weights handed in directly
        self.checkpoint_info: Optional[dict] = None
        on_device = {name: p.detach().to(self.device)
                     for name, p in params.items()}
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
        trainer's template. ``optimizer`` (the class name) must be the
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
                         device=device)
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
        return dequantize_params(self._served, like_dtype=self._param_dtype)

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

    def _decode(self, cache, tok: torch.Tensor, positions: torch.Tensor):
        logits, new_cache = functional_call(
            self.model, self._params(), (tok[:, None],),
            {"cache": cache, "cache_positions": positions})
        nxt = torch.argmax(logits[:, 0], dim=-1)
        return new_cache, nxt, positions + 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- serving --------------------------------------------------------------

    def serve_tokens(self, seqs: Sequence[np.ndarray],
                     max_new_tokens: Optional[int] = None,
                     return_prompt_logits: bool = False) -> List[Result]:
        """Serve one ragged group of token prompts: bucket, pack, prefill,
        greedy-decode, unpack. All prompts must fit ONE bucket (the
        batching layer groups by bucket before calling)."""
        if not seqs:
            return []
        cfg = self.config
        bucket = max(bucket_for(len(s), cfg.buckets) for s in seqs)
        ids, lengths, _w = pack_token_rows(seqs, bucket, cfg.rows,
                                           pad_id=cfg.pad_id)
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
