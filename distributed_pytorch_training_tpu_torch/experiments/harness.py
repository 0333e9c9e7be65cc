"""Builders and serving rows the CLIs share (the JAX package's
experiments/harness.py).

Ported: the serving engines' factories (dense, slot and speculative) and
the two serving rows at fixed offered load, `measure_serving`
(iteration-granular) and `measure_serving_continuous` (token-granular),
without a mesh, a compile census or HLO contracts.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import DeviceLike, resolve_device


def build_serving_engine(model_name: str,
                         buckets: Sequence[int] = (16, 32), rows: int = 8,
                         max_new_tokens: int = 8, serve_dtype: str = "fp32",
                         model_overrides: Optional[dict] = None,
                         seed: int = 0, device: DeviceLike = None,
                         ckpt_dir: Optional[str] = None,
                         optimizer: str = "auto",
                         layout: str = "replicated",
                         config=None, engine_cls=None,
                         min_positions: int = 0):
    """An `InferenceEngine` for a serving config on one device. With
    ``ckpt_dir`` it serves the newest manifest-verified checkpoint there
    (``optimizer`` and ``layout``, the training run's optimizer and
    update, must match the checkpoint's; ``auto`` is adamw for the LMs
    and sgd for the vision models, as in the JAX package); without, it
    has random-init weights drawn from ``seed`` (a smoke of the serving
    path, not a served model). The weights are drawn on the CPU and then
    copied to ``device``, so one seed gives the same weights on every
    device.

    An LM's position table holds ``max(512, top bucket +
    max_new_tokens, min_positions)`` rows unless ``model_overrides`` sets
    it; a vision model is built for the JAX engine's (1, 32, 32, 3)
    sample (a ViT's position table for 32x32 images) and served with its
    BatchNorm statistics, if it has any. ``serve_dtype`` bf16 builds the
    model to compute in bf16, as in the JAX package. ``config``/
    ``engine_cls`` swap in a richer pair (`build_slot_engine` passes a
    PagedServeConfig and SlotEngine) through this one path;
    ``min_positions`` widens the position table when a paged engine's
    gathered view outgrows the top bucket + max_new."""
    from ..models import get_model
    from ..serving.engine import InferenceEngine, ServeConfig, stats_kwargs

    dev = resolve_device(device)
    cfg = config if config is not None else ServeConfig(
        buckets=tuple(buckets), rows=rows, max_new_tokens=max_new_tokens,
        serve_dtype=serve_dtype)
    lm = model_name.startswith(("gpt2", "bert"))   # JAX's is_lm_model
    kwargs = dict(model_overrides or {})
    if lm:
        need = max(max(cfg.buckets) + cfg.max_new_tokens, min_positions)
        kwargs.setdefault("max_position", max(512, need))
    elif model_name.startswith("vit"):
        # flax sizes the position table from the (1, 32, 32, 3) sample
        kwargs.setdefault("image_size", 32)
    kwargs.setdefault("dtype", torch.bfloat16 if cfg.serve_dtype == "bf16"
                      else torch.float32)
    model = get_model(model_name, **kwargs)
    cls = engine_cls if engine_cls is not None else InferenceEngine
    if ckpt_dir:
        name = optimizer if optimizer != "auto" else (
            "adamw" if lm else "sgd")
        return cls.from_checkpoint(
            ckpt_dir, model, cfg, device=dev, layout=layout,
            optimizer={"adamw": "AdamW", "sgd": "SGD"}[name])
    model.reset_parameters(torch.Generator().manual_seed(seed))
    params = {name: p.detach() for name, p in model.named_parameters()}
    return cls(model, cfg, params, device=dev, **stats_kwargs(model))


def build_slot_engine(model_name: str, buckets: Sequence[int] = (8, 16),
                      rows: int = 8, max_new_tokens: int = 8,
                      kv_dtype: str = "fp32", page_size: int = 8,
                      prefix_sharing: bool = True, n_pages: int = 0,
                      prefix_skip: bool = True, serve_dtype: str = "fp32",
                      **kw):
    """A `SlotEngine`: the token-granular sibling of
    `build_serving_engine` (same checkpoint restore and sizing; ``**kw``
    forwards model_overrides, seed, device, ckpt_dir, ...), decoding over
    a paged, optionally int8, KV pool. The position table is sized for the
    gathered view, ``pages_per_slot * page_size`` wide."""
    from ..serving.continuous import SlotEngine
    from ..serving.paged import PagedServeConfig

    cfg = PagedServeConfig(
        buckets=tuple(buckets), rows=rows, max_new_tokens=max_new_tokens,
        serve_dtype=serve_dtype, page_size=page_size, kv_dtype=kv_dtype,
        n_pages=n_pages, prefix_sharing=prefix_sharing,
        prefix_skip=prefix_skip)
    return build_serving_engine(
        model_name, config=cfg, engine_cls=SlotEngine,
        min_positions=cfg.pages_per_slot * cfg.page_size, **kw)


def build_spec_engine(model_name: str, draft_model_name: str,
                      buckets: Sequence[int] = (8, 16), rows: int = 8,
                      max_new_tokens: int = 8, page_size: int = 8,
                      prefix_sharing: bool = True, n_pages: int = 0,
                      prefix_skip: bool = True, draft_k: int = 4,
                      draft_overrides: Optional[dict] = None,
                      seed: int = 0, serve_dtype: str = "fp32", **kw):
    """A `SpeculativeEngine`: `build_slot_engine` with a draft LM riding
    along. The target goes through `build_serving_engine` (checkpoint
    restore, sizing) with an engine class that injects the draft; the
    draft is random-init fp32 from ``seed + 1`` (it changes the speed,
    never the stream: acceptance is exact match). Its position table is
    sized for the draft's view, which is K positions longer."""
    from ..models import get_model
    from ..serving.paged import PagedServeConfig
    from ..serving.speculative import SpeculativeEngine

    cfg = PagedServeConfig(
        buckets=tuple(buckets), rows=rows, max_new_tokens=max_new_tokens,
        serve_dtype=serve_dtype, page_size=page_size, kv_dtype="fp32",
        n_pages=n_pages, prefix_sharing=prefix_sharing,
        prefix_skip=prefix_skip)
    dcfg = dataclasses.replace(
        cfg, max_new_tokens=max_new_tokens + draft_k, n_pages=0)
    dkwargs = dict(draft_overrides or {})
    dkwargs.setdefault("max_position",
                       max(512, dcfg.pages_per_slot * dcfg.page_size))
    dkwargs["dtype"] = torch.float32
    draft = get_model(draft_model_name, **dkwargs)
    draft.reset_parameters(torch.Generator().manual_seed(seed + 1))
    dparams = {name: p.detach() for name, p in draft.named_parameters()}

    class _SpecEngine(SpeculativeEngine):
        # batch_stats: a vision model's, which the slot engine refuses
        def __init__(self, model, config, params, device=None,
                     batch_stats=None):
            super().__init__(model, config, params, draft, dparams,
                             spec_k=draft_k, device=device)

    return build_serving_engine(
        model_name, config=cfg, engine_cls=_SpecEngine,
        min_positions=cfg.pages_per_slot * cfg.page_size, seed=seed, **kw)


def load_schedule(rng: np.random.RandomState, n_requests: int, top: int,
                  vocab: int, max_new_tokens: int, mixed_want: bool
                  ) -> Tuple[List[np.ndarray], List[int]]:
    """The serving rows' load: ``n_requests`` prompts of 1..``top`` tokens
    and each one's wanted tokens (1..max_new under ``mixed_want``), drawn
    in the JAX rows' order (lengths, prompts, wants), so both rows of the
    iteration-vs-token A/B see the same prompts and wants."""
    lens = [int(rng.randint(1, top + 1)) for _ in range(n_requests)]
    prompts = [rng.randint(0, max(vocab, 2), n).astype(np.int32)
               for n in lens]
    wants = ([int(rng.randint(1, max_new_tokens + 1))
              for _ in range(n_requests)] if mixed_want
             else [max_new_tokens] * n_requests)
    return prompts, wants


def _ms(values, q: float) -> float:
    return round(float(np.percentile(values, q)), 2)


def measure_serving(model_name: str = "gpt2_124m", n_requests: int = 24,
                    offered_rps: float = 16.0,
                    buckets: Sequence[int] = (16, 32), rows: int = 8,
                    max_new_tokens: int = 8, serve_dtype: str = "fp32",
                    mixed_want: bool = False,
                    model_overrides: Optional[dict] = None,
                    ckpt_dir: Optional[str] = None, seed: int = 0,
                    optimizer: str = "auto", layout: str = "replicated",
                    device: DeviceLike = None,
                    return_results: bool = False):
    """Serving latency and throughput at fixed offered load, the
    iteration-granular row (``serving bench``).

    A load generator submits ``n_requests`` mixed-length prompts on a
    1/``offered_rps`` cadence into the request queue while the engine
    worker drains it; a request's latency is submit -> result. Reports
    p50/p99 latency and the achieved request and token rates (offered is
    what the schedule asks for, achieved what the engine absorbed). Under
    ``mixed_want`` each request wants 1..max_new tokens; this engine
    decodes max_new for every batch member, so ``tokens_per_sec`` counts
    the wanted tokens only.

    The JAX row's keys but its compile census and contract verdict; a
    token model that is not an LM (BERT) has no ``tokens_per_sec``, and an
    image model raises the JAX row's ValueError. ``engine.warmup()`` runs
    every bucket once before the window, so CUDA's first-call costs stay
    out of it. ``return_results`` also returns the per-request `Result`s
    in submission order."""
    from ..serving.batching import RequestQueue, serve_forever

    engine = build_serving_engine(
        model_name, buckets=buckets, rows=rows,
        max_new_tokens=max_new_tokens, serve_dtype=serve_dtype,
        model_overrides=model_overrides, ckpt_dir=ckpt_dir, seed=seed,
        optimizer=optimizer, layout=layout, device=device)
    if not engine.is_token:
        # the load generator submits token prompts (the JAX row's check)
        raise ValueError(
            f"serving bench drives token models (gpt2/bert); {model_name} "
            "serves images — use `serving smoke` or engine.serve_images")
    rng = np.random.RandomState(seed)
    vocab = int(engine.model.vocab_size)
    prompts, wants = load_schedule(rng, n_requests,
                                   max(engine.config.buckets), vocab,
                                   max_new_tokens, mixed_want)
    engine.warmup()
    queue = RequestQueue(engine.config.buckets)
    stop = threading.Event()
    worker = threading.Thread(target=serve_forever,
                              args=(engine, queue, stop), daemon=True)
    worker.start()
    gap = 1.0 / max(offered_rps, 1e-9)
    reqs = []
    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        # fixed offered load: submit on schedule, never "when ready"
        lag = t_start + i * gap - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        reqs.append(queue.submit(p))
    results = [r.result(timeout=600.0) for r in reqs]
    stop.set()
    worker.join(timeout=60.0)

    lat_ms = np.array([(r.t_done - r.t_submit) * 1e3 for r in reqs])
    window_s = max(max(r.t_done for r in reqs) - t_start, 1e-9)
    row = {
        "mode": "serving",
        "model": model_name,
        "serve_dtype": serve_dtype,
        "buckets": list(engine.config.buckets),
        "rows": rows,
        "max_new_tokens": max_new_tokens,
        "n_requests": n_requests,
        "mixed_want": mixed_want,
        "offered_rps": offered_rps,
        "achieved_rps": round(n_requests / window_s, 2),
        "p50_ms": _ms(lat_ms, 50),
        "p99_ms": _ms(lat_ms, 99),
        "mean_ms": round(float(lat_ms.mean()), 2),
        # only a causal LM generates tokens: a BERT row has no rate
        **({"tokens_per_sec": round(sum(wants) / window_s, 1)}
           if engine.is_lm else {}),
        "checkpoint": engine.checkpoint_info,
    }
    if serve_dtype == "int8":
        from ..serving.engine import int8_weight_bytes

        row["weight_bytes"] = int8_weight_bytes(engine._served)
    return (row, results) if return_results else row


def measure_serving_continuous(model_name: str = "gpt2_124m",
                               n_requests: int = 24,
                               offered_rps: float = 16.0,
                               buckets: Sequence[int] = (8, 16),
                               rows: int = 8, max_new_tokens: int = 8,
                               kv_dtype: str = "fp32", page_size: int = 8,
                               mixed_want: bool = False,
                               replicas: int = 1,
                               kill_replica: bool = False,
                               temperature: float = 0.0, top_p: float = 1.0,
                               draft_model: Optional[str] = None,
                               draft_k: int = 4,
                               shared_frac: float = 0.0,
                               prefix_skip: bool = True,
                               serve_dtype: str = "fp32",
                               model_overrides: Optional[dict] = None,
                               ckpt_dir: Optional[str] = None, seed: int = 0,
                               optimizer: str = "auto",
                               layout: str = "replicated",
                               device: DeviceLike = None,
                               return_results: bool = False):
    """Token-granular serving at fixed offered load, the continuous row
    beside `measure_serving`'s (same load schedule and prompts: the A/B on
    tokens/s and tail latency).

    ``replicas`` slot engines sit behind the stdlib `Router` (one replica
    too: the row always dispatches through it); ``kill_replica`` kills
    replica 0 a third of the way into the load, and every request must
    still complete. The row carries the paged pool's bytes against the
    dense fp32 baseline (``kv_bytes_ratio``) and TTFT percentiles.
    ``draft_model`` arms speculative decoding (fp32 pools only; the row
    gains ``accept_ratio``, ``accepted_per_verify``, ``spec_rounds``);
    ``shared_frac`` gives that share of the requests one page-aligned
    prompt (the row gains ``prefill_skips``, ``tail_resumes`` and the
    warm/cold TTFT split).

    The JAX row's keys but its compile census, contract verdict and CPU
    caveat; ``backend`` is the device type. All replicas share one
    device. ``return_results`` also returns the `Result`s in submission
    order."""
    from ..serving.router import InProcessReplica, Router

    if draft_model is not None and kv_dtype != "fp32":
        raise ValueError(
            f"--draft needs kv_dtype=fp32 (got {kv_dtype}): the verify "
            "window's in-view rows are fresh fp32 while the int8 path "
            "reads dequantized page bytes")
    engines = []
    for _ in range(replicas):
        common = dict(
            buckets=buckets, rows=rows, max_new_tokens=max_new_tokens,
            page_size=page_size, prefix_skip=prefix_skip,
            serve_dtype=serve_dtype, model_overrides=model_overrides,
            ckpt_dir=ckpt_dir, seed=seed, optimizer=optimizer,
            layout=layout, device=device)
        if draft_model is not None:
            # the draft takes the target's overrides: acceptance compares
            # token ids, so a vocab override must hit both
            engine = build_spec_engine(model_name, draft_model,
                                       draft_k=draft_k,
                                       draft_overrides=model_overrides,
                                       **common)
        else:
            engine = build_slot_engine(model_name, kv_dtype=kv_dtype,
                                       **common)
        engine.warmup()
        engines.append(engine)

    rng = np.random.RandomState(seed)
    vocab = int(engines[0].model.vocab_size)
    top = max(engines[0].config.buckets)
    prompts, wants = load_schedule(rng, n_requests, top, vocab,
                                   max_new_tokens, mixed_want)
    # shared_frac: that share of the requests carry one page-aligned
    # prompt; the first on a replica prefills and registers its pages,
    # every later one admits with no prefill. The draws come after the
    # schedule's, so the A/B with measure_serving holds
    shared_idx: set = set()
    if shared_frac > 0:
        n_shared = int(round(shared_frac * n_requests))
        shared_len = min(max(page_size, top // page_size * page_size), top)
        shared_prompt = rng.randint(0, max(vocab, 2),
                                    shared_len).astype(np.int32)
        if n_shared >= 1:
            shared_idx = set(
                int(j) for j in rng.choice(n_requests, size=n_shared,
                                           replace=False))
            for j in shared_idx:
                prompts[j] = shared_prompt

    router = Router([InProcessReplica(f"r{i}", e)
                     for i, e in enumerate(engines)])
    kill_at = n_requests // 3 if (kill_replica and replicas > 1) else None
    gap = 1.0 / max(offered_rps, 1e-9)
    reqs, sub_at = [], []
    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        lag = t_start + i * gap - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        sub_at.append(time.perf_counter())
        reqs.append(router.submit(p, max_new_tokens=wants[i],
                                  temperature=temperature, top_p=top_p))
        if kill_at is not None and i == kill_at:
            # the injected death: r0's requests fail with ReplicaDead and
            # the router resubmits them to the survivors
            router.replicas["r0"].kill()
    results = [r.result(timeout=600.0) for r in reqs]
    # the worker's completion stamps, not this loop's collection time
    done_at = [r.t_done for r in reqs]
    # "alive" means survived the run: snapshot before stop() ends the
    # scheduler threads
    alive = {name: rep.healthy() for name, rep in router.replicas.items()}
    router.stop()

    lat_ms = np.array([(d - s) * 1e3 for s, d in zip(sub_at, done_at)])
    ttft_ms = np.array([res.queue_wait_s * 1e3 for res in results])
    window_s = max(max(done_at) - t_start, 1e-9)
    n_tokens = int(sum(res.tokens.size for res in results))
    per_replica = {}
    for name, rep in router.replicas.items():
        mine = [lat_ms[i] for i in range(n_requests)
                if reqs[i].replica_name == name]
        per_replica[name] = {
            "served": rep.scheduler.served,
            "alive": alive[name],
            **({"p50_ms": _ms(mine, 50), "p99_ms": _ms(mine, 99)}
               if mine else {}),
        }
    scheds = [rep.scheduler for rep in router.replicas.values()]
    engine = engines[0]
    row = {
        "mode": "serving_continuous",
        "granularity": "token",
        "model": model_name,
        "kv_dtype": kv_dtype,
        "page_size": page_size,
        "buckets": list(engine.config.buckets),
        "rows": rows,
        "max_new_tokens": max_new_tokens,
        "n_requests": n_requests,
        "mixed_want": mixed_want,
        "completed": len(results),
        "offered_rps": offered_rps,
        "achieved_rps": round(n_requests / window_s, 2),
        "p50_ms": _ms(lat_ms, 50),
        "p99_ms": _ms(lat_ms, 99),
        "mean_ms": round(float(lat_ms.mean()), 2),
        "ttft_p50_ms": _ms(ttft_ms, 50),
        "ttft_p99_ms": _ms(ttft_ms, 99),
        "tokens_per_sec": round(n_tokens / window_s, 1),
        "replicas": replicas,
        "replica_deaths": sum(r.replica_deaths for r in reqs),
        "per_replica": per_replica,
        "prefix_skip": prefix_skip,
        "prefill_skips": sum(s.prefill_skips for s in scheds),
        "tail_resumes": sum(s.tail_resumes for s in scheds),
        "shared_frac": shared_frac,
        "draft": draft_model,
        "paged_kv_bytes": engine.paged_bytes(),
        "dense_kv_bytes": engine.dense_baseline_bytes(),
        "checkpoint": engine.checkpoint_info,
    }
    row["kv_bytes_ratio"] = round(
        row["dense_kv_bytes"] / max(row["paged_kv_bytes"], 1), 2)
    if draft_model is not None:
        rounds = sum(s.spec_rounds for s in scheds)
        proposed = sum(s.spec_proposed for s in scheds)
        accepted = sum(s.spec_accepted for s in scheds)
        row["draft_k"] = draft_k
        row["spec_rounds"] = rounds
        # accept_ratio is the draft's hit rate; accepted_per_verify the
        # draft tokens banked per target forward
        row["accept_ratio"] = round(accepted / max(proposed, 1), 3)
        row["accepted_per_verify"] = round(accepted / max(rounds, 1), 2)
        row["draft_kv_bytes"] = engine.draft_bytes()
        row["backend"] = engine.device.type
    if shared_idx:
        # warm = shared-prompt requests after their replica's primer (the
        # one that paid the prefill); everything else is cold
        primers, seen = set(), set()
        for i in sorted(shared_idx):
            name = reqs[i].replica_name
            if name not in seen:
                seen.add(name)
                primers.add(i)
        warm = [float(ttft_ms[i]) for i in shared_idx if i not in primers]
        cold = [float(ttft_ms[i]) for i in range(n_requests)
                if i not in shared_idx or i in primers]
        if warm:
            row["ttft_warm_p50_ms"] = _ms(warm, 50)
        if cold:
            row["ttft_cold_p50_ms"] = _ms(cold, 50)
    return (row, results) if return_results else row
