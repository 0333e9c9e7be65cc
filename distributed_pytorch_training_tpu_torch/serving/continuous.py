"""Token-granular continuous batching over a paged KV cache (the JAX
package's serving/continuous.py).

The dense engine (``engine.py``) batches at iteration granularity: a
group enters prefill together, decodes together and leaves together, so a
short request waits for its longest batch-mate and an arrival waits for
the whole cycle. This module decodes over SLOTS instead:

* `SlotEngine` keeps ``rows`` slots and one decode step that advances
  every live slot by one token. A request is admitted into a free slot by
  a B=1 prefill of its own bucket, and leaves the moment its own budget
  is spent; ``budget > 0`` is a slot's liveness, and inactive slots write
  nothing to the pool.
* The KV cache is the paged pool (``models/layers.py``): the decode step
  gathers each slot's pages into the dense view the decode attention
  reads and scatters the one fresh row back. Page residency is a host
  decision (``paged.py::PagePool``): prefix sharing, eviction, int8 pages.
  With ``kv_dtype="int8"`` every prefill and every decode step quantizes
  the fresh k and v rows through K1 (``ops/quantize.py``).
* Sampling is per request: each slot carries its request's (key,
  temperature, top_p), and the token at absolute position q is drawn with
  ``fold_in(PRNGKey(seed), q)``, jax.random's own key stream
  (``utils/prng.py``). A request's stream is a function of the request
  alone, whatever its slot, join order or batch company.
  ``temperature=0`` is argmax.
* `ContinuousScheduler` is the host loop: admit from the queue
  (``RequestQueue.take``, FIFO and bucket-blind), run decode steps, mirror
  each slot's budget in Python ints, and complete a request when its
  budget reaches zero. ``slot_wait`` spans and the slot-occupancy and
  page-pool gauges are emitted here.

No step is compiled: the JAX package's lowered programs, its compile
census and its ``serving_paged`` HLO contract have no counterpart here.
The pool and the control tensors are updated in place. Grad mode is
thread-local, so every engine entry runs under ``torch.inference_mode()``
itself: the scheduler drives the engine from its own thread.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from .. import telemetry
from ..data.pack import bucket_for
from ..models.layers import (
    dense_kv_bytes,
    gather_paged_kv,
    paged_kv_bytes,
    scatter_paged_prefill,
    scatter_paged_rows,
    scatter_paged_window,
)
from ..utils.locktrace import named_lock
from ..utils.prng import categorical, fold_in, prng_key
from .batching import Request, RequestQueue, Result
from .engine import InferenceEngine
from .paged import PagedServeConfig, PageLease, PagePool


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperatures: torch.Tensor,
                  top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row temperature/top-p sampling, (rows, vocab) logits -> (rows,)
    tokens. Every op is row-independent and each row draws from its own
    key (``keys`` (rows, 2)), so a row's token depends on its logits, key
    and knobs alone. ``temperature <= 0`` is plain argmax; the sampled
    branch is computed for every row and discarded by the where, as in
    the JAX package."""
    greedy = torch.argmax(logits, dim=-1)
    temps = torch.clamp(temperatures, min=1e-6)[:, None]
    scaled = logits.float() / temps
    order = torch.argsort(-scaled, dim=-1, stable=True)      # descending
    sorted_l = torch.gather(scaled, -1, order)
    # jax.nn.softmax: exp(x - max) / sum
    e = torch.exp(sorted_l - sorted_l.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: the smallest prefix with mass >= top_p; the first column
    # always survives (cum - prob == 0 < top_p)
    keep = (cum - probs) < top_ps[:, None]
    masked = torch.where(keep, sorted_l, torch.finfo(torch.float32).min)
    choice = categorical(keys, masked)
    sampled = torch.gather(order, -1, choice[:, None])[:, 0]
    return torch.where(temperatures <= 0.0, greedy, sampled)


def _inference(fn):
    """Run an engine entry under ``torch.inference_mode()`` on whatever
    thread calls it."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    return wrapped


class SlotEngine(InferenceEngine):
    """The device half of continuous batching: one paged decode step over
    the whole slot pool, one B=1 paged prefill per admission. Slot index,
    prompt length and sampling knobs are plain arguments; the pool, the
    page table and the per-slot control tensors stay on the device."""

    def __init__(self, model, config: PagedServeConfig, params,
                 device=None, batch_stats=None):
        if not isinstance(config, PagedServeConfig):
            raise ValueError(
                "SlotEngine needs a PagedServeConfig (page_size/kv_dtype "
                "knobs); a plain ServeConfig drives the dense engine")
        if not hasattr(model, "init_cache"):
            raise ValueError("continuous batching decodes causal LMs only")
        super().__init__(model, config, params, device=device,
                         batch_stats=batch_stats)
        if self.padded_len > model.max_position:
            raise ValueError(
                f"pages_per_slot * page_size = {self.padded_len} exceeds "
                f"the model's max_position {model.max_position}: the "
                "gathered dense view must fit the position table")
        self.reset_state()

    # -- state --------------------------------------------------------------

    @property
    def padded_len(self) -> int:
        """Width of the gathered dense view (pages_per_slot * page_size,
        >= bucket + max_new). Its tail positions hold scratch or stale
        finite values the decode mask zeroes."""
        cfg: PagedServeConfig = self.config
        return cfg.pages_per_slot * cfg.page_size

    def _init_control(self) -> Dict[str, torch.Tensor]:
        cfg: PagedServeConfig = self.config
        rows, dev = cfg.rows, self.device

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            # the token at `positions`, written by the next decode step
            "tok": zeros(rows),
            "positions": zeros(rows),
            # tokens still to emit; budget > 0 is slot liveness
            "budget": zeros(rows),
            "emitted": zeros(rows),
            # per-request sampling state
            "keys": zeros(rows, 2),
            "temps": zeros(rows, dtype=torch.float32),
            "top_ps": torch.ones(rows, dtype=torch.float32, device=dev),
            # per-slot outputs, fetched once at completion
            "out_buf": zeros(rows, cfg.max_new_tokens),
            "last_buf": zeros(rows, self.model.padded_vocab,
                              dtype=torch.float32),
            # prefix skip: the position whose decode logits go to
            # last_buf (-1 = captured already; a prefill writes last_buf
            # itself, a skip-admitted slot's first decode step does)
            "last_pos": torch.full((rows,), -1, dtype=torch.int64,
                                   device=dev),
        }

    @_inference
    def reset_state(self) -> None:
        """(Re)build the device state: a zeroed pool (page 0, the scratch
        page, finite), idle control rows, an all-scratch page table."""
        cfg: PagedServeConfig = self.config
        self._pool = self.model.init_paged_pool(
            cfg.total_pages, cfg.page_size,
            quantized=cfg.kv_dtype == "int8", device=self.device)
        self._control = self._init_control()
        self._page_table = np.zeros((cfg.rows, cfg.pages_per_slot),
                                    np.int32)
        self._table_dev = torch.from_numpy(self._page_table).to(
            self.device, torch.int64)

    def set_page_row(self, slot: int, row: np.ndarray) -> None:
        """Point one slot's table row at its leased pages (all zeros =
        scratch = released). The host array is the source of truth; the
        device copy is refreshed here, never inside a decode step."""
        self._page_table[slot] = row
        self._table_dev = torch.from_numpy(self._page_table).to(
            self.device, torch.int64)

    # -- pieces of the steps --------------------------------------------------

    def _forward(self, params, ids: torch.Tensor, **kw):
        return functional_call(self.model, params, (ids,), kw)

    def _sample(self, logits, keys, positions, temps, top_ps):
        """The tokens at ``positions``: row i drawn with
        ``fold_in(keys[i], positions[i])``."""
        return sample_tokens(logits, fold_in(keys, positions), temps, top_ps)

    def _dense_cache(self, pool, table, model):
        k_all, v_all = gather_paged_kv(pool, table, dtype=model.dtype)
        return tuple((k_all[i], v_all[i]) for i in range(model.depth))

    def _arm(self, slot: int, tok, position: int, budget: int,
             emitted: int, key, temperature: float, top_p: float,
             last=None, last_pos: int = -1) -> None:
        """Set one slot's control row at admission."""
        c = self._control
        c["tok"][slot] = tok
        c["positions"][slot] = position
        c["budget"][slot] = budget
        c["emitted"][slot] = emitted
        c["keys"][slot] = key
        c["temps"][slot] = temperature
        c["top_ps"][slot] = top_p
        c["out_buf"][slot] = 0
        if emitted:
            c["out_buf"][slot, 0] = tok
        if last is not None:
            c["last_buf"][slot] = last
        c["last_pos"][slot] = last_pos

    def _first_token(self, logits_row, key, n: int, temperature: float,
                     top_p: float):
        """Token #0, drawn from the last real prompt position's logits
        with ``fold_in(key, n)``: it occupies absolute position n."""
        dev = self.device
        return self._sample(
            logits_row[None], key[None], torch.tensor([n], device=dev),
            torch.tensor([temperature], device=dev),
            torch.tensor([top_p], device=dev))[0]

    def _prompt_ids(self, tokens: np.ndarray) -> Tuple[int, torch.Tensor]:
        cfg: PagedServeConfig = self.config
        bucket = bucket_for(len(tokens), cfg.buckets)
        ids = np.full((1, bucket), cfg.pad_id, np.int64)
        ids[0, :len(tokens)] = tokens
        return bucket, torch.from_numpy(ids).to(self.device)

    # -- the runtime entries (scheduler-facing) -------------------------------

    @_inference
    def admit(self, slot: int, tokens: np.ndarray, want: int,
              temperature: float, top_p: float, seed: int) -> int:
        """Prefill the slot's prompt into its pages and emit token #0;
        returns the bucket served. Does not synchronize: the scheduler's
        per-step fence bounds the queued work."""
        bucket, ids = self._prompt_ids(tokens)
        n = len(tokens)
        cache0 = self.model.init_cache(1, bucket, device=self.device)
        logits, cache = self._forward(self._params(), ids, cache=cache0)
        last = logits[0, max(n - 1, 0)]
        key = prng_key(seed, self.device)
        t0 = self._first_token(last, key, n, temperature, top_p)
        # the pool is layer-stacked: the whole prompt lands in one scatter
        scatter_paged_prefill(self._pool, self._table_dev[slot],
                              torch.stack([c[0][0] for c in cache]),
                              torch.stack([c[1][0] for c in cache]), n)
        self._arm(slot, t0, n, want - 1, 1, key, temperature, top_p,
                  last=last)
        return bucket

    @property
    def prefix_skip_enabled(self) -> bool:
        """Whether admission may skip or shorten the prefill for resident
        prefixes. fp32 pools only: an int8 skip would read dequantized
        pages where the cold prefill reads fresh fp32, so residency would
        change the stream and break the router's same-seed retry."""
        cfg: PagedServeConfig = self.config
        return (cfg.prefix_sharing and cfg.prefix_skip
                and cfg.kv_dtype == "fp32")

    @_inference
    def admit_skip(self, slot: int, last_tok: int, length: int, want: int,
                   temperature: float, top_p: float, seed: int) -> None:
        """Admit a fully prefix-resident request with no forward: the slot
        enters the shared decode step at position length-1 holding the
        last prompt token. That step rewrites the resident row with its
        own bytes, samples token #0 with ``fold_in(key, length)`` as the
        prefill does, and captures the last-prompt logits (``last_pos``).
        budget = want: nothing is emitted yet."""
        self._arm(slot, last_tok, length - 1, want, 0,
                  prng_key(seed, self.device), temperature, top_p,
                  last_pos=length - 1)

    @_inference
    def admit_resume(self, slot: int, tokens: np.ndarray, start: int,
                     want: int, temperature: float, top_p: float,
                     seed: int) -> int:
        """Admit a partly resident request: prefill only the tail
        ``tokens[start:]``, a window decode at offset ``start`` over the
        resident pages. Returns the tail's bucket."""
        bucket, ids = self._prompt_ids(tokens[start:])
        n = len(tokens)
        dev = self.device
        row_tbl = self._table_dev[slot:slot + 1]
        cache = self._dense_cache(self._pool, row_tbl, self.model)
        logits, new_cache = self._forward(
            self._params(), ids, cache=cache,
            cache_positions=torch.tensor([start], device=dev))
        last = logits[0, max(n - start - 1, 0)]
        key = prng_key(seed, dev)
        t0 = self._first_token(last, key, n, temperature, top_p)
        # commit the tail's k/v rows at positions [start, n)
        win_pos = start + torch.arange(bucket, device=dev)[None, :]
        idx = torch.clamp(win_pos[0], 0, self.padded_len - 1)
        act = (win_pos < n) & (win_pos < self.padded_len)
        scatter_paged_window(
            self._pool, row_tbl, win_pos,
            torch.stack([c[0][:, idx] for c in new_cache]),
            torch.stack([c[1][:, idx] for c in new_cache]), act)
        self._arm(slot, t0, n, want - 1, 1, key, temperature, top_p,
                  last=last)
        return bucket

    @_inference
    def decode_step(self) -> None:
        """One decode step over the whole slot pool; everything stays on
        the device (no host fetch)."""
        c = self._control
        active = c["budget"] > 0
        positions = c["positions"]
        rows = positions.shape[0]
        # read half: every slot's pages -> the dense view, one gather
        cache = self._dense_cache(self._pool, self._table_dev, self.model)
        logits, new_cache = self._forward(
            self._params(), c["tok"][:, None], cache=cache,
            cache_positions=positions)
        # write half: one fresh (H, D) row per live slot per layer, one
        # scatter back to the pool
        ridx = torch.arange(rows, device=self.device)
        pidx = torch.clamp(positions, 0, self.padded_len - 1)
        scatter_paged_rows(self._pool, self._table_dev, positions,
                           torch.stack([k[ridx, pidx] for k, _ in new_cache]),
                           torch.stack([v[ridx, pidx] for _, v in new_cache]),
                           active)
        # the token at position p+1, from this request's key stream
        nxt = self._sample(logits[:, 0], c["keys"], positions + 1,
                           c["temps"], c["top_ps"])
        act = active.to(torch.int64)
        cols = torch.arange(c["out_buf"].shape[1], device=self.device)
        hit = (cols[None, :] == c["emitted"][:, None]) & active[:, None]
        # a skip-admitted slot's first step captures the last-prompt
        # logits the prefill would have stored
        cap = positions == c["last_pos"]
        c["out_buf"] = torch.where(hit, nxt[:, None], c["out_buf"])
        c["last_buf"] = torch.where(cap[:, None], logits[:, 0],
                                    c["last_buf"])
        c["last_pos"] = torch.where(cap, -1, c["last_pos"])
        c["tok"] = torch.where(active, nxt, c["tok"])
        c["positions"] = positions + act
        c["budget"] = c["budget"] - act
        c["emitted"] = c["emitted"] + act

    def fence(self) -> None:
        """Wait for the work queued on the card (a no-op on the CPU)."""
        self._sync()

    def fetch_slot(self, slot: int) -> Tuple[np.ndarray, np.ndarray]:
        """One host fetch of a finished slot's outputs (its tokens row and
        last-prompt logits), at completion only. Copies: on the CPU a
        tensor's numpy view would share the buffer the next admission
        overwrites."""
        c = self._control
        return (np.array(c["out_buf"][slot].cpu(), np.int32),
                np.array(c["last_buf"][slot].cpu(), np.float32))

    def warmup(self) -> int:
        """Run every step kind once (a prefill per bucket, a decode step,
        and with prefix skip a skip and a tail resume per bucket) on
        throwaway prompts that write only the scratch page, then reset
        the state: CUDA's and the allocator's first-call costs land here,
        not in the first request. Returns the number of steps run."""
        cfg: PagedServeConfig = self.config
        steps = 0
        for b in cfg.buckets:
            self.admit(0, np.full(b, cfg.pad_id, np.int32), 2, 0.0, 1.0, 0)
            steps += 1
        self.decode_step()
        steps += 1
        if self.prefix_skip_enabled:
            self.admit_skip(0, cfg.pad_id, 2, 2, 0.0, 1.0, 0)
            steps += 1
            for b in cfg.buckets:
                self.admit_resume(0, np.full(b + 1, cfg.pad_id, np.int32),
                                  1, 2, 0.0, 1.0, 0)
                steps += 1
        self.fence()
        self.reset_state()
        return steps

    # -- byte accounting -----------------------------------------------------

    def paged_bytes(self) -> int:
        """At-rest bytes of the paged pool (codes and scales when int8)."""
        return paged_kv_bytes(self._pool)

    def dense_baseline_bytes(self) -> int:
        """What the dense engine would hold at this config, in fp32."""
        cfg: PagedServeConfig = self.config
        return dense_kv_bytes(
            cfg.rows, max(cfg.buckets) + cfg.max_new_tokens,
            self.model.num_heads,
            self.model.hidden_dim // self.model.num_heads,
            self.model.depth)


@dataclasses.dataclass
class _SlotState:
    """Host mirror of one live slot: enough to detect completion without
    touching the device (the budget arithmetic replayed in Python ints,
    one decrement per decode step)."""

    req: Request
    lease: PageLease
    bucket: int
    want: int
    left: int  # tokens still to emit (device budget mirror)


class ContinuousScheduler:
    """The host loop: queue -> slots -> steps -> results.

    One thread drives the engine; thread safety toward producers lives in
    `RequestQueue`. `run` is the worker loop: stop means DRAIN (admitted
    and queued work completes, new work is refused); `kill` is the chaos
    hook (fail everything in flight; the router resubmits elsewhere)."""

    def __init__(self, engine: SlotEngine, queue: RequestQueue):
        cfg: PagedServeConfig = engine.config
        self.engine = engine
        self.queue = queue
        self.pool = PagePool(cfg.total_pages, cfg.page_size,
                             cfg.pages_per_slot,
                             prefix_sharing=cfg.prefix_sharing)
        self.free_slots: List[int] = list(range(cfg.rows))  # guarded-by: _lock
        self.running: Dict[int, _SlotState] = {}            # guarded-by: _lock
        self.pending: List[Request] = []                    # guarded-by: _lock
        self._t_popped: Dict[int, float] = {}               # guarded-by: _lock
        self.served = 0                                     # guarded-by: _lock
        self.killed = False                                 # guarded-by: _lock
        # serializes step() against kill(): kill runs on the caller's
        # thread while the worker is mid-step; without the lock it races
        # the running/pending iteration and can resolve a request twice
        self._lock = named_lock("ContinuousScheduler._lock")
        # set by kill() before it waits for the lock: a released lock
        # goes to whichever thread asks first, and the worker, looping,
        # always asks first, so without this a kill waits until the
        # worker runs out of work
        self._kill_requested = threading.Event()
        # max decode steps per fence when nothing waits to join (step());
        # 1 fences after every token
        self.burst_steps = 4
        # prefix-resident admission census: admissions that skipped the
        # prefill entirely, and those that prefilled only a tail
        self.prefill_skips = 0                              # guarded-by: _lock
        self.tail_resumes = 0                               # guarded-by: _lock

    # -- admission -----------------------------------------------------------

    def _gauges(self) -> None:   # lock-held: _lock
        cfg: PagedServeConfig = self.engine.config
        telemetry.gauge("serving_slot_occupancy",
                        len(self.running) / max(cfg.rows, 1))
        telemetry.gauge("serving_page_pool_free", self.pool.free_pages())
        # the router's load signal: everything accepted but unfinished
        # (HttpReplica.queue_depth scrapes it off /metrics)
        telemetry.gauge("serving_queue_depth",
                        len(self.queue) + len(self.pending)
                        + len(self.running))

    def _try_admit(self, req: Request) -> bool:   # lock-held: _lock
        """One admission attempt: needs a free slot and a page lease.
        False means 'not now' (the request stays pending).

        With prefix skip live (fp32 pools), the lease's shared pages
        decide the prefill: >= len(prompt) - 1 positions resident -> no
        prefill at all (the slot enters decode at the resumed position);
        partly resident -> a prefill of the fresh tail only. Cold prompts
        take the full prefill."""
        if not self.free_slots:
            return False
        cfg: PagedServeConfig = self.engine.config
        want = cfg.max_new_tokens if req.max_new_tokens is None else \
            min(int(req.max_new_tokens), cfg.max_new_tokens)
        want = max(want, 1)
        lease = self.pool.alloc(req.tokens, len(req.tokens) + want)
        if lease is None:
            return False
        if not self._draft_admit(req, lease, want):
            # rollback, not release: the lease's fresh pages were
            # hash-registered at alloc time but never prefilled, and a
            # retry of the same prompt would skip-admit onto garbage
            self.pool.rollback(lease)
            return False
        slot = self.free_slots.pop()
        self.engine.set_page_row(slot, lease.pages)
        n = len(req.tokens)
        covered = len(lease.shared) * cfg.page_size
        t0 = time.perf_counter()
        skip_ok = getattr(self.engine, "prefix_skip_enabled", False)
        if skip_ok and covered >= n - 1 and covered > 0:
            self.engine.admit_skip(slot, int(req.tokens[-1]), n, want,
                                   req.temperature, req.top_p, req.seed)
            bucket = bucket_for(n, cfg.buckets)
            left = want   # nothing emitted yet: decode emits all `want`
            self.prefill_skips += 1
            telemetry.span_event("prefill_skip", time.perf_counter() - t0,
                                 slot=slot, request=req.id,
                                 resident=covered)
        elif skip_ok and covered > 0:
            bucket = self.engine.admit_resume(
                slot, req.tokens, covered, want, req.temperature,
                req.top_p, req.seed)
            left = want - 1
            self.tail_resumes += 1
            telemetry.span_event("prefill", time.perf_counter() - t0,
                                 bucket=bucket, slot=slot, request=req.id,
                                 resumed=covered)
        else:
            bucket = self.engine.admit(slot, req.tokens, want,
                                       req.temperature, req.top_p,
                                       req.seed)
            left = want - 1
            telemetry.span_event("prefill", time.perf_counter() - t0,
                                 bucket=bucket, slot=slot, request=req.id)
        now = time.perf_counter()
        # t_first_token stays None until the next step's fence: admission
        # only queued device work; the spans above are the dispatch cost
        telemetry.span_event(
            "slot_wait", now - self._t_popped.pop(req.id, now),
            request=req.id, slot=slot)
        self.running[slot] = _SlotState(req=req, lease=lease, bucket=bucket,
                                        want=want, left=left)
        self._post_admit(slot, req)
        self._gauges()
        return True

    def _draft_admit(self, req: Request, lease: PageLease,
                     want: int) -> bool:   # lock-held: _lock
        """Speculative hook: lease the draft pool for this request before
        the target admission commits (False aborts the attempt and the
        target lease is rolled back). The plain scheduler has no draft."""
        return True

    def _post_admit(self, slot: int, req: Request) -> None:  # lock-held: _lock
        """Speculative hook: the target admission landed in ``running``
        (the draft prefills its pages here)."""

    def _post_complete(self, slot: int) -> None:   # lock-held: _lock
        """Speculative hook: a slot finished; release its draft lease."""

    def _admit_pending(self) -> None:   # lock-held: _lock
        still: List[Request] = []
        for req in self.pending:
            if not self._try_admit(req):
                still.append(req)
        self.pending = still

    def _pull(self, timeout: float = 0.005) -> None:   # lock-held: _lock
        # keep at most ~2 pool-fulls on deck; never block while slots are
        # decoding (the queue wait is for the idle loop only)
        cap = 2 * self.engine.config.rows - len(self.pending)
        if cap <= 0:
            return
        got = self.queue.take(cap,
                              timeout=0.0 if self.running else timeout)
        now = time.perf_counter()
        for req in got:
            self._t_popped[req.id] = now
        self.pending.extend(got)

    # -- the decode loop -----------------------------------------------------

    def _step_decode_loop(self, n_steps: int) -> None:   # lock-held: _lock
        """``n_steps`` decode steps, the mirrors replayed in Python; no
        host fetch in here (completion fetches happen in
        `_complete_finished`)."""
        for _ in range(n_steps):
            self.engine.decode_step()
            for st in self.running.values():
                if st.left > 0:
                    st.left -= 1

    def _advance(self) -> None:   # lock-held: _lock
        """Advance every live slot: 1..burst decode steps (one token
        each); the speculative scheduler overrides this with one propose
        + verify round. The caller fences and completes afterwards."""
        steps = 1
        if not self.pending and not len(self.queue):
            steps = max(1, min(min(st.left for st in
                                   self.running.values()),
                               self.burst_steps))
        self._step_decode_loop(steps)

    def _complete_finished(self) -> None:   # lock-held: _lock
        t0 = time.perf_counter()
        done = [slot for slot, st in self.running.items() if st.left == 0]
        for slot in done:
            st = self.running.pop(slot)
            toks, last = self.engine.fetch_slot(slot)
            now = time.perf_counter()
            first = st.req.t_first_token or t0
            res = Result(tokens=np.asarray(toks[:st.want], np.int32),
                         last_logits=np.asarray(last),
                         bucket=st.bucket,
                         queue_wait_s=max(0.0, first - st.req.t_submit),
                         decode_s=max(0.0, now - first))
            self.pool.release(st.lease)
            self.engine.set_page_row(
                slot, np.zeros(self.engine.config.pages_per_slot, np.int32))
            self._post_complete(slot)
            self.free_slots.append(slot)
            st.req.set_result(res)
            self.served += 1
        if done:
            self._gauges()

    # -- lifecycle -----------------------------------------------------------

    def step(self) -> bool:
        """One scheduling iteration: pull, admit, decode, fence, complete.
        Returns whether any work remains in flight or pending.

        The fence bounds the queued work: the host queues steps faster
        than the card runs them, and without it every completion fetch
        would wait behind the whole backlog. When nothing waits to join,
        the loop runs up to `burst_steps` decode steps before fencing; no
        slot can finish earlier than its budget, so the burst delays no
        completion, and an arrival waits at most `burst_steps` tokens.

        The iteration holds the scheduler lock, so `kill` (called from
        another thread) lands at a step boundary: the next one, since no
        step starts while a kill is waiting."""
        # killed only goes from False to True (see run())
        if self._kill_requested.is_set() and not self.killed:  # analysis: disable=guarded-by
            time.sleep(0.001)      # let the waiting kill take the lock
            return True
        with self._lock, torch.inference_mode():
            if self.killed:
                return False
            self._pull()
            self._admit_pending()
            if self.running:
                self._advance()
                self.engine.fence()
                # the fence proves every queued prefill's token #0 is
                # out: the (slightly late) TTFT stamp
                now = time.perf_counter()
                for st in self.running.values():
                    if st.req.t_first_token is None:
                        st.req.t_first_token = now
                self._complete_finished()
            return bool(self.running or self.pending)

    def run(self, stop: threading.Event, log=None) -> int:
        """Serve until ``stop`` is set AND everything accepted has
        completed (stop = drain, the SIGTERM contract). Returns the
        requests served."""
        # unlocked reads of killed/running/pending/served below are the
        # worker's own loop control and post-mortem logging: killed only
        # goes from False to True, and step() re-checks it under the lock
        while not self.killed:  # analysis: disable=guarded-by
            if stop.is_set():
                self.queue.close()
            busy = self.step()
            if stop.is_set() and not busy and not len(self.queue):
                break
        if self.killed and log is not None:  # analysis: disable=guarded-by
            log("serving: scheduler killed with "
                f"{len(self.running) + len(self.pending)} in flight")  # analysis: disable=guarded-by
        return self.served  # analysis: disable=guarded-by

    def drain(self, log=None) -> int:
        """Finish everything queued and in flight, then return, inside the
        ``drain`` span as the iteration-granular path does."""
        stop = threading.Event()
        stop.set()
        # span attributes: a racy snapshot, taken without stalling a step
        with telemetry.span("drain",
                            pending=len(self.queue) + len(self.pending),  # analysis: disable=guarded-by
                            running=len(self.running)):  # analysis: disable=guarded-by
            return self.run(stop, log=log)

    def kill(self, err: Optional[BaseException] = None) -> List[Request]:
        """Chaos hook: fail every in-flight, pending and still-queued
        request (the injected replica death) and return them; the router
        resubmits them to surviving replicas. Under the scheduler lock, so
        the death lands at a step boundary: what that step completed is
        resolved once, as results, and everything else fails here once."""
        self._kill_requested.set()
        with self._lock:
            self.killed = True
            err = err or RuntimeError("replica died")
            failed: List[Request] = []
            for st in self.running.values():
                st.req.set_error(err)
                failed.append(st.req)
            for req in self.pending:
                req.set_error(err)
                failed.append(req)
            # accepted-but-unpulled requests die with the replica too: in
            # the closed queue they would hang their waiters forever
            self.queue.close()
            for req in self.queue.take(len(self.queue) + 1, timeout=0.0):
                req.set_error(err)
                failed.append(req)
            self.running.clear()
            self.pending.clear()
            return failed


def serve_continuous(engine: SlotEngine, queue: RequestQueue,
                     stop: threading.Event, log=None) -> int:
    """The worker loop of the continuous engine, the counterpart of
    ``batching.serve_forever``."""
    return ContinuousScheduler(engine, queue).run(stop, log=log)
