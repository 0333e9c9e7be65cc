"""Draft-model speculative decoding over the paged cache (the JAX package's
serving/speculative.py).

Each token of the continuous engine costs one target forward. Speculative
decoding buys several tokens a target forward:

* A small DRAFT model proposes K greedy tokens per live slot per round,
  decoding over its own paged pool (the same page machinery, fp32).
* The TARGET verifies all K+1 window positions in one batched forward,
  the per-row-positions decode mode of ``models/gpt2.py`` over an S-token
  window (``scatter_paged_window`` commits the window's k/v).
* Acceptance is exact token match: window output j is the token the plain
  path samples at that position (the same ``fold_in(request_key,
  position)`` key), and a proposal is accepted only when it equals that
  token. Every emitted token is target-sampled, so the draft steers only
  the accept ratio. In the JAX package window row j is bitwise the s=1
  decode step; here it agrees to float32 reassociation, so a stream
  equals the plain engine's wherever no step's top-2 margin falls inside
  that noise.
* Rejection is structural rollback, never a re-prefill: the round commits
  every window row and advances the frontier by the emitted count only;
  stale rows past the frontier are rewritten in view before any later
  window can see them, and the draft restarts its next run from the
  target's frontier.

fp32 pools only: an int8 pool would hand the verify window fresh fp32
k/v for in-window rows where the plain path reads the dequantized bytes
it committed a step earlier. The engine refuses int8.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from .. import telemetry
from ..models.layers import (
    paged_kv_bytes,
    scatter_paged_prefill,
    scatter_paged_window,
)
from .batching import Request, RequestQueue
from .continuous import ContinuousScheduler, SlotEngine, _inference
from .paged import PagedServeConfig, PageLease, PagePool


class SpeculativeEngine(SlotEngine):
    """`SlotEngine` plus a draft model and two more steps:

    * `draft_propose`: K+1 sequential draft decode steps over the draft
      pool (one gather, the steps in view, one window scatter back), K
      greedy proposals a slot. It reads the target's positions and tokens
      and keeps no control of its own, so rejection costs nothing: the
      next round starts from the target's frontier.
    * `verify_step`: the target's K+1-window forward, exact-match
      acceptance and the window commit, in place of `decode_step`;
      returns the per-slot emitted count, the one value the host reads a
      round.
    """

    def __init__(self, model, config: PagedServeConfig, params,
                 draft_model, draft_params, spec_k: int = 4, device=None):
        if config.kv_dtype != "fp32":
            raise ValueError(
                "speculative decoding needs an fp32 page pool: the verify "
                "window reads in-window rows as fresh fp32 where the "
                "plain int8 path reads dequantized page bytes — int8 "
                "speculation would change the emitted stream")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        super().__init__(model, config, params, device=device)
        self.spec_k = int(spec_k)
        self.draft_model = draft_model
        # the draft pool covers prompt + want + K positions a slot: the
        # last propose run of a request writes draft k/v up to
        # (n + want - 2) + K
        self.draft_config = dataclasses.replace(
            config, max_new_tokens=config.max_new_tokens + spec_k,
            kv_dtype="fp32", n_pages=0)
        if self.draft_padded_len > draft_model.max_position:
            raise ValueError(
                f"draft pages_per_slot * page_size = "
                f"{self.draft_padded_len} exceeds the draft model's "
                f"max_position {draft_model.max_position}")
        if getattr(draft_model, "vocab_size", None) != getattr(
                model, "vocab_size", None):
            raise ValueError(
                f"draft vocab {getattr(draft_model, 'vocab_size', None)} "
                f"!= target vocab {getattr(model, 'vocab_size', None)}: "
                "proposals are target-vocab token ids compared by exact "
                "match — the vocabularies must be the same table")
        self._draft_params = {name: p.detach().to(self.device)
                              for name, p in draft_params.items()}
        self.reset_draft_state()

    @property
    def draft_padded_len(self) -> int:
        cfg = self.draft_config
        return cfg.pages_per_slot * cfg.page_size

    def reset_state(self) -> None:
        super().reset_state()
        if hasattr(self, "draft_model"):   # the base __init__ calls us early
            self.reset_draft_state()

    @_inference
    def reset_draft_state(self) -> None:
        """A zeroed draft pool and an all-scratch draft table."""
        cfg = self.draft_config
        self._draft_pool = self.draft_model.init_paged_pool(
            cfg.total_pages, cfg.page_size, quantized=False,
            device=self.device)
        self._draft_table = np.zeros((cfg.rows, cfg.pages_per_slot),
                                     np.int32)
        self._draft_table_dev = torch.from_numpy(self._draft_table).to(
            self.device, torch.int64)
        self._proposals = torch.zeros((cfg.rows, self.spec_k),
                                      dtype=torch.int64, device=self.device)

    def draft_set_page_row(self, slot: int, row: np.ndarray) -> None:
        """`set_page_row` for the draft table."""
        self._draft_table[slot] = row
        self._draft_table_dev = torch.from_numpy(self._draft_table).to(
            self.device, torch.int64)

    def _draft_forward(self, ids: torch.Tensor, **kw):
        return torch.func.functional_call(self.draft_model,
                                          self._draft_params, (ids,), kw)

    # -- runtime entries -----------------------------------------------------

    @_inference
    def draft_admit(self, slot: int, tokens: np.ndarray) -> int:
        """Fill the slot's draft pages from the prompt (k/v only: no
        control, no sampling). Returns the bucket."""
        bucket, ids = self._prompt_ids(tokens)
        cache0 = self.draft_model.init_cache(1, bucket, device=self.device)
        _logits, cache = self._draft_forward(ids, cache=cache0)
        scatter_paged_prefill(self._draft_pool, self._draft_table_dev[slot],
                              torch.stack([c[0][0] for c in cache]),
                              torch.stack([c[1][0] for c in cache]),
                              len(tokens))
        return bucket

    @_inference
    def draft_propose(self) -> None:
        """One K-token propose round for every live slot; the proposals
        stay on the device for `verify_step`."""
        c = self._control
        positions, budget = c["positions"], c["budget"]
        rows, k_spec, dpad = positions.shape[0], self.spec_k, \
            self.draft_padded_len
        cache = self._dense_cache(self._draft_pool, self._draft_table_dev,
                                  self.draft_model)
        cur = c["tok"]
        props = []
        # K+1 steps for K proposals: the last only writes its k/v row. A
        # fully accepted round moves the frontier by K+1, and the next run
        # attends position p+K, so the draft cache must hold it
        for j in range(k_spec + 1):
            logits, cache = self._draft_forward(
                cur[:, None], cache=cache, cache_positions=positions + j)
            if j < k_spec:
                cur = torch.argmax(logits[:, 0], dim=-1)
                props.append(cur)
        dev = self.device
        win_pos = positions[:, None] + torch.arange(k_spec + 1,
                                                    device=dev)[None, :]
        idx = torch.clamp(win_pos, 0, dpad - 1)
        ridx = torch.arange(rows, device=dev)[:, None]
        scatter_paged_window(
            self._draft_pool, self._draft_table_dev, win_pos,
            torch.stack([k[ridx, idx] for k, _ in cache]),
            torch.stack([v[ridx, idx] for _, v in cache]),
            (budget > 0)[:, None] & (win_pos < dpad))
        self._proposals = torch.stack(props, dim=1)

    @_inference
    def verify_step(self) -> torch.Tensor:
        """One verify round over the whole slot pool. Returns the (rows,)
        emitted counts on the device; the scheduler fetches them once a
        round (the budget mirrors advance by them)."""
        c = self._control
        cfg: PagedServeConfig = self.config
        rows, s, pad, dev = cfg.rows, self.spec_k + 1, self.padded_len, \
            self.device
        active = c["budget"] > 0
        positions = c["positions"]
        # the window: the committed-next token plus the K proposals
        window = torch.cat([c["tok"][:, None], self._proposals], dim=1)
        cache = self._dense_cache(self._pool, self._table_dev, self.model)
        logits, new_cache = self._forward(
            self._params(), window, cache=cache, cache_positions=positions)
        # every window output sampled with its own position's key
        win_pos = positions[:, None] + torch.arange(s, device=dev)[None, :]
        outs = self._sample(
            logits.reshape(rows * s, -1),
            c["keys"].repeat_interleave(s, dim=0), (win_pos + 1).reshape(-1),
            c["temps"].repeat_interleave(s),
            c["top_ps"].repeat_interleave(s)).reshape(rows, s)
        # exact-match acceptance: the longest prefix of proposals equal to
        # the target's stream, plus the target's own next token, never
        # past the remaining budget
        match = (outs[:, :-1] == self._proposals).to(torch.int64)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)
        n_emit = torch.where(
            active, torch.minimum(n_acc + 1, c["budget"]),
            torch.zeros_like(n_acc))
        # commit all S window rows: rows past the new frontier hold a
        # rejected continuation, which every later reader rewrites in
        # view before its mask exposes it
        idx = torch.clamp(win_pos, 0, pad - 1)
        ridx = torch.arange(rows, device=dev)[:, None]
        scatter_paged_window(
            self._pool, self._table_dev, win_pos,
            torch.stack([k[ridx, idx] for k, _ in new_cache]),
            torch.stack([v[ridx, idx] for _, v in new_cache]),
            active[:, None] & (win_pos < pad))
        # outs[:n_emit] into out_buf at each slot's cursor
        out_buf = c["out_buf"]
        cols = torch.arange(out_buf.shape[1], device=dev)[None, :]
        for j in range(s):
            hit = (cols == (c["emitted"] + j)[:, None]) & \
                (j < n_emit)[:, None]
            out_buf = torch.where(hit, outs[:, j:j + 1], out_buf)
        last = torch.gather(outs, 1,
                            torch.clamp(n_emit - 1, 0, s - 1)[:, None])[:, 0]
        # skip-admitted slots capture their last-prompt logits off window
        # row 0, the plain step's last_pos protocol
        cap = positions == c["last_pos"]
        c["out_buf"] = out_buf
        c["last_buf"] = torch.where(cap[:, None], logits[:, 0],
                                    c["last_buf"])
        c["last_pos"] = torch.where(cap, -1, c["last_pos"])
        c["tok"] = torch.where(active, last, c["tok"])
        c["positions"] = positions + n_emit
        c["budget"] = c["budget"] - n_emit
        c["emitted"] = c["emitted"] + n_emit
        return n_emit

    def warmup(self) -> int:
        """`SlotEngine.warmup` plus a draft prefill per bucket and one
        propose + verify round, then a reset."""
        cfg: PagedServeConfig = self.config
        steps = super().warmup()
        for b in cfg.buckets:
            self.draft_admit(0, np.full(b, cfg.pad_id, np.int32))
            steps += 1
        self.draft_propose()
        self.verify_step()
        self.fence()
        self.reset_state()
        return steps + 2

    def draft_bytes(self) -> int:
        """At-rest bytes of the draft pool (fp32): the speculation's
        memory cost, beside the target pool's."""
        return paged_kv_bytes(self._draft_pool)


class SpeculativeScheduler(ContinuousScheduler):
    """`ContinuousScheduler` whose advance is one propose + verify round.

    Its three hooks manage the draft lease: a request is admitted only
    when both pools can hold it (`_draft_admit`: a failed draft lease
    rolls the target lease back and the request stays pending), the draft
    prefill runs right after the target admission lands (`_post_admit`),
    and completion releases the draft pages with the target's
    (`_post_complete`). Skip/resume admission, TTFT stamping, drain and
    kill are the base class's."""

    def __init__(self, engine: SpeculativeEngine, queue: RequestQueue):
        if not isinstance(engine, SpeculativeEngine):
            raise ValueError("SpeculativeScheduler needs a "
                             "SpeculativeEngine (draft model + verify "
                             "step); plain SlotEngines run under "
                             "ContinuousScheduler")
        super().__init__(engine, queue)
        dcfg = engine.draft_config
        # no prefix sharing in the draft pool: the draft always prefills
        # its own copy, so it can never change the target's residency
        self.draft_pool = PagePool(dcfg.total_pages, dcfg.page_size,
                                   dcfg.pages_per_slot,
                                   prefix_sharing=False)
        self._draft_leases: Dict[int, PageLease] = {}   # guarded-by: _lock
        self._draft_pending: Dict[int, PageLease] = {}  # guarded-by: _lock
        # acceptance census: proposals offered vs accepted
        self.spec_rounds = 0                            # guarded-by: _lock
        self.spec_proposed = 0                          # guarded-by: _lock
        self.spec_accepted = 0                          # guarded-by: _lock

    @property
    def accept_ratio(self) -> float:
        """Accepted draft tokens / proposed draft tokens, cumulative."""
        with self._lock:
            return (self.spec_accepted / self.spec_proposed
                    if self.spec_proposed else 0.0)

    # -- draft lease lifecycle (the base-class hooks) ------------------------

    def _draft_admit(self, req: Request, lease: PageLease,
                     want: int) -> bool:   # lock-held: _lock
        eng: SpeculativeEngine = self.engine
        dlease = self.draft_pool.alloc(
            req.tokens, len(req.tokens) + want + eng.spec_k)
        if dlease is None:
            return False
        self._draft_pending[req.id] = dlease
        return True

    def _post_admit(self, slot: int, req: Request) -> None:  # lock-held: _lock
        eng: SpeculativeEngine = self.engine
        dlease = self._draft_pending.pop(req.id)
        self._draft_leases[slot] = dlease
        eng.draft_set_page_row(slot, dlease.pages)
        t0 = time.perf_counter()
        bucket = eng.draft_admit(slot, req.tokens)
        telemetry.span_event("draft_decode", time.perf_counter() - t0,
                             prefill=True, bucket=bucket, slot=slot,
                             request=req.id)

    def _post_complete(self, slot: int) -> None:   # lock-held: _lock
        eng: SpeculativeEngine = self.engine
        dlease = self._draft_leases.pop(slot, None)
        if dlease is not None:
            self.draft_pool.release(dlease)
            eng.draft_set_page_row(
                slot, np.zeros(eng.draft_config.pages_per_slot, np.int32))

    # -- the speculative round -----------------------------------------------

    def _advance(self) -> None:   # lock-held: _lock
        """One propose + verify round: up to K+1 tokens a slot. Reading
        the emitted counts is the round's one host sync: they are host
        state (budget mirrors, completion)."""
        eng: SpeculativeEngine = self.engine
        live = len(self.running)
        t0 = time.perf_counter()
        eng.draft_propose()
        t1 = time.perf_counter()
        telemetry.span_event("draft_decode", t1 - t0, k=eng.spec_k,
                             slots=live)
        n_emit = eng.verify_step().cpu().numpy()
        t2 = time.perf_counter()
        telemetry.span_event("spec_verify", t2 - t1, slots=live)
        for slot, st in self.running.items():
            got = int(n_emit[slot])
            st.left = max(st.left - got, 0)
            # all but one of a round's tokens are accepted proposals (the
            # last is the target's own); a clamp to the budget still
            # counts as accepted
            self.spec_accepted += max(got - 1, 0)
        self.spec_proposed += eng.spec_k * live
        self.spec_rounds += 1
        if self.spec_proposed:
            # inline, not accept_ratio: that takes _lock, held here
            telemetry.gauge("spec_accept_ratio",
                            self.spec_accepted / self.spec_proposed)


def serve_speculative(engine: SpeculativeEngine, queue: RequestQueue,
                      stop, log=None) -> int:
    """The worker loop of the speculative scheduler."""
    return SpeculativeScheduler(engine, queue).run(stop, log=log)
