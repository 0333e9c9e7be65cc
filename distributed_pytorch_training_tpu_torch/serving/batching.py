"""Request queue + batch assembly for the inference engine.

* ``RequestQueue`` is the thread-safe front door. Producers ``submit``
  token prompts and block on the returned ``Request`` until the engine
  fills its result.
* ``next_batch`` drains the queue into ONE bucket-compatible group: the
  oldest request picks the bucket (``data.pack.bucket_for``), and every
  queued request that fits the same rung rides along, up to the engine's
  row budget. A request never waits for a "full" batch, and a long prompt
  never blocks a burst of short ones behind a shape it does not share.
* ``serve_forever`` is the engine worker loop the CLI runs on a thread:
  pop a group, ``engine.serve_tokens`` it, fill results, repeat; on stop,
  drain: finish everything already queued, refuse new work.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, List, Optional, Sequence

import numpy as np

from ..data.pack import bucket_for


@dataclasses.dataclass
class Result:
    """What the engine hands back for one request."""

    tokens: np.ndarray        # (n_generated,) int32 greedy continuation
    last_logits: np.ndarray   # (vocab,) fp32 logits at the last prompt token
    prompt_logits: Optional[np.ndarray] = None  # (len, vocab) when requested
    bucket: int = 0
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0


class Request:
    """One submitted prompt; waitable. ``result()`` blocks until the engine
    (or a drain-time rejection) resolves it."""

    _ids = iter(range(1, 1 << 62))   # guarded-by: _ids_lock
    _ids_lock = threading.Lock()

    def __init__(self, tokens: np.ndarray,
                 return_prompt_logits: bool = False):
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or tokens.size == 0:
            raise ValueError(
                f"a request is a non-empty 1-D token array, got shape "
                f"{tokens.shape}")
        with Request._ids_lock:
            self.id = next(Request._ids)
        self.tokens = tokens
        self.return_prompt_logits = return_prompt_logits
        self.t_submit = time.perf_counter()
        # _result/_error are Event-synchronized: exactly one resolver
        # writes them, then _done.set() publishes
        self._done = threading.Event()
        self._result: Optional[Result] = None
        self._error: Optional[BaseException] = None

    def set_result(self, result: Result) -> None:
        self._result = result
        self._done.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> Result:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} still pending")
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise RuntimeError(f"request {self.id} resolved without a result")
        return self._result


class RequestQueue:
    """Thread-safe FIFO of pending requests with bucket-aware draining."""

    def __init__(self, buckets: Sequence[int]):
        if not buckets:
            raise ValueError("the bucket ladder must have at least one rung")
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self._q: Deque[Request] = collections.deque()   # guarded-by: _cv
        self._cv = threading.Condition()
        self._closed = False                            # guarded-by: _cv

    def __len__(self) -> int:
        with self._cv:
            return len(self._q)

    def submit(self, tokens: np.ndarray,
               return_prompt_logits: bool = False) -> Request:
        """Enqueue one prompt. Raises on a closed (draining) queue and on
        prompts no bucket fits."""
        req = Request(tokens, return_prompt_logits=return_prompt_logits)
        bucket_for(len(req.tokens), self.buckets)  # validate: raises if huge
        with self._cv:
            if self._closed:
                raise RuntimeError(
                    "request queue is closed (draining for shutdown)")
            self._q.append(req)
            self._cv.notify()
        return req

    def close(self) -> None:
        """Refuse new submissions; queued requests stay servable (drain)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def next_batch(self, max_rows: int,
                   timeout: Optional[float] = 0.05) -> List[Request]:
        """Pop the next bucket-compatible group (<= max_rows requests).

        The OLDEST pending request picks the bucket; younger requests join
        iff they fit the same rung, in queue order. Returns [] on timeout
        or when the queue is closed and empty (the drain-finished signal).
        """
        with self._cv:
            if not self._q:
                if self._closed:
                    return []
                self._cv.wait(timeout)
            if not self._q:
                return []
            head = self._q.popleft()
            bucket = bucket_for(len(head.tokens), self.buckets)
            group = [head]
            keep: List[Request] = []
            while self._q and len(group) < max_rows:
                req = self._q.popleft()
                if bucket_for(len(req.tokens), self.buckets) == bucket:
                    group.append(req)
                else:
                    keep.append(req)
            # non-matching requests keep their queue order at the FRONT
            self._q.extendleft(reversed(keep))
        return group


def serve_forever(engine, queue: RequestQueue,
                  stop: threading.Event, log=None) -> int:
    """The engine worker loop: drain the queue through the engine until
    ``stop`` is set AND the queue is empty (stop means drain, not abandon).
    Returns the number of requests served. A failed batch fails exactly its
    own requests (their ``result()`` re-raises); the loop itself survives.
    """
    served = 0
    while True:
        if stop.is_set():
            queue.close()
        group = queue.next_batch(engine.config.rows)
        if not group:
            if stop.is_set() and not len(queue):
                return served
            continue
        try:
            results = engine.serve_tokens(
                [r.tokens for r in group],
                return_prompt_logits=any(r.return_prompt_logits
                                         for r in group))
            now = time.perf_counter()
            for req, res in zip(group, results):
                res.queue_wait_s = max(0.0, now - req.t_submit
                                       - res.prefill_s - res.decode_s)
                req.set_result(res)
            served += len(group)
        except Exception as e:  # noqa: BLE001 - fail the batch, not the loop
            if log is not None:
                log(f"serving: batch of {len(group)} failed: "
                    f"{type(e).__name__}: {e}")
            for req in group:
                req.set_error(e)


def drain(engine, queue: RequestQueue, log=None) -> int:
    """Serve everything still queued, then return (the SIGTERM path)."""
    stop = threading.Event()
    stop.set()
    return serve_forever(engine, queue, stop, log=log)
