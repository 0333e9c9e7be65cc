"""Paged KV cache: the host-side page allocator + serving config (the JAX
package's serving/paged.py; numpy and the standard library only).

The HBM ceiling of the dense engine is its cache SHAPE: (rows,
bucket + max_new, heads, head_dim) per block, live for every slot whether
it serves a request or not, fp32 always. The paged cache breaks the shape
into fixed-size pages (models/layers.py `PagedKV`) and makes residency a
host-side ALLOCATION decision:

* **PagePool** is the allocator: a free list over physical pages 1..N-1
  (page 0 is the scratch page every unmapped table entry points at), with
  per-page refcounts so one physical page can back many slots.
* **Prefix sharing**: pages wholly covered by a prompt are keyed by the
  cumulative prefix hash (``data.pack.prompt_page_hashes``) — a request
  repeating an earlier prompt's prefix maps the SAME physical pages
  instead of recomputing/rewriting them. Safe by construction: identical
  weights + identical token prefix give bitwise-identical k/v, and the
  compiled prefill rewrites a shared page only with its own bytes, while
  decode writes always land past the last fully-covered prompt page.
* **Eviction**: a released prefix page keeps its hash and parks in an LRU
  retention list (refcount 0, still reusable); when the free list runs
  dry, the oldest retained page is evicted — its hash is forgotten and
  the page returns to general circulation. Allocation fails (request
  stays queued) only when free + evictable together cannot cover a
  request.
* **Byte accounting**: ``paged_kv_bytes`` vs ``dense_kv_bytes``
  (models/layers.py) is the bench's memory story — int8 pages store 1
  byte per element + one fp32 scale per (page, position, head) row, a
  >= 3x cut against the dense fp32 cache at the same config.

Quantization rides the SAME per-row int8 grid as the gradient wire (K1,
``ops/quantize.py::quantize_int8_rows``), so the exactness story is the
wire codec's: deterministic, bounded, and replica-identical — every
replica quantizes the same values to the same codes.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.pack import prompt_page_hashes
from ..utils.locktrace import named_lock
from .engine import ServeConfig

KV_DTYPES = ("fp32", "int8")


@dataclasses.dataclass
class PagedServeConfig(ServeConfig):
    """`ServeConfig` plus the paged-cache knobs (serving/continuous.py).

    ``rows`` is the SLOT count of the continuous engine — the static row
    dimension of the one compiled decode step requests join and leave at
    token granularity. ``n_pages=0`` sizes the pool so every slot can hold
    a full (max bucket + max_new_tokens) context with no sharing — the
    fail-safe floor; smaller pools lean on prefix sharing + eviction,
    larger ones retain more shared prefixes.
    """

    page_size: int = 16
    n_pages: int = 0
    kv_dtype: str = "fp32"
    prefix_sharing: bool = True
    # Prefix-resident admission: when a prompt's leading pages
    # are already resident (prefix sharing mapped them), admission skips
    # the prefill dispatch — fully resident prompts go straight into
    # decode at the resumed position, partially resident ones prefill
    # only the fresh tail. fp32 pools only: the skip path's token #0
    # reads the dequantized pages where the cold prefill reads fresh
    # fp32, so an int8 skip could emit a different stream on a resident
    # vs cold replica and break the router's same-seed-retry invariant
    # (serving/continuous.py applies the gate).
    prefix_skip: bool = True
    # The JAX package's fused-quantize tri-state, kept so that configs
    # compare equal. Here it selects nothing: the pool's device does (K1
    # on a CUDA tensor, its plain version on the CPU; bitwise alike).
    fused_quantize: Optional[bool] = None

    def __post_init__(self):
        super().__post_init__()
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} is not one of "
                             f"{KV_DTYPES}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, "
                             f"got {self.page_size}")

    @property
    def cache_len(self) -> int:
        return max(self.buckets) + self.max_new_tokens

    @property
    def pages_per_slot(self) -> int:
        return -(-self.cache_len // self.page_size)

    @property
    def total_pages(self) -> int:
        """Physical pool size: the configured ``n_pages`` or the fail-safe
        floor (every slot fully resident, plus scratch page 0)."""
        floor = self.rows * self.pages_per_slot + 1
        return max(int(self.n_pages), floor) if self.n_pages else floor


@dataclasses.dataclass
class PageLease:
    """One slot's page holding: which table entries are real allocations
    (vs scratch), and which of them are shared prefix pages."""

    pages: np.ndarray          # (pages_per_slot,) int32, scratch-padded
    n_pages: int               # real entries: pages[:n_pages]
    shared: List[int] = dataclasses.field(default_factory=list)


class PagePool:
    """Thread-safe page allocator with refcounts, prefix sharing, and LRU
    eviction of retained prefix pages. Page ids are HOST integers — the
    device only ever sees the (rows, pages_per_slot) int32 table the
    scheduler assembles from leases."""

    def __init__(self, n_pages: int, page_size: int,
                 pages_per_slot: int, prefix_sharing: bool = True):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (scratch + 1), "
                             f"got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.prefix_sharing = bool(prefix_sharing)
        self._lock = named_lock("PagePool._lock")
        self._free: List[int] = list(range(1, self.n_pages))   # guarded-by: _lock
        self._ref: Dict[int, int] = {}                         # guarded-by: _lock
        self._by_hash: Dict[str, int] = {}                     # guarded-by: _lock
        self._hash_of: Dict[int, str] = {}                     # guarded-by: _lock
        # refcount-0 prefix pages, oldest first — the eviction queue
        self._retained: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()                          # guarded-by: _lock
        self.evictions = 0                                     # guarded-by: _lock
        self.prefix_hits = 0                                   # guarded-by: _lock

    # -- internals (lock held) ----------------------------------------------

    def _take_page(self) -> Optional[int]:   # lock-held: _lock
        if self._free:
            return self._free.pop()
        if self._retained:  # evict the LRU retained prefix page
            page, _ = self._retained.popitem(last=False)
            h = self._hash_of.pop(page, None)
            if h is not None:
                self._by_hash.pop(h, None)
            self.evictions += 1
            return page
        return None

    def _release_page(self, page: int) -> None:   # lock-held: _lock
        self._ref[page] -= 1
        if self._ref[page] > 0:
            return
        del self._ref[page]
        if page in self._hash_of:   # keep the prefix warm, evictable
            self._retained[page] = None
            self._retained.move_to_end(page)
        else:
            self._free.append(page)

    # -- the allocator API --------------------------------------------------

    def alloc(self, tokens: Sequence[int],
              n_positions: int) -> Optional[PageLease]:
        """Lease pages covering positions [0, n_positions) for a request
        whose prompt is ``tokens``: shared prefix pages first (refcount
        bump, no write needed beyond the idempotent rewrite), fresh pages
        for the rest. None when the pool cannot cover the request — the
        caller keeps it queued (admission control, not an error)."""
        need = -(-int(n_positions) // self.page_size)
        if need > self.pages_per_slot:
            raise ValueError(
                f"{n_positions} positions need {need} pages, over the "
                f"table's {self.pages_per_slot} per slot")
        hashes = (prompt_page_hashes(tokens, self.page_size)
                  if self.prefix_sharing else [])
        with self._lock:
            pages: List[int] = []
            shared: List[int] = []
            for h in hashes[:need]:
                page = self._by_hash.get(h)
                if page is None:
                    break   # prefix diverges from here on: fresh pages
                # claim AT MATCH TIME: refcount bump + unpark, so a dry
                # free list can never evict a just-matched refcount-0
                # retained page and re-lease it as a fresh page (the
                # same physical page at two logical offsets would let
                # the prefill scatter corrupt the shared prefix)
                self._ref[page] = self._ref.get(page, 0) + 1
                self._retained.pop(page, None)  # leased: not evictable
                pages.append(page)
                shared.append(page)
            fresh_start = len(pages)
            ok = True
            for i in range(fresh_start, need):
                page = self._take_page()
                if page is None:
                    ok = False
                    break
                pages.append(page)
            if not ok:      # roll back: nothing leased on failure
                for page in pages[fresh_start:]:
                    self._free.append(page)
                for page in shared:
                    self._release_page(page)  # re-parks retained prefixes
                return None
            for page in pages[fresh_start:]:
                self._ref[page] = self._ref.get(page, 0) + 1
            self.prefix_hits += len(shared)
            # register the fresh fully-covered prompt pages for future
            # sharing (the tail/decode pages carry no hash by design)
            for i in range(fresh_start, min(len(hashes), need)):
                h, page = hashes[i], pages[i]
                if h not in self._by_hash:
                    self._by_hash[h] = page
                    self._hash_of[page] = h
            row = np.zeros(self.pages_per_slot, np.int32)
            row[:need] = pages
            return PageLease(pages=row, n_pages=need, shared=shared)

    def release(self, lease: PageLease) -> None:
        """Return a lease's pages: refcounts drop; prefix pages park in
        the LRU retention queue, anonymous pages go straight to free."""
        with self._lock:
            for page in lease.pages[:lease.n_pages]:
                self._release_page(int(page))

    def rollback(self, lease: PageLease) -> None:
        """Undo an alloc whose admission ABORTED before any prefill
        dispatched (e.g. the draft pool refused its half). The lease's
        FRESH pages were hash-registered for sharing at alloc time but
        never written — a later identical prompt matching them would
        skip-admit onto garbage, so their hashes must be forgotten here.
        Pages this alloc matched as shared were written by an earlier
        admission and just release normally."""
        shared = set(map(int, lease.shared))
        with self._lock:
            for page in map(int, lease.pages[:lease.n_pages]):
                if page not in shared:
                    h = self._hash_of.pop(page, None)
                    if h is not None:
                        self._by_hash.pop(h, None)
                self._release_page(page)

    # -- observability -------------------------------------------------------

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free) + len(self._retained)

    def stats(self) -> dict:
        with self._lock:
            return {
                "n_pages": self.n_pages,
                "free": len(self._free),
                "retained": len(self._retained),
                "leased": len(self._ref),
                "shared_hashes": len(self._by_hash),
                "prefix_hits": self.prefix_hits,
                "evictions": self.evictions,
            }
