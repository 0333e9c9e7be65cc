"""The port's speculative decoding against the plain engines, on the CPU.

* Validation as the JAX package's: an int8 pool is refused with JAX's
  message, spec_k >= 1, the draft's vocab must be the target's, and the
  speculative scheduler refuses a plain engine.
* Streams: the speculative engine's streams (a smaller random draft, so
  proposals are accepted only sometimes) EQUAL the port's plain
  ``SlotEngine``'s at mixed temperatures, top_p, seeds and wants over 12
  requests and 8 slots, and the JAX package's plain ``SlotEngine``'s
  (whose own speculative engine is bitwise its plain one). Not bitwise
  logits: the verify window's rows agree with the s=1 decode step to
  float32 reassociation, so the pin is on tokens, which are equal here.
* An oracle draft (the target itself) accepts every proposal: two full
  rounds of K+1 tokens for a request of 1 + 2(K+1) tokens.
* Prefix skip composes with speculation; an exhausted draft pool
  throttles admission, and every request completes with nothing leaked.
* The router's mid-POST death drills (a truncated body, a chunk-boundary
  IncompleteRead) surface as ReplicaDead, and the seed-pinned resubmit
  lands on a survivor, with the traced lock order free of inversions.
* ``serving bench --continuous --draft`` (the draft takes the target's
  ``--model-overrides``) and ``--shared-frac`` on the CPU.
"""

import http.client
import threading
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_training_tpu.models.gpt2 import (
    GPT2LMHead as JaxGPT2,
)
from distributed_pytorch_training_tpu.serving.batching import (
    RequestQueue as JaxQueue,
)
from distributed_pytorch_training_tpu.serving.continuous import (
    ContinuousScheduler as JaxScheduler,
    SlotEngine as JaxSlotEngine,
)
from distributed_pytorch_training_tpu.serving.paged import (
    PagedServeConfig as JaxPagedConfig,
)
from distributed_pytorch_training_tpu_torch import telemetry
from distributed_pytorch_training_tpu_torch.convert import load_flax_params
from distributed_pytorch_training_tpu_torch.models import GPT2LMHead
from distributed_pytorch_training_tpu_torch.serving.__main__ import main
from distributed_pytorch_training_tpu_torch.serving.batching import (
    RequestQueue, Result,
)
from distributed_pytorch_training_tpu_torch.serving.continuous import (
    ContinuousScheduler, SlotEngine,
)
from distributed_pytorch_training_tpu_torch.serving.paged import (
    PagedServeConfig, PagePool,
)
from distributed_pytorch_training_tpu_torch.serving.router import (
    HttpReplica, InProcessReplica, ReplicaDead, Router,
)
from distributed_pytorch_training_tpu_torch.serving.speculative import (
    SpeculativeEngine, SpeculativeScheduler,
)
from distributed_pytorch_training_tpu_torch.utils import locktrace

from _torch_rig import port_process_state  # noqa: F401  (autouse)

VOCAB = 97
SPEC_K = 3
TINY = dict(vocab_size=VOCAB, hidden_dim=32, depth=2, num_heads=2,
            max_position=64)
WAIT_S = 120.0


def cfg(**kw):
    c = dict(buckets=(8, 16), rows=8, max_new_tokens=6, page_size=4)
    c.update(kw)
    return c


def params_of(model):
    return dict(model.named_parameters())


@pytest.fixture(scope="module")
def tiny(mesh8):
    jm = JaxGPT2(**TINY)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
                     train=False)["params"]
    tm = GPT2LMHead(**TINY)
    load_flax_params(tm, jax.device_get(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def draft():
    """A smaller draft (1 block, hidden 16) with its own random init: its
    proposals match the target's stream only sometimes."""
    dm = GPT2LMHead(**dict(TINY, hidden_dim=16, depth=1))
    dm.reset_parameters(torch.Generator().manual_seed(7))
    return dm


@pytest.fixture(scope="module")
def spec_engine(tiny, draft):
    return SpeculativeEngine(tiny[2], PagedServeConfig(**cfg()),
                             params_of(tiny[2]), draft, params_of(draft),
                             spec_k=SPEC_K, device="cpu")


@pytest.fixture(scope="module")
def plain_engine(tiny):
    return SlotEngine(tiny[2], PagedServeConfig(**cfg()), params_of(tiny[2]),
                      device="cpu")


def drain(sched):
    """``sched.drain()`` on its own thread, bounded by WAIT_S."""
    worker = threading.Thread(target=sched.drain, daemon=True)
    worker.start()
    worker.join(WAIT_S)
    assert not worker.is_alive(), "the scheduler did not drain"


def prompts(ns, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype(np.int32) for n in ns]


def serve_all(engine, specs, sched_cls=None, queue_cls=RequestQueue):
    if sched_cls is None:
        sched_cls = (SpeculativeScheduler
                     if isinstance(engine, SpeculativeEngine)
                     else ContinuousScheduler)
    engine.reset_state()
    q = queue_cls(engine.config.buckets)
    sched = sched_cls(engine, q)
    reqs = [q.submit(toks, **kw) for toks, kw in specs]
    drain(sched)
    return sched, [r.result(timeout=WAIT_S) for r in reqs]


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def test_int8_pool_refused(tiny, draft):
    with pytest.raises(ValueError, match="needs an fp32 page pool"):
        SpeculativeEngine(tiny[2], PagedServeConfig(**cfg(kv_dtype="int8")),
                          params_of(tiny[2]), draft, params_of(draft),
                          spec_k=SPEC_K, device="cpu")


def test_spec_k_floor_and_vocab_mismatch(tiny, draft):
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeEngine(tiny[2], PagedServeConfig(**cfg()),
                          params_of(tiny[2]), draft, params_of(draft),
                          spec_k=0, device="cpu")
    other = GPT2LMHead(**dict(TINY, vocab_size=31, hidden_dim=16, depth=1))
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(tiny[2], PagedServeConfig(**cfg()),
                          params_of(tiny[2]), other, params_of(other),
                          spec_k=SPEC_K, device="cpu")


def test_scheduler_refuses_plain_engine(plain_engine):
    with pytest.raises(ValueError, match="SpeculativeEngine"):
        SpeculativeScheduler(plain_engine,
                             RequestQueue(plain_engine.config.buckets))


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


def mixed_specs(seed=3, n=12):
    rng = np.random.RandomState(seed)
    seqs = prompts([int(rng.randint(1, 17)) for _ in range(n)], seed + 1)
    return [(s, dict(temperature=float(rng.choice([0.0, 0.7, 1.0])),
                     top_p=float(rng.choice([0.9, 1.0])), seed=100 + i,
                     max_new_tokens=int(rng.randint(1, 7))))
            for i, s in enumerate(seqs)]


def test_mixed_streams_equal_the_plain_engines(mesh8, tiny, spec_engine,
                                               plain_engine):
    specs = mixed_specs()
    sched, spec = serve_all(spec_engine, specs)
    _, plain = serve_all(plain_engine, specs)
    jm, params, _ = tiny
    _, ref = serve_all(JaxSlotEngine(jm, mesh8, JaxPagedConfig(**cfg()),
                                     params), specs, JaxScheduler, JaxQueue)
    assert sched.spec_rounds > 0 and sched.spec_proposed > 0
    for i, (a, b, c) in enumerate(zip(spec, plain, ref)):
        np.testing.assert_array_equal(a.tokens, b.tokens,
                                      err_msg=f"request {i} {specs[i][1]}")
        np.testing.assert_array_equal(a.tokens, c.tokens,
                                      err_msg=f"request {i} {specs[i][1]}")


def test_oracle_draft_accepts_every_proposal(tiny):
    tm = tiny[2]
    want = 1 + 2 * (SPEC_K + 1)
    eng = SpeculativeEngine(tm, PagedServeConfig(**cfg(
        buckets=(16,), rows=2, max_new_tokens=want)), params_of(tm), tm,
        params_of(tm), spec_k=SPEC_K, device="cpu")
    specs = [(p, {}) for p in prompts((9, 14), seed=6)]
    sched, res = serve_all(eng, specs)
    _, plain = serve_all(SlotEngine(tm, PagedServeConfig(**cfg(
        buckets=(16,), rows=2, max_new_tokens=want)), params_of(tm),
        device="cpu"), specs)
    assert sched.spec_rounds == 2
    assert sched.spec_accepted == sched.spec_proposed == 2 * 2 * SPEC_K
    assert sched.accept_ratio == 1.0
    for a, b in zip(res, plain):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_skip_composes_with_speculation(spec_engine, plain_engine):
    (p,) = prompts((16,), seed=10)
    spec_engine.reset_state()
    rec = telemetry.configure()
    try:
        replica = InProcessReplica("r0", spec_engine)
        res = [replica.submit(p).result(timeout=WAIT_S) for _ in range(2)]
        replica.stop()
        events = rec.tail(10_000)
    finally:
        telemetry.reset()
    sched = replica.scheduler
    assert isinstance(sched, SpeculativeScheduler)
    assert sched.prefill_skips == 1 and sched.spec_rounds > 0
    assert len([e for e in events if e["kind"] == "span"
                and e["name"] == "prefill"]) == 1
    _, (cold,) = serve_all(plain_engine, [(p, {})])
    for r in res:
        np.testing.assert_array_equal(r.tokens, cold.tokens)
        assert int(np.argmax(r.last_logits)) == int(r.tokens[0])


def test_exhausted_draft_pool_throttles_and_completes(spec_engine,
                                                      plain_engine):
    spec_engine.reset_state()
    q = RequestQueue(spec_engine.config.buckets)
    sched = SpeculativeScheduler(spec_engine, q)
    dcfg = spec_engine.draft_config
    sched.draft_pool = PagePool(2 * dcfg.pages_per_slot + 1, dcfg.page_size,
                                dcfg.pages_per_slot, prefix_sharing=False)
    free0 = sched.draft_pool.free_pages()
    seqs = prompts((5, 9, 13, 7, 11, 6), seed=21)
    reqs = [q.submit(s) for s in seqs]
    drain(sched)
    _, plain = serve_all(plain_engine, [(s, {}) for s in seqs])
    for r, b in zip(reqs, plain):
        np.testing.assert_array_equal(r.result(timeout=WAIT_S).tokens,
                                      b.tokens)
    assert sched.draft_pool.free_pages() == free0


# ---------------------------------------------------------------------------
# The router's mid-POST death
# ---------------------------------------------------------------------------


class _FakeResp:
    """A urlopen context manager serving a scripted body."""

    status = 200

    def __init__(self, chunks, content_length=None, raise_mid=False):
        self._chunks = list(chunks)
        self.headers = ({"Content-Length": str(content_length)}
                        if content_length is not None else {})
        self._raise_mid = raise_mid

    def read(self, n):
        if not self._chunks:
            if self._raise_mid:
                raise http.client.IncompleteRead(b"", 64)
            return b""
        return self._chunks.pop(0)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _StubReplica:
    def __init__(self, name, depth=0):
        self.name, self.depth = name, depth
        self.submits = []

    def healthy(self):
        return True

    def queue_depth(self):
        return self.depth

    def submit(self, tokens, **kw):
        self.submits.append(kw)

        class _P:
            def result(self, timeout=None):
                return Result(tokens=np.arange(3, dtype=np.int32),
                              last_logits=np.zeros(VOCAB, np.float32))
        return _P()


@pytest.mark.parametrize("resp", [
    dict(chunks=[b'{"tokens": [1, 2'], content_length=4096),
    dict(chunks=[b'{"tok'], content_length=4096, raise_mid=True),
], ids=["truncated-body", "chunk-boundary"])
def test_half_a_response_is_replica_dead(resp, monkeypatch):
    replica = HttpReplica("h", port=1)
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda *a, **kw: _FakeResp(**resp))
    with pytest.raises(ReplicaDead, match="died mid-response"):
        replica.submit(np.ones(3, np.int32)).result(timeout=1.0)
    assert not replica.healthy()


def test_mid_post_death_reroutes_with_pinned_seed(monkeypatch):
    monkeypatch.setenv("DPT_LOCKCHECK", "1")
    locktrace.trace().reset()
    dying = HttpReplica("h", port=1)
    survivor = _StubReplica("s", depth=1)   # depth: h wins the dispatch
    monkeypatch.setattr(
        urllib.request, "urlopen",
        lambda *a, **kw: _FakeResp([b'{"tokens": [9'], content_length=4096))
    router = Router([dying, survivor])
    req = router.submit(np.ones(4, np.int32))
    assert req.replica_name == "h"
    seed = req.kw["seed"]
    res = req.result(timeout=5.0)
    assert req.replica_deaths == 1 and req.replica_name == "s"
    assert survivor.submits[-1]["seed"] == seed
    np.testing.assert_array_equal(res.tokens, np.arange(3, dtype=np.int32))
    # no lock-order inversion across the router's and the queues' locks
    edges = locktrace.trace().order_edges()
    assert not {(b, a) for a, b in edges} & edges


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--draft", "gpt2_124m", "--draft-k", "3"],
    ["--shared-frac", "0.5"],
], ids=["draft", "shared-frac"])
def test_cli_bench_continuous_draft_and_shared_frac(extra, capsys,
                                                    tmp_path):
    assert main(["bench", "--continuous", "--device", "cpu", "--json",
                 "--model-overrides",
                 "vocab_size=64,hidden_dim=32,depth=2,num_heads=2",
                 "--buckets", "8,16", "--rows", "4", "--max-new-tokens",
                 "4", "--requests", "10", "--offered-load", "64",
                 "--output-dir", str(tmp_path)] + extra) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["completed"] == 10
    if "--draft" in extra:
        assert row["draft"] == "gpt2_124m" and row["spec_rounds"] > 0
        assert 0.0 <= row["accept_ratio"] <= 1.0
        assert row["draft_kv_bytes"] > 0 and row["backend"] == "cpu"
    else:
        assert row["prefill_skips"] >= 1
        assert "ttft_warm_p50_ms" in row and "ttft_cold_p50_ms" in row
