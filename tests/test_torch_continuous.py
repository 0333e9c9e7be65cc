"""The port's continuous serving (slot engine, scheduler, router, CLI)
against the JAX package's, on the CPU.

Against the JAX ``SlotEngine`` (tiny GPT-2, the JAX init converted; the
same requests through a fresh scheduler on each side):

* greedy streams over mixed prompt lengths and per-request wants, with
  requests joining and leaving the running batch (10 requests over 8
  slots), EQUAL token for token; ``last_logits`` within ATOL (not
  bitwise: float32 reassociation between torch's and XLA's products, as
  in test_torch_serving.py; the JAX package's own decode-vs-full bitwise
  pins fail on this tree);
* sampled streams (temperatures 0.7 and 1.0, top_p 0.9 and 1.0, seeded
  per request) EQUAL: the port draws from jax.random's key stream;
* the int8 pool: greedy streams EQUAL, ``last_logits`` within ATOL.

In-package contracts: a stream ignores its slot, its join order and its
batch company; distinct seeds diverge; int8 pages cut the KV bytes >= 3x
at head_dim 32 and quantize deterministically; prefix-resident admission
(skip, tail resume) gives the cold prefill's stream; the scheduler's kill
resolves each request exactly once, the mid-step kill landing through a
deterministic hook; a replica death behind the router is invisible in
the streams; the spans and gauges are emitted; the router units as JAX's
``TestRouterUnits``; ``serving bench [--continuous]`` and a ``serving
serve`` process on the CPU. Every wait has its own timeout.
"""

import json
import queue as queue_mod
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

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
from distributed_pytorch_training_tpu_torch.serving import batching
from distributed_pytorch_training_tpu_torch.serving.__main__ import main
from distributed_pytorch_training_tpu_torch.serving.batching import (
    RequestQueue, Result,
)
from distributed_pytorch_training_tpu_torch.serving.continuous import (
    ContinuousScheduler, SlotEngine,
)
from distributed_pytorch_training_tpu_torch.serving.paged import (
    PagedServeConfig,
)
from distributed_pytorch_training_tpu_torch.serving.router import (
    HttpReplica, InProcessReplica, ReplicaDead, Router,
)

from _torch_rig import port_process_state  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
ATOL = RTOL = 1e-5
VOCAB = 97
TINY = dict(vocab_size=VOCAB, hidden_dim=32, depth=2, num_heads=2,
            max_position=64)
TINY_OVERRIDES = "vocab_size=97,hidden_dim=32,depth=2,num_heads=2"
WAIT_S = 120.0


def paged_kw(**kw):
    cfg = dict(buckets=(8, 16), rows=8, max_new_tokens=6, page_size=4)
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def tiny(mesh8):
    jm = JaxGPT2(**TINY)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
                     train=False)["params"]
    tm = GPT2LMHead(**TINY)
    load_flax_params(tm, jax.device_get(params))
    return jm, params, tm


def port_engine(tm, **kw):
    return SlotEngine(tm, PagedServeConfig(**paged_kw(**kw)),
                      dict(tm.named_parameters()), device="cpu")


@pytest.fixture(scope="module")
def engines(mesh8, tiny):
    """(JAX SlotEngine, port SlotEngine) at fp32; the JAX one compiles
    lazily, on first use."""
    jm, params, tm = tiny
    return (JaxSlotEngine(jm, mesh8, JaxPagedConfig(**paged_kw()), params),
            port_engine(tm))


def drain(sched):
    """``sched.drain()`` on its own thread, bounded by WAIT_S."""
    worker = threading.Thread(target=sched.drain, daemon=True)
    worker.start()
    worker.join(WAIT_S)
    assert not worker.is_alive(), "the scheduler did not drain"


def prompts(ns, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype(np.int32) for n in ns]


def serve_all(engine, specs, queue_cls=RequestQueue,
              sched_cls=ContinuousScheduler):
    """Reset the engine, push every (tokens, kw) spec through a fresh
    scheduler, drain, and return the Results in submission order."""
    engine.reset_state()
    q = queue_cls(engine.config.buckets)
    sched = sched_cls(engine, q)
    reqs = [q.submit(toks, **kw) for toks, kw in specs]
    drain(sched)
    return [r.result(timeout=WAIT_S) for r in reqs]


def serve_jax(engine, specs):
    return serve_all(engine, specs, JaxQueue, JaxScheduler)


def mixed_specs(seed, n=10, sampled=False):
    rng = np.random.RandomState(seed)
    seqs = prompts([int(rng.randint(1, 17)) for _ in range(n)], seed + 1)
    specs = []
    for i, s in enumerate(seqs):
        kw = dict(max_new_tokens=int(rng.randint(1, 7)), seed=100 + i)
        if sampled:
            kw.update(temperature=float(rng.choice([0.0, 0.7, 1.0])),
                      top_p=float(rng.choice([0.9, 1.0])))
        specs.append((s, kw))
    return specs


def assert_same_streams(mine, ref, specs):
    for i, (a, b, (s, kw)) in enumerate(zip(mine, ref, specs)):
        assert a.tokens.shape == (kw.get("max_new_tokens", 6),)
        np.testing.assert_array_equal(a.tokens, b.tokens,
                                      err_msg=f"request {i} ({kw})")
        np.testing.assert_allclose(a.last_logits, b.last_logits,
                                   atol=ATOL, rtol=RTOL)
        assert a.bucket == b.bucket


# ---------------------------------------------------------------------------
# The port against the JAX SlotEngine
# ---------------------------------------------------------------------------


def test_greedy_join_leave_streams_equal_jax(engines):
    jax_engine, port = engines
    specs = mixed_specs(1)
    assert_same_streams(serve_all(port, specs), serve_jax(jax_engine, specs),
                        specs)


def test_sampled_streams_equal_jax(engines):
    jax_engine, port = engines
    specs = mixed_specs(2, sampled=True)
    assert any(kw.get("temperature") for _, kw in specs)
    assert_same_streams(serve_all(port, specs), serve_jax(jax_engine, specs),
                        specs)


def test_int8_pages_streams_equal_jax(mesh8, tiny):
    jm, params, tm = tiny
    kw = paged_kw(buckets=(16,), kv_dtype="int8")
    jax_engine = JaxSlotEngine(jm, mesh8, JaxPagedConfig(**kw), params)
    port = SlotEngine(tm, PagedServeConfig(**kw),
                      dict(tm.named_parameters()), device="cpu")
    assert port._pool.quantized
    specs = mixed_specs(3)
    assert_same_streams(serve_all(port, specs), serve_jax(jax_engine, specs),
                        specs)


# ---------------------------------------------------------------------------
# In-package contracts
# ---------------------------------------------------------------------------


def test_stream_ignores_slot_order_and_company(engines):
    _, port = engines
    (target,) = prompts((7,), seed=10)
    t_kw = dict(temperature=0.8, top_p=0.9, seed=1234, max_new_tokens=6)
    decoys_a = [(s, dict(temperature=1.0, seed=50 + i,
                         max_new_tokens=3 + i % 4))
                for i, s in enumerate(prompts((5, 12, 3, 9, 15, 6, 4),
                                              seed=11))]
    decoys_b = [(s, dict(temperature=0.0, max_new_tokens=2 + i % 5))
                for i, s in enumerate(prompts((14, 2, 8, 10), seed=12))]
    alone = serve_all(port, [(target, t_kw)])[0]
    last = serve_all(port, decoys_a + [(target, t_kw)])[-1]
    first = serve_all(port, [(target, t_kw)] + decoys_b)[0]
    np.testing.assert_array_equal(alone.tokens, last.tokens)
    np.testing.assert_array_equal(alone.tokens, first.tokens)


def test_distinct_seeds_diverge(engines):
    _, port = engines
    (s,) = prompts((8,), seed=13)
    kw = dict(temperature=1.0, top_p=1.0, max_new_tokens=6)
    a, b = serve_all(port, [(s, dict(seed=1, **kw)), (s, dict(seed=2, **kw))])
    assert not np.array_equal(a.tokens, b.tokens)


def test_int8_pages_cut_bytes_3x_and_are_deterministic(tiny):
    # head_dim 32: the per-(row, head) fp32 scale amortizes over the head
    # (at head_dim 16 it costs a quarter, ~2.9x, as in the JAX test)
    tm = GPT2LMHead(**dict(TINY, hidden_dim=64))
    eng = port_engine(tm, buckets=(16,), kv_dtype="int8")
    assert eng.dense_baseline_bytes() / eng.paged_bytes() >= 3.0
    specs = [(s, {}) for s in prompts((6, 11, 4), seed=14)]
    first, second = serve_all(eng, specs), serve_all(eng, specs)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.last_logits, b.last_logits)


def serve_in_order(engine, prompt_list):
    """One replica, each result awaited before the next submit, so later
    prompts see the residency earlier ones registered; returns (scheduler,
    results, telemetry events)."""
    engine.reset_state()
    rec = telemetry.configure()          # ring-only stream
    try:
        replica = InProcessReplica("r0", engine)
        results = [replica.submit(p).result(timeout=WAIT_S)
                   for p in prompt_list]
        replica.stop()
        events = rec.tail(10_000)
    finally:
        telemetry.reset()
    return replica.scheduler, results, events


def spans(events, name):
    return [e for e in events if e["kind"] == "span" and e["name"] == name]


def test_prefix_skip_and_resume_give_the_cold_stream(engines):
    """A fully resident prompt admits with no prefill (the census and the
    spans say so) and a partly resident one prefills its tail only; both
    streams and last-prompt logits equal a cold engine's."""
    _, port = engines
    (full,) = prompts((16,), seed=8)     # 4 whole pages
    rng = np.random.RandomState(9)
    base = rng.randint(0, VOCAB, 8).astype(np.int32)   # 2 whole pages
    ext = np.concatenate([base, rng.randint(0, VOCAB, 5).astype(np.int32)])
    sched, res, events = serve_in_order(port, [full, full, base, ext])
    assert sched.prefill_skips == 1 and sched.tail_resumes == 1
    assert len(spans(events, "prefill_skip")) == 1
    assert len(spans(events, "prefill")) == 3
    cold = serve_all(port_engine(port.model, prefix_skip=False),
                     [(p, {}) for p in (full, base, ext)])
    for got, want in zip((res[1], res[3]), (cold[0], cold[2])):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_allclose(got.last_logits, want.last_logits,
                                   atol=ATOL, rtol=RTOL)
        assert int(np.argmax(got.last_logits)) == int(got.tokens[0])


def test_prefix_skip_gates(tiny):
    _, _, tm = tiny
    assert port_engine(tm, kv_dtype="int8").prefix_skip_enabled is False
    assert port_engine(tm, prefix_sharing=False).prefix_skip_enabled is False
    assert port_engine(tm, prefix_skip=False).prefix_skip_enabled is False
    assert port_engine(tm).prefix_skip_enabled is True


def test_engine_refuses_a_plain_config_and_a_short_position_table(tiny):
    from distributed_pytorch_training_tpu_torch.serving import ServeConfig

    _, _, tm = tiny
    params = dict(tm.named_parameters())
    with pytest.raises(ValueError, match="PagedServeConfig"):
        SlotEngine(tm, ServeConfig(buckets=(8,)), params, device="cpu")
    with pytest.raises(ValueError, match="max_position"):
        SlotEngine(tm, PagedServeConfig(buckets=(48,), max_new_tokens=12,
                                        page_size=11), params, device="cpu")


def test_router_replica_death_is_invisible_in_the_streams(tiny):
    """Two replicas; r0 dies with every one of its requests still queued
    (its worker held at a gate, so nothing of r0 runs before the kill):
    each of r0's requests fails with ReplicaDead, the router resubmits it
    to r1 with its seed, and every stream equals a lone engine's."""
    _, _, tm = tiny
    r0 = InProcessReplica("r0", port_engine(tm))
    r1 = InProcessReplica("r1", port_engine(tm))
    gate = threading.Event()
    step = r0.scheduler.step
    r0.scheduler.step = lambda: gate.wait(WAIT_S) and step()
    router = Router([r0, r1])
    specs = mixed_specs(4, n=12, sampled=True)
    reqs = [router.submit(s, **kw) for s, kw in specs]
    assert any(r.replica_name == "r0" for r in reqs)
    failed = r0.scheduler.kill(ReplicaDead("r0 died"))
    gate.set()
    results = [r.result(timeout=WAIT_S) for r in reqs]
    router.stop()
    assert len(failed) == sum(r.replica_deaths for r in reqs) > 0
    assert not r0.healthy()
    lone = serve_all(port_engine(tm),
                     [(s, dict(kw, seed=r.kw["seed"]))
                      for (s, kw), r in zip(specs, reqs)])
    for a, b in zip(results, lone):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_router_stress_many_submitters_each_request_once(tiny):
    """More submitter threads than cores, a short switch interval, two
    replicas: every request resolves exactly once, with the stream a lone
    engine gives it (the queues', schedulers' and router's locks)."""
    import os

    _, _, tm = tiny
    replicas = [InProcessReplica(f"r{i}", port_engine(tm)) for i in range(2)]
    router = Router(replicas)
    specs = mixed_specs(5, n=4 * (os.cpu_count() or 4), sampled=True)
    out = [None] * len(specs)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submit(i):
            s, kw = specs[i]
            out[i] = router.submit(s, **kw).result(timeout=WAIT_S)

        threads = [threading.Thread(target=submit, args=(i,), daemon=True)
                   for i in range(len(specs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        router.stop()
    assert sum(r.scheduler.served for r in replicas) == len(specs)
    lone = serve_all(port_engine(tm), specs)
    for a, b in zip(out, lone):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_kill_fails_queued_pending_and_running(engines):
    _, port = engines
    port.reset_state()
    q = RequestQueue(port.config.buckets)
    sched = ContinuousScheduler(port, q)
    reqs = [q.submit(s) for s in prompts((4, 7, 10), seed=16)]
    sched._pull()
    sched._admit_pending()               # three running
    q.submit(np.ones(5, np.int32))       # and one still queued
    assert len(sched.running) == 3
    assert len(sched.kill()) == 4
    for r in reqs:
        with pytest.raises(RuntimeError, match="died"):
            r.result(timeout=5.0)
    with pytest.raises(RuntimeError):
        q.submit(np.ones(4, np.int32))


class _WatchedLock:
    """The scheduler's lock, reporting when a thread other than its
    holder starts to wait for it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owner = None
        self.contended = threading.Event()

    def __enter__(self):
        if self._owner is not None and \
                self._owner != threading.get_ident():
            self.contended.set()
        self._lock.acquire()
        self._owner = threading.get_ident()
        return self

    def __exit__(self, *exc):
        self._owner = None
        self._lock.release()
        return False


def test_kill_mid_step_resolves_each_request_exactly_once(monkeypatch):
    """kill() from another thread while a step runs waits for the step's
    end, then fails what is left; nothing is resolved twice. Made
    deterministic by a hook in the stub engine's third decode step: it
    starts the kill and returns only once the kill waits for the lock."""
    cfg = PagedServeConfig(**paged_kw())

    class _StubEngine:
        config = cfg
        calls = 0

        def set_page_row(self, slot, row):
            pass

        def admit(self, slot, tokens, want, temperature, top_p, seed):
            return cfg.buckets[-1]

        def decode_step(self):
            _StubEngine.calls += 1
            if _StubEngine.calls == 3:
                killer.start()
                assert lock.contended.wait(WAIT_S)

        def fence(self):
            pass

        def fetch_slot(self, slot):
            return (np.zeros(cfg.max_new_tokens, np.int32),
                    np.zeros(VOCAB, np.float32))

    resolutions = {}
    orig_result = batching.Request.set_result
    orig_error = batching.Request.set_error

    def count(orig):
        def wrapped(self, value):
            resolutions[self.id] = resolutions.get(self.id, 0) + 1
            orig(self, value)
        return wrapped

    monkeypatch.setattr(batching.Request, "set_result", count(orig_result))
    monkeypatch.setattr(batching.Request, "set_error", count(orig_error))
    q = RequestQueue(cfg.buckets)
    sched = ContinuousScheduler(_StubEngine(), q)
    lock = sched._lock = _WatchedLock()
    killer = threading.Thread(target=sched.kill, daemon=True)
    reqs = [q.submit(s, max_new_tokens=2 + i % 3)
            for i, s in enumerate(prompts([4] * 20, seed=23))]
    for _ in range(3):                   # the third holds the hook
        assert sched.step()
    killer.join(WAIT_S)
    assert not killer.is_alive() and sched.killed
    assert sched.step() is False
    served = failed = 0
    for r in reqs:
        try:
            r.result(timeout=5.0)
            served += 1
        except RuntimeError:
            failed += 1
    # 8 slots, wants 2-4: three steps completed some, the kill failed
    # the rest
    assert served > 0 and failed > 0 and served + failed == len(reqs)
    assert resolutions == {r.id: 1 for r in reqs}
    assert _StubEngine.calls == 3


def test_kill_is_not_starved_by_a_busy_worker():
    """A kill waits for the lock of a worker that still has work. A
    released lock goes to whichever thread asks first, and the looping
    worker always asks first; so a kill requested inside the worker's
    third decode step must stop the worker from starting a fourth, and
    fail what is still in flight, while the worker runs on its own
    thread (``run``)."""
    cfg = PagedServeConfig(**paged_kw(max_new_tokens=6))

    class _StubEngine:
        config = cfg
        calls = 0

        def set_page_row(self, slot, row):
            pass

        def admit(self, slot, tokens, want, temperature, top_p, seed):
            return cfg.buckets[-1]

        def decode_step(self):
            _StubEngine.calls += 1
            if _StubEngine.calls == 3:
                killer.start()
                assert sched._kill_requested.wait(WAIT_S)

        def fence(self):
            pass

        def fetch_slot(self, slot):
            return (np.zeros(cfg.max_new_tokens, np.int32),
                    np.zeros(VOCAB, np.float32))

    q = RequestQueue(cfg.buckets)
    sched = ContinuousScheduler(_StubEngine(), q)
    killer = threading.Thread(target=sched.kill, daemon=True)
    reqs = [q.submit(s) for s in prompts([4] * 40, seed=24)]
    worker = threading.Thread(target=sched.run, args=(threading.Event(),),
                              daemon=True)
    worker.start()
    worker.join(WAIT_S)
    killer.join(WAIT_S)
    assert not worker.is_alive() and not killer.is_alive()
    assert _StubEngine.calls == 3 and sched.killed
    failed = 0
    for r in reqs:
        try:
            r.result(timeout=5.0)
        except RuntimeError:
            failed += 1
    assert failed == len(reqs)        # want 6: none finished in 3 steps


def test_spans_and_gauges_are_emitted(engines):
    from distributed_pytorch_training_tpu_torch.telemetry.__main__ import (
        summarize,
    )

    _, port = engines
    port.reset_state()
    rec = telemetry.configure()
    try:
        replica = InProcessReplica("r0", port)
        router = Router([replica])
        for r in [router.submit(s) for s in prompts((5, 9, 12), seed=15)]:
            r.result(timeout=WAIT_S)
        replica.stop()
        events = rec.tail(10_000)
    finally:
        telemetry.reset()
    names = {e["name"] for e in events if e["kind"] == "span"}
    assert {"slot_wait", "router_dispatch", "prefill", "queue_wait"} <= names
    gauges = {e["name"] for e in events if e["kind"] == "gauge"}
    assert {"serving_slot_occupancy", "serving_page_pool_free",
            "serving_queue_depth"} <= gauges
    split = summarize(events)["spans"]
    assert "slot_wait" in split and "router_dispatch" in split


# ---------------------------------------------------------------------------
# Router units (no engine), as the JAX package's TestRouterUnits
# ---------------------------------------------------------------------------


class _StubPending:
    def __init__(self, replica):
        self.replica = replica
        self.fail = False

    def result(self, timeout=None):
        if self.fail or self.replica.dead:
            raise ReplicaDead(f"replica {self.replica.name} died")
        return Result(tokens=np.zeros(1, np.int32),
                      last_logits=np.zeros(VOCAB, np.float32))


class _StubReplica:
    def __init__(self, name, depth=0):
        self.name, self.depth = name, depth
        self.dead = False
        self.submits = []

    def healthy(self):
        return not self.dead

    def queue_depth(self):
        return self.depth

    def submit(self, tokens, **kw):
        if self.dead:
            raise ReplicaDead(f"replica {self.name} is down")
        self.submits.append(kw)
        return _StubPending(self)


def test_router_least_depth_wins():
    a, b = _StubReplica("a", depth=5), _StubReplica("b", depth=1)
    router = Router([a, b])
    for _ in range(3):
        router.submit(np.ones(4, np.int32)).result(timeout=1.0)
    assert len(b.submits) == 3 and not a.submits


def test_router_seed_pinned_at_route_time_survives_resubmit():
    router = Router([_StubReplica("a"), _StubReplica("b")])
    req = router.submit(np.ones(4, np.int32))
    seed, first = req.kw["seed"], req.replica_name
    req._inner.fail = True
    router.replicas[first].dead = True
    req.result(timeout=1.0)
    assert req.replica_deaths == 1 and req.replica_name != first
    assert router.replicas[req.replica_name].submits[-1]["seed"] == seed
    r2 = router.submit(np.ones(4, np.int32))
    assert r2.kw["seed"] != seed


def test_router_refuses_no_replica_dead_replicas_and_duplicates():
    dead = _StubReplica("a")
    dead.dead = True
    with pytest.raises(ReplicaDead, match="no healthy"):
        Router([dead]).submit(np.ones(4, np.int32))
    with pytest.raises(ValueError, match="unique"):
        Router([_StubReplica("a"), _StubReplica("a")])
    with pytest.raises(ValueError, match="at least one"):
        Router([])


def test_router_slow_replica_times_out_without_resubmit():
    class _Slow(_StubReplica):
        def submit(self, tokens, **kw):
            self.submits.append(kw)

            class _P:
                def result(self, timeout=None):
                    raise TimeoutError("still pending")
            return _P()

    a = _Slow("a")
    req = Router([a]).submit(np.ones(4, np.int32))
    with pytest.raises(TimeoutError):
        req.result(timeout=0.2)
    assert req.replica_deaths == 0 and len(a.submits) == 1


def test_router_death_loop_respects_the_deadline():
    class _Dying(_StubReplica):
        def submit(self, tokens, **kw):
            self.submits.append(kw)
            name = self.name

            class _P:
                def result(self, timeout=None):
                    time.sleep(0.001)
                    raise ReplicaDead(f"replica {name} died")
            return _P()

    req = Router([_Dying("a"), _Dying("b")]).submit(np.ones(4, np.int32))
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="replica deaths"):
        req.result(timeout=0.2)
    assert time.perf_counter() - t0 < 5.0 and req.replica_deaths >= 1


def test_http_pending_timeout_is_not_a_death(monkeypatch):
    replica = HttpReplica("h", port=1)
    for exc in (socket.timeout("timed out"),
                urllib.error.URLError(socket.timeout("timed out"))):
        def _raise(*a, _exc=exc, **kw):
            raise _exc
        monkeypatch.setattr(urllib.request, "urlopen", _raise)
        with pytest.raises(TimeoutError):
            replica.submit(np.ones(3, np.int32)).result(timeout=0.1)
        assert replica.healthy()

    def _refuse(*a, **kw):
        raise ConnectionRefusedError("refused")
    monkeypatch.setattr(urllib.request, "urlopen", _refuse)
    with pytest.raises(ReplicaDead):
        replica.submit(np.ones(3, np.int32)).result(timeout=0.1)
    assert not replica.healthy()


# ---------------------------------------------------------------------------
# The CLI: bench, bench --continuous, and a serve process
# ---------------------------------------------------------------------------


BENCH = ["bench", "--device", "cpu", "--json", "--model-overrides",
         TINY_OVERRIDES, "--buckets", "8,16", "--max-new-tokens", "4",
         "--requests", "8", "--offered-load", "50"]


@pytest.mark.parametrize("extra", [
    [], ["--continuous", "--mixed-want"],
    ["--continuous", "--kv-dtype", "int8", "--page-size", "4"],
    ["--continuous", "--replicas", "2", "--kill-replica"],
], ids=["iteration", "continuous", "continuous-int8", "replicas-kill"])
def test_cli_bench_on_cpu(extra, capsys, tmp_path):
    assert main(BENCH + extra + ["--output-dir", str(tmp_path)]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["n_requests"] == 8 and row["p99_ms"] >= row["p50_ms"] > 0
    if "--continuous" in extra:
        assert row["completed"] == 8 and row["mode"] == "serving_continuous"
        assert row["kv_dtype"] == ("int8" if "int8" in extra else "fp32")
        assert row["replicas"] == (2 if "--replicas" in extra else 1)
    else:
        assert row["mode"] == "serving"
    (tmp_path / "telemetry_rank0.jsonl").stat()


def test_cli_serve_answers_then_drains_on_sigterm(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_pytorch_training_tpu_torch."
         "serving", "serve", "--device", "cpu", "--port", "0",
         "--model-overrides", TINY_OVERRIDES, "--buckets", "8,16",
         "--max-new-tokens", "4", "--output-dir", str(tmp_path)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue_mod.Queue[str]" = queue_mod.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    try:
        port, seen = None, []
        deadline = time.monotonic() + WAIT_S
        while port is None:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
            seen.append(line)
            m = re.search(r"POST /generate on :(\d+)", line)
            port = int(m.group(1)) if m else None
        url = f"http://127.0.0.1:{port}"
        body = json.dumps({"tokens": [5, 7, 11], "max_new_tokens": 3,
                           "want_logits": True}).encode()
        req = urllib.request.Request(
            url + "/generate", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            out = json.loads(resp.read())
        assert len(out["tokens"]) == 3 and len(out["last_logits"]) == VOCAB
        assert int(np.argmax(out["last_logits"])) == out["tokens"][0]
        with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read()) == {"draining": False,
                                               "served": 1}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
        reader.join(timeout=10)
        while not lines.empty():
            seen.append(lines.get_nowait())
        assert any("replica drained (1 served)" in x for x in seen), seen
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
