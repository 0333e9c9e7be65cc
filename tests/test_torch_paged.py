"""The port's paged KV pool, page allocator, key stream and sampler against
the JAX package's, on the CPU.

* ``models/layers.py`` paged functions: the same seeded k/v rows through
  ``scatter_paged_prefill`` (padded positions), ``scatter_paged_rows``
  (inactive rows, a call with no active row) and ``scatter_paged_window``
  (positions past the page span) give pool bytes BITWISE the JAX
  package's, fp32 pages and int8 codes and scales alike; the gathered
  dense view is bitwise JAX's too.
* ``serving/paged.py``: the same alloc / release / rollback / eviction
  sequence gives the same page tables, shared lists and stats as the
  JAX ``PagePool``; ``prompt_page_hashes`` and ``PagedServeConfig`` are
  the JAX package's.
* ``utils/prng.py``: ``PRNGKey``, ``fold_in`` and the raw bits BITWISE
  jax.random's (threefry2x32, partitionable); the uniform floats bitwise;
  the Gumbel noise within GUMBEL_ATOL (two logs, whose last bit differs
  between XLA's and torch's ``log``); ``sample_tokens`` tokens EQUAL the
  JAX package's at temperatures {0, 0.7, 1.0} x top_p {1.0, 0.9}.
* ``Request``'s knobs and ``RequestQueue.take`` as the JAX package's.
* The serving rows' keys: the JAX rows' keys but those listed in
  JAX_ONLY_KEYS (the compile census, the HLO contract verdict and the CPU
  mesh caveat, which have no counterpart in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_training_tpu.data import pack as jax_pack
from distributed_pytorch_training_tpu.models import layers as J
from distributed_pytorch_training_tpu.serving import batching as jax_batching
from distributed_pytorch_training_tpu.serving import paged as jax_paged
from distributed_pytorch_training_tpu.serving.continuous import (
    sample_tokens as jax_sample_tokens,
)
from distributed_pytorch_training_tpu_torch.data import pack
from distributed_pytorch_training_tpu_torch.models import layers as T
from distributed_pytorch_training_tpu_torch.serving import batching
from distributed_pytorch_training_tpu_torch.serving import paged
from distributed_pytorch_training_tpu_torch.serving.continuous import (
    sample_tokens,
)
from distributed_pytorch_training_tpu_torch.utils import prng

# |gumbel| <= ~16 (mode "low"); two float32 logs a sample, each within
# an ulp or two of the other library's: measured 4.8e-7 over 50,257
GUMBEL_ATOL = 2e-6
# what the JAX rows carry and the port's do not
JAX_ONLY_KEYS = {"compiles", "recompiles_after_warmup", "contracts",
                 "caveat"}
DEPTH, PAGES, PS, HEADS, HD, ROWS = 2, 9, 4, 2, 8, 3
TABLE = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)


def pools(quantized):
    return (J.init_paged_kv(DEPTH, PAGES, PS, HEADS, HD,
                            quantized=quantized),
            T.init_paged_kv(DEPTH, PAGES, PS, HEADS, HD,
                            quantized=quantized))


def assert_pools_bitwise(jp, tp):
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert (a is None) == (b is None)
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)


def rows_of(rng, *shape):
    return rng.randn(DEPTH, *shape, HEADS, HD).astype(np.float32)


def jt(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a)
                                              for a in arrays]


def scatter_both(jp, tp, kind, rng):
    """One write of ``kind`` through both packages."""
    if kind == "prefill":
        # bucket 8, length 7: position 7 is padding and must not land
        k, v = rows_of(rng, 8), rows_of(rng, 8)
        (jk, jv), (tk, tv) = jt(k, v)
        jp = J.scatter_paged_prefill(jp, jnp.asarray(TABLE[0]), jk, jv,
                                     jnp.int32(7))
        T.scatter_paged_prefill(tp, torch.from_numpy(TABLE[0]), tk, tv, 7)
    elif kind in ("rows", "rows_none_active"):
        pos = np.array([7, 5, 3], np.int32)
        act = (np.array([True, True, False]) if kind == "rows"
               else np.zeros(3, bool))
        k, v = rows_of(rng, ROWS), rows_of(rng, ROWS)
        (jk, jv, jpos, jact, jtab), (tk, tv, tpos, tact, ttab) = jt(
            k, v, pos, act, TABLE)
        jp = J.scatter_paged_rows(jp, jtab, jpos, jk, jv, jact)
        T.scatter_paged_rows(tp, ttab, tpos, tk, tv, tact)
    else:
        # a 6-position window, the page span 12: positions 12.. clip to
        # the last table entry in the lookup and are masked by the caller
        pos = np.array([[8, 9, 10, 11, 12, 13], [9, 10, 11, 12, 13, 14],
                        [0, 1, 2, 3, 4, 5]], np.int32)
        act = (pos < 12) & np.array([True, True, False])[:, None]
        k, v = rows_of(rng, ROWS, 6), rows_of(rng, ROWS, 6)
        (jk, jv, jpos, jact, jtab), (tk, tv, tpos, tact, ttab) = jt(
            k, v, pos, act, TABLE)
        jp = J.scatter_paged_window(jp, jtab, jpos, jk, jv, jact)
        T.scatter_paged_window(tp, ttab, tpos, tk, tv, tact)
    return jp, tp


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kind", ["prefill", "rows", "rows_none_active",
                                  "window"])
def test_scatter_bitwise_equals_jax(quantized, kind):
    rng = np.random.RandomState(0)
    jp, tp = pools(quantized)
    # a prefill first, so that the later writes land beside live pages
    jp, tp = scatter_both(jp, tp, "prefill", rng)
    if kind != "prefill":
        jp, tp = scatter_both(jp, tp, kind, rng)
    assert_pools_bitwise(jp, tp)
    assert np.asarray(jp.k).astype(np.float64).any()


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_gather_and_bytes_equal_jax(quantized):
    rng = np.random.RandomState(1)
    jp, tp = pools(quantized)
    for kind in ("prefill", "rows", "window"):
        jp, tp = scatter_both(jp, tp, kind, rng)
    gk, gv = J.gather_paged_kv(jp, jnp.asarray(TABLE))
    tk, tv = T.gather_paged_kv(tp, torch.from_numpy(TABLE))
    assert tk.shape == (DEPTH, ROWS, 3 * PS, HEADS, HD)
    np.testing.assert_array_equal(np.asarray(gk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(gv), tv.numpy())
    assert T.paged_kv_bytes(tp) == J.paged_kv_bytes(jp)
    assert T.dense_kv_bytes(8, 22, 12, 64, 12) == J.dense_kv_bytes(
        8, 22, 12, 64, 12)


def test_quantized_page_write_counts_one_k1_call_per_tensor(monkeypatch):
    """An int8 page write quantizes k once and v once (two calls of the
    quantizer's wrapper at (L*rows*H, D)), and only there: the count the
    chip smoke reads on the card."""
    from distributed_pytorch_training_tpu_torch.ops import quantize

    calls = []
    real = quantize.quantize_int8_rows

    def spy(rows):
        calls.append(tuple(rows.shape))
        return real(rows)

    monkeypatch.setattr(quantize, "quantize_int8_rows", spy)
    scatter_both(*pools(True), "rows", np.random.RandomState(2))
    assert calls == [(DEPTH * ROWS * HEADS, HD)] * 2


# ---------------------------------------------------------------------------
# The page allocator
# ---------------------------------------------------------------------------


def lease_view(lease):
    if lease is None:
        return None
    return (lease.pages.tolist(), lease.n_pages, [int(p) for p in
                                                  lease.shared])


def test_page_pool_sequence_equals_jax():
    """A seeded mix of allocations (shared and divergent prompts),
    releases, rollbacks and evictions on a pool too small for all of
    them: every lease, every failure and the stats match JAX's."""
    rng = np.random.RandomState(3)
    mine, ref = paged.PagePool(12, 4, 5), jax_paged.PagePool(12, 4, 5)
    bases = [rng.randint(0, 50, 16).astype(np.int32) for _ in range(3)]
    live = []
    for step in range(60):
        op = rng.randint(4)
        if op < 2 or not live:
            base = bases[rng.randint(3)]
            toks = np.concatenate([base[:rng.randint(1, 17)],
                                   rng.randint(0, 50, rng.randint(0, 3))
                                   .astype(np.int32)])
            n = len(toks) + int(rng.randint(1, 5))
            a, b = mine.alloc(toks, min(n, 20)), ref.alloc(toks, min(n, 20))
            assert lease_view(a) == lease_view(b), step
            if a is not None:
                live.append((a, b))
        else:
            a, b = live.pop(rng.randint(len(live)))
            if op == 2:
                mine.release(a)
                ref.release(b)
            else:
                mine.rollback(a)
                ref.rollback(b)
        assert mine.stats() == ref.stats(), step
        assert mine.free_pages() == ref.free_pages()
    assert mine.evictions > 0 and mine.prefix_hits > 0


def test_page_pool_dry_free_list_never_duplicates_matched_prefix():
    """JAX's TestPagePool case: a matched retained prefix page is claimed
    at match time, so a dry free list cannot re-lease it."""
    pool = paged.PagePool(3, 4, 2)
    a = pool.alloc(list(range(4)), 4)
    pool.release(a)
    b = pool.alloc(list(range(100, 104)), 4)
    assert b is not None
    stats0 = pool.stats()
    assert pool.alloc(list(range(4)), 8) is None
    assert pool.stats() == stats0
    pool.release(b)
    d = pool.alloc(list(range(4)), 8)
    pages = list(map(int, d.pages[:d.n_pages]))
    assert len(set(pages)) == len(pages) and d.shared and 0 not in pages


def test_prompt_page_hashes_and_config_equal_jax():
    toks = np.random.RandomState(4).randint(0, 1000, 37)
    for ps in (1, 4, 16):
        assert pack.prompt_page_hashes(toks, ps) == \
            jax_pack.prompt_page_hashes(toks, ps)
    kw = dict(buckets=(8, 16), rows=8, max_new_tokens=6, page_size=4)
    mine, ref = paged.PagedServeConfig(**kw), jax_paged.PagedServeConfig(**kw)
    assert (mine.cache_len, mine.pages_per_slot, mine.total_pages) == \
        (ref.cache_len, ref.pages_per_slot, ref.total_pages) == (22, 6, 49)
    assert mine.fused_quantize is None
    for bad in (dict(kv_dtype="fp8"), dict(page_size=0)):
        with pytest.raises(ValueError):
            paged.PagedServeConfig(**dict(kw, **bad))


# ---------------------------------------------------------------------------
# The key stream and the sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 1234, 2 ** 31 + 5, 2 ** 40 + 3])
def test_prng_key_fold_in_and_bits_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.prng_key(seed)
    np.testing.assert_array_equal(mine.numpy(),
                                  np.asarray(key).astype(np.int64))
    data = np.array([0, 1, 17, 1023, 2 ** 31 + 9], np.int64)
    ref = np.stack([np.asarray(jax.random.fold_in(key, int(d)))
                    for d in data]).astype(np.int64)
    got = prng.fold_in(mine.expand(len(data), 2), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), ref)
    k2 = jax.random.fold_in(key, 5)
    np.testing.assert_array_equal(
        prng.random_bits(prng.fold_in(mine, torch.tensor(5)), 4099).numpy(),
        np.asarray(jax.random.bits(k2, (4099,))).astype(np.int64))


def test_uniform_bitwise_and_gumbel_close():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    mine = prng.fold_in(prng.prng_key(3), torch.tensor(11))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(mine, 50257, tiny).numpy().view(np.uint32),
        np.asarray(jax.random.uniform(key, (50257,), minval=tiny))
        .view(np.uint32))
    np.testing.assert_allclose(prng.gumbel(mine, 50257).numpy(),
                               np.asarray(jax.random.gumbel(key, (50257,))),
                               rtol=0, atol=GUMBEL_ATOL)


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("vocab", [97, 50257])
def test_sample_tokens_equal_jax(vocab, temperature, top_p):
    """Eight rows, each with its own key folded at its own position, as
    the decode step draws them."""
    rng = np.random.RandomState(vocab)
    logits = (rng.randn(8, vocab) * 3).astype(np.float32)
    seeds, pos = np.arange(100, 108), rng.randint(1, 200, 8)
    jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(int(s)),
                                          int(p))
                       for s, p in zip(seeds, pos)])
    tkeys = prng.fold_in(torch.stack([prng.prng_key(int(s))
                                      for s in seeds]),
                         torch.from_numpy(pos))
    temps = np.full(8, temperature, np.float32)
    tops = np.full(8, top_p, np.float32)
    ref = np.asarray(jax_sample_tokens(jnp.asarray(logits), jkeys,
                                       jnp.asarray(temps),
                                       jnp.asarray(tops)))
    got = sample_tokens(torch.from_numpy(logits), tkeys,
                        torch.from_numpy(temps), torch.from_numpy(tops))
    np.testing.assert_array_equal(got.numpy(), ref)
    if temperature == 0.0:
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


# ---------------------------------------------------------------------------
# Requests, the queue's take, and the serving rows' keys
# ---------------------------------------------------------------------------


def test_request_knobs_and_take_match_jax():
    for mod in (batching, jax_batching):
        q = mod.RequestQueue((8, 16))
        a = q.submit(np.ones(3, np.int32))
        b = q.submit(np.ones(12, np.int32), temperature=0.7, top_p=0.9,
                     seed=5, max_new_tokens=2)
        assert a.seed == a.id and a.temperature == 0.0 and a.top_p == 1.0
        assert (b.seed, b.temperature, b.top_p, b.max_new_tokens) == \
            (5, 0.7, 0.9, 2)
        # FIFO and bucket-blind, at most max_n
        assert [r.id for r in q.take(1)] == [a.id]
        assert [r.id for r in q.take(8)] == [b.id]
        assert q.take(8, timeout=0.0) == []
        for bad in (dict(top_p=0.0), dict(temperature=-1.0)):
            with pytest.raises(ValueError):
                q.submit(np.ones(3, np.int32), **bad)
        b.set_result(mod.Result(tokens=np.zeros(1, np.int32),
                                last_logits=np.zeros(3, np.float32)))
        assert b.t_done is not None and b.t_first_token is None


def test_serving_rows_have_the_jax_rows_keys(mesh8):
    from distributed_pytorch_training_tpu.experiments import (
        harness as jax_harness,
    )
    from distributed_pytorch_training_tpu_torch.experiments import harness

    tiny = dict(vocab_size=97, hidden_dim=32, depth=2, num_heads=2)
    kw = dict(n_requests=4, offered_rps=100.0, buckets=(8,),
              max_new_tokens=2, model_overrides=tiny)
    ckw = dict(kw, page_size=4, prefix_skip=False)
    mine = harness.measure_serving(device="cpu", **kw)
    ref = jax_harness.measure_serving(**kw)
    assert set(mine) == set(ref) - JAX_ONLY_KEYS
    mine_c = harness.measure_serving_continuous(device="cpu", **ckw)
    ref_c = jax_harness.measure_serving_continuous(**ckw)
    assert set(mine_c) == set(ref_c) - JAX_ONLY_KEYS
    assert mine_c["completed"] == 4 and mine_c["replica_deaths"] == 0
    # the same seed gives both rows of each package the same load
    for row in (mine, ref, mine_c, ref_c):
        assert row["n_requests"] == 4
