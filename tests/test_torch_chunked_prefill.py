"""Chunked prefill and the prefix cache of the port against the JAX package
on the CPU, float32. Engine cases port ``tests/test_chunked_prefill.py``:
the same prompts, settings and submission order go through the JAX engine
and the port's (params bridged from JAX), and the port's tokens must equal
the JAX engine's and the port's ``greedy_generate``, with every engine
counter equal to the JAX engine's (tolerance 0). Then ``chunk_attention``
and ``prefill_chunk`` against the jnp functions, writes past the cache's
end (dropped), the MoE and SSM declines, and ``PrefixCache`` units."""
import dataclasses
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core.monitoring import Monitor as JaxMonitor  # noqa: E402
from repro.models import layers as J  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache  # noqa: E402,E501
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.monitoring import Monitor  # noqa: E402
from repro_torch.models import layers as T  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine, greedy_generate  # noqa: E402,E501
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.replica import ReplicaSet  # noqa: E402

MAX_SEQ = 96
CHUNK = 16
VOCAB = 503


def _pair_models(arch):
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    jm = jax_build(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)),
                               dtype="float32")
    tm = build_model(tcfg, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    return _pair_models("yi-9b")


def _engines(models, *, prefix_mb=0, monitor=False, **kw):
    """A JAX engine and a port engine with the same settings (each with its
    own prefix cache and monitor when asked)."""
    jm, jp, tm, tp = models
    kw.setdefault("slots", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("chunk_tokens", CHUNK)
    out = []
    for eng_cls, pc_cls, mon_cls, model, params, extra in (
            (JaxEngine, JaxPrefixCache, JaxMonitor, jm, jp, {}),
            (ServingEngine, PrefixCache, Monitor, tm, tp,
             {"device": "cpu"})):
        mon = mon_cls() if monitor else None
        pc = pc_cls(kw["chunk_tokens"], budget_bytes=int(prefix_mb * 2**20),
                    monitor=mon) if prefix_mb else None
        out.append(eng_cls(model, params, prefix_cache=pc, monitor=mon,
                           **kw, **extra))
    return out


def _run(models, engines, prompts, max_new=5, check_greedy=True):
    """Submit ``prompts`` to both engines in order, drain them, and check
    tokens (port == JAX engine == port greedy) and every counter."""
    _, _, tm, tp = models
    outs = []
    for eng in engines:
        futs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run_until_idle()
        outs.append([f.result() for f in futs])
    jeng, eng = engines
    for p, want, got in zip(prompts, *outs):
        np.testing.assert_array_equal(got, want)
        if check_greedy:
            np.testing.assert_array_equal(
                got, greedy_generate(tm, tp, p, max_new, eng.max_seq))
    assert eng.metrics == jeng.metrics
    if eng.prefix_cache is not None:
        assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    return outs[1]


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n) for n in lens]


# -- chunk-boundary edge cases ----------------------------------------------

def test_prompt_exactly_bucket_multiple(models):
    engines = _engines(models)
    assert engines[1]._chunk_ok
    _run(models, engines, _prompts(0, CHUNK, 3 * CHUNK))


def test_single_token_prompt_keeps_batched_path(models):
    engines = _engines(models, prefix_mb=1)
    _run(models, engines, _prompts(1, 1))
    eng = engines[1]
    assert eng.metrics["prefill_chunks"] == 0 and eng.metrics["prefills"] == 1
    assert eng.prefix_cache.stats()["hits"] == 0
    assert eng.prefix_cache.stats()["misses"] == 0


def test_exact_chunk_prompt_via_chunked_path(models):
    engines = _engines(models, prefix_mb=1)
    p = _prompts(11, CHUNK)
    _run(models, engines, p, max_new=4)
    assert engines[1].metrics["prefill_chunks"] == 1
    _run(models, engines, p, max_new=4)        # whole-prompt boundary hit
    assert engines[1].prefix_cache.stats()["hits"] == 1


def test_chunk_boundary_mid_prompt(models):
    _run(models, _engines(models),
         _prompts(2, CHUNK + 1, 2 * CHUNK - 1, 37))


def test_long_prompt_beyond_one_admission_batch(models):
    engines = _engines(models)
    _run(models, engines, _prompts(3, 78), max_new=6)
    assert engines[1].metrics["prefill_chunks"] >= 5


def test_long_prefill_does_not_stall_admitted_decode(models):
    """A short request admitted beside a long prompt finishes while the
    long prompt is still prefilling, stepped as in the JAX test."""
    _, _, tm, tp = models
    jeng, eng = _engines(models, chunk_tokens=8)
    long_p, short_p = _prompts(4, 80, 5)
    reqs = []
    for e in (jeng, eng):
        long_r = e.submit_request(long_p, max_new_tokens=4)
        short_r = e.submit_request(short_p, max_new_tokens=3)
        for _ in range(6):
            e.step()
        assert short_r.future.done() and not long_r.future.done()
        assert long_r.slot in e._prefilling
        e.run_until_idle()
        reqs.append((long_r, short_r))
    for (jr, r) in zip(*reqs):
        np.testing.assert_array_equal(r.future.result(), jr.future.result())
    np.testing.assert_array_equal(reqs[1][0].future.result(),
                                  greedy_generate(tm, tp, long_p, 4, MAX_SEQ))
    assert eng.metrics == jeng.metrics


def test_chunk_overrunning_max_seq_is_dropped(models):
    """A chunk size that does not divide max_seq: the final padded chunk of
    a 98-token prompt covers positions 96..111 of a 100-position cache, and
    the writes past 99 are dropped (JAX's scatter drops them)."""
    engines = _engines(models, max_seq=100)
    _run(models, engines, _prompts(12, 98, 90), max_new=2)


# -- prefix caching ----------------------------------------------------------

def test_prefix_cache_hit_token_identical(models):
    engines = _engines(models, prefix_mb=16, monitor=True)
    rng = np.random.default_rng(5)
    head = rng.integers(1, VOCAB, size=3 * CHUNK)
    first = np.concatenate([head, rng.integers(1, VOCAB, size=7)])
    _run(models, engines, [first])                 # seeds 16/32/48
    base = engines[1].metrics["prefill_tokens"]
    others = [np.concatenate([head, rng.integers(1, VOCAB, size=k)])
              for k in (4, 9, 12)]
    _run(models, engines, others)
    eng = engines[1]
    assert eng.prefix_cache.stats()["hits"] == 3
    assert eng.metrics["prefix_hit_tokens"] == 3 * len(head)
    assert eng.metrics["prefill_tokens"] - base < len(head) * 3
    assert eng.monitor.gauge_last(eng.prefix_cache.name,
                                  "prefix_cache_hits") == 3


def test_prefix_cache_whole_prompt_hit(models):
    engines = _engines(models, prefix_mb=16)
    p = _prompts(6, 2 * CHUNK)
    _run(models, engines, p, max_new=4)
    chunks = engines[1].metrics["prefill_chunks"]
    _run(models, engines, p, max_new=4)            # identical prompt
    assert engines[1].metrics["prefill_chunks"] == chunks


def test_prefix_cache_lru_eviction(models):
    """A budget below the working set evicts (gauged); evicted prefixes
    recompute, still exact. A float32 16-token entry of the reduced model is
    16 KiB, so 40 KiB holds two."""
    engines = _engines(models, prefix_mb=40 / 1024, monitor=True)
    _run(models, engines, _prompts(7, *(2 * CHUNK,) * 4), max_new=3)
    eng = engines[1]
    st = eng.prefix_cache.stats()
    assert st["evictions"] > 0 and st["bytes"] <= eng.prefix_cache.budget
    assert eng.monitor.gauge_last(eng.prefix_cache.name,
                                  "prefix_cache_evictions") == st["evictions"]


def test_prefix_cache_carry_and_drop(models):
    """adopt_entries carries host entries to a successor cache and drops
    them all on a chunk-size mismatch; adopted entries serve hits."""
    _, _, tm, tp = models
    pc_old = PrefixCache(CHUNK, budget_bytes=16 << 20)
    eng = ServingEngine(tm, tp, slots=3, max_seq=MAX_SEQ, chunk_tokens=CHUNK,
                        prefix_cache=pc_old, device="cpu")
    (p,) = _prompts(8, 3 * CHUNK + 5)
    eng.submit(p, max_new_tokens=3)
    eng.run_until_idle()
    assert len(pc_old) == 3
    assert pc_old.lookup(p[:CHUNK])[0] == CHUNK     # child before ancestor
    pc_new = PrefixCache(CHUNK, budget_bytes=16 << 20)
    assert pc_new.adopt_entries(pc_old) == 3
    covered, entry = pc_new.lookup(p)
    assert covered == 3 * CHUNK and entry is not None
    assert PrefixCache(CHUNK // 2).adopt_entries(pc_old) == 0
    hits = pc_new.stats()["hits"]
    eng2 = ServingEngine(tm, tp, slots=3, max_seq=MAX_SEQ, chunk_tokens=CHUNK,
                         prefix_cache=pc_new, name="gen2", device="cpu")
    f = eng2.submit(p, max_new_tokens=3)
    eng2.run_until_idle()
    assert pc_new.stats()["hits"] == hits + 1
    assert eng2.metrics["prefix_hit_tokens"] == 3 * CHUNK
    np.testing.assert_array_equal(f.result(),
                                  greedy_generate(tm, tp, p, 3, MAX_SEQ))


def test_malformed_prefix_entry_degrades_to_a_miss(models):
    """An entry of the wrong shape (e.g. from another model) is logged as a
    ``prefix_restore_error`` and the prompt is computed in full, as in the
    JAX engine."""
    _, _, tm, tp = models
    mon = Monitor()
    pc = PrefixCache(CHUNK, budget_bytes=16 << 20)
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, chunk_tokens=CHUNK,
                        prefix_cache=pc, monitor=mon, device="cpu")
    (p,) = _prompts(13, 2 * CHUNK + 3)
    cache = tm.init_cache(1, MAX_SEQ, "cpu")
    bad = [{k: torch.zeros(x.shape[0], CHUNK, x.shape[3] + 1, x.shape[4])
            for k, x in c.items()} for c in cache]
    assert pc.insert(p[:CHUNK], bad)
    f = eng.submit(p, max_new_tokens=4)
    eng.run_until_idle()
    assert [e["event"] for e in mon.events(eng.name)] == [
        "prefix_restore_error"]
    assert eng.metrics["prefix_hit_tokens"] == 0
    assert eng.metrics["prefill_tokens"] == len(p)
    np.testing.assert_array_equal(f.result(),
                                  greedy_generate(tm, tp, p, 4, MAX_SEQ))


def test_replicaset_failover_preserves_chunking_requests(models):
    """A replica killed mid-chunk-prefill: the ReplicaSet reschedules the
    request and the retry stays token-identical."""
    _, _, tm, tp = models
    pc = PrefixCache(CHUNK, budget_bytes=16 << 20)
    rs = ReplicaSet(lambda i, devs: ServingEngine(
        tm, tp, slots=2, max_seq=MAX_SEQ, name=f"cr{i}", chunk_tokens=CHUNK,
        prefix_cache=pc, device="cpu"), replicas=2, respawn=True,
        devices=[torch.device("cpu")], prefix_cache=pc)
    rs.start()
    try:
        prompts = _prompts(9, 70, 70, 70, 70)
        reqs = [rs.submit_request(p, max_new_tokens=4) for p in prompts]
        rs.engines[0].kill()
        deadline = time.monotonic() + 60
        while rs.metrics()["failovers"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        for p, r in zip(prompts, reqs):
            np.testing.assert_array_equal(
                r.future.result(timeout=120),
                greedy_generate(tm, tp, p, 4, MAX_SEQ))
        m = rs.metrics()
        assert m["failovers"] >= 1
        assert m["prefix_cache"] == pc.stats()
    finally:
        rs.stop()


# -- batched multi-slot chunk prefill ----------------------------------------

def test_batched_chunks_across_slots_oracle_exact(models):
    engines = _engines(models, slots=4)
    prompts = _prompts(21, 40, 55, 33, 47)
    _run(models, engines, prompts)
    eng = engines[1]
    assert eng.metrics["prefill_chunk_batches"] > 0
    assert eng.metrics["prefill_tokens"] == sum(len(p) for p in prompts)


def test_single_prefilling_slot_keeps_batch1_call(models):
    engines = _engines(models, slots=4)
    _run(models, engines, _prompts(22, 50))
    assert engines[1].metrics["prefill_chunks"] > 0
    assert engines[1].metrics["prefill_chunk_batches"] == 0


def test_batched_chunks_feed_prefix_cache(models):
    engines = _engines(models, slots=4, prefix_mb=8)
    rng = np.random.default_rng(23)
    head = rng.integers(1, VOCAB, size=2 * CHUNK)
    _run(models, engines, [np.concatenate([head, rng.integers(
        1, VOCAB, size=k)]) for k in (5, 9, 7)])
    eng = engines[1]
    assert eng.metrics["prefill_chunk_batches"] > 0
    assert eng.prefix_cache.stats()["insertions"] >= 2
    before = eng.metrics["prefix_hit_tokens"]
    _run(models, engines,
         [np.concatenate([head, rng.integers(1, VOCAB, size=6)])])
    assert eng.metrics["prefix_hit_tokens"] - before >= 2 * CHUNK


# -- fallback gating ---------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m"])
def test_moe_and_ssm_models_decline_chunking(arch):
    """MoE (capacity routing) and SSM (recurrent state) models are not
    padding-safe: chunk_tokens falls back to the whole-prompt path with the
    JAX engine's monitor reason, and the tokens stay the JAX engine's."""
    pair = _pair_models(arch)
    engines = _engines(pair, slots=2, monitor=True, prefix_mb=1)
    assert not engines[1]._chunk_ok
    _run(pair, engines, _prompts(10, 20, 9), max_new=4, check_greedy=False)
    assert engines[1].metrics["prefill_chunks"] == 0
    jev, ev = ([{k: v for k, v in e.items() if k != "t"}
                for e in eng.monitor.events(eng.name)] for eng in engines)
    assert ev == jev and ev[0]["event"] == "chunked_prefill_unsupported"


# -- the model functions -----------------------------------------------------

def test_chunk_attention_matches_jnp():
    """float32, tolerance 1e-5 (one summation order against another)."""
    jc = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    tc = dataclasses.replace(t_reduced(t_get_config("yi-9b")),
                             dtype="float32")
    rng = np.random.default_rng(0)
    b, c, t = 3, 5, 40
    q = rng.standard_normal((b, c, jc.num_heads, jc.head_dim), np.float32)
    k, v = (rng.standard_normal((b, t, jc.num_kv_heads, jc.head_dim),
                                np.float32) for _ in range(2))
    qpos = np.array([0, 17, 35])[:, None] + np.arange(c)     # 39 at most
    want = J.chunk_attention(jc, *map(jnp.asarray, (q, k, v, qpos)))
    got = T.chunk_attention(tc, *map(torch.from_numpy, (q, k, v, qpos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_prefill_chunk_matches_jax_and_drops_writes_past_the_end(models):
    """``prefill_chunk`` from a prefilled cache against JAX's: logits
    (1e-4) and caches (1e-5), with one row's chunk running 3 positions past
    the cache's end: those writes are dropped in both, and no row's other
    positions change."""
    jm, jp, tm, tp = models
    t, c = 64, 8
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, VOCAB, size=(2, t))
    toks = rng.integers(1, VOCAB, size=(2, c))
    pos0 = np.array([20, t - c + 3])
    _, jcache = jm.prefill(jp, jnp.asarray(prompt), t)
    tcache = bridge.caches_from_numpy(jax.tree.map(np.asarray, jcache),
                                      "cpu")
    before = [x.clone() for c_ in tcache for x in c_.values()]
    jl, jcache = jm.prefill_chunk(jp, jcache, jnp.asarray(toks),
                                  jnp.asarray(pos0))
    tl, tcache = tm.prefill_chunk(tp, tcache, torch.from_numpy(toks),
                                  torch.from_numpy(pos0))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for got, want in zip((x for c_ in tcache for x in c_.values()),
                         (x for c_ in jcache for x in c_.values())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    for old, new in zip(before, (x for c_ in tcache for x in c_.values())):
        # row 0: only positions 20..27 change; row 1: only 59..63
        torch.testing.assert_close(new[:, 0, :20], old[:, 0, :20])
        torch.testing.assert_close(new[:, 0, 28:], old[:, 0, 28:])
        torch.testing.assert_close(new[:, 1, :t - c + 3],
                                   old[:, 1, :t - c + 3])
    assert tm.prefill_chunk(tp, tcache, torch.from_numpy(toks),
                            torch.from_numpy(pos0), logits=False)[0] is None


# -- PrefixCache units -------------------------------------------------------

def _entry(chunk, fill, dtype=torch.float32, n_super=2):
    return [{"k": torch.full((n_super, chunk, 1, 4), fill, dtype=dtype),
             "v": torch.full((n_super, chunk, 1, 4), -fill, dtype=dtype)}]


def test_prefix_cache_lookup_and_insert_chain():
    pc = PrefixCache(4, budget_bytes=1 << 20)
    toks = np.arange(1, 13)
    assert pc.lookup(toks) == (0, None)
    assert not pc.insert(toks[:6], _entry(4, 1.0))     # not a chunk multiple
    assert not pc.insert(toks[:8], _entry(4, 2.0))     # ancestor missing
    assert pc.insert(toks[:4], _entry(4, 1.0))
    assert pc.insert(toks[:8], _entry(4, 2.0))
    assert pc.contains(toks[:8]) and not pc.contains(toks[:12])
    covered, entry = pc.lookup(toks)
    assert covered == 8
    k = entry[0]["k"]
    assert k.shape == (2, 8, 1, 4) and k.device.type == "cpu"
    assert torch.equal(k[:, :4], torch.ones(2, 4, 1, 4))
    assert torch.equal(k[:, 4:], torch.full((2, 4, 1, 4), 2.0))
    st = pc.stats()
    assert (st["hits"], st["misses"], st["entries"], st["hit_tokens"]) == (
        1, 1, 2, 8)
    assert pc.insert(toks[:4], _entry(4, 9.0))         # refresh, keep old
    assert torch.equal(pc.lookup(toks[:4])[1][0]["k"],
                       torch.ones(2, 4, 1, 4))


def test_prefix_cache_lru_evicts_and_prunes_descendants():
    one = 2 * 2 * 4 * 4 * 4               # bytes of one float32 entry
    pc = PrefixCache(4, budget_bytes=3 * one)
    a, b = np.arange(1, 9), np.arange(101, 109)
    pc.insert(a[:4], _entry(4, 1.0))
    pc.insert(a[:8], _entry(4, 2.0))
    pc.insert(b[:4], _entry(4, 3.0))
    assert pc.stats()["bytes"] == 3 * one and len(pc) == 3
    pc.lookup(b)                          # b's link is now the most recent
    pc.insert(b[:8], _entry(4, 4.0))      # over budget: evict a[:4] ...
    st = pc.stats()
    # ... and its descendant a[:8], unreachable without it
    assert st["evictions"] == 2 and len(pc) == 2 and st["bytes"] == 2 * one
    assert pc.lookup(a) == (0, None)
    assert pc.lookup(b)[0] == 8
    assert set(pc._root.children) == {tuple(int(t) for t in b[:4])}


def test_prefix_cache_adopt_keeps_chains():
    src = PrefixCache(4, budget_bytes=1 << 20)
    toks = np.arange(1, 13)
    for n in (4, 8, 12):
        src.insert(toks[:n], _entry(4, float(n)))
    src.lookup(toks[:4])                  # a child link now precedes it
    dst = PrefixCache(4, budget_bytes=1 << 20)
    assert dst.adopt_entries(src) == 3 and dst.lookup(toks)[0] == 12
    assert dst.adopt_entries(dst) == 0
    assert PrefixCache(8).adopt_entries(src) == 0


def test_prefix_cache_counts_bf16_bytes():
    """numpy has no bfloat16: entries are CPU tensors, counted as
    numel * element_size (2 bytes for bf16)."""
    pc = PrefixCache(4, budget_bytes=1 << 20)
    entry = _entry(4, 1.0, dtype=torch.bfloat16)
    assert pc.insert(np.arange(4), entry)
    assert pc.stats()["bytes"] == 2 * (2 * 4 * 1 * 4) * 2
    got = pc.lookup(np.arange(4))[1][0]["k"]
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
