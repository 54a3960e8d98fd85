"""Speculative decoding of the port against the JAX package on the CPU,
float32. Engine cases port ``tests/test_speculative.py``: the same prompts
and settings go through the JAX engine and the port's (target and draft
params bridged from JAX), and the port's tokens must equal the JAX
engine's and the port's ``greedy_generate``, with every engine counter
(``spec_steps``, ``spec_proposed``, ``spec_accepted``, ``spec_emitted``, ...)
equal to the JAX engine's (tolerance 0). Then the drafts on their own,
``decode_verify`` and the draft's decode past the cache's end (writes
dropped), and the MoE and SSM declines."""
import dataclasses
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core.monitoring import Monitor as JaxMonitor  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving import speculative as JS  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.monitoring import Monitor  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import speculative as TS  # noqa: E402
from repro_torch.serving.engine import ServingEngine, greedy_generate  # noqa: E402,E501
from repro_torch.serving.replica import ReplicaSet  # noqa: E402

MAX_SEQ = 96
K = 4
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


@pytest.fixture(scope="module")
def drafts(models):
    """The draft model of both packages: JAX's, initialised from
    PRNGKey(1) as ``draft_model_for`` does, and the port's with those
    params bridged."""
    jm = models[0]
    jd = jax_build(JS.draft_model_config(jm.cfg))
    jdp, _ = jd.init(jax.random.PRNGKey(1))
    td = build_model(TS.draft_model_config(models[2].cfg), device="cpu")
    tdp = bridge.params_from_numpy(jax.tree.map(np.asarray, jdp), "cpu")
    return jd, jdp, td, tdp


def _engines(models, drafts=None, *, draft="ngram", monitor=False, **kw):
    """A JAX engine and a port engine with the same settings and drafts:
    ``draft`` names one kind for each package, or is one draft object (or
    None) that both engines share."""
    jm, jp, tm, tp = models
    kw.setdefault("slots", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("speculate", K)
    out = []
    for side, (eng_cls, mon_cls, model, params, extra) in enumerate((
            (JaxEngine, JaxMonitor, jm, jp, {}),
            (ServingEngine, Monitor, tm, tp, {"device": "cpu"}))):
        if draft == "ngram":
            d = (JS.NgramDraft, TS.NgramDraft)[side]()
        elif draft == "model":
            dm, dp = drafts[2 * side], drafts[2 * side + 1]
            d = (JS.ModelDraft, TS.ModelDraft)[side](
                dm, dp, slots=kw["slots"], max_seq=kw["max_seq"], **extra)
        else:
            d = draft          # None, or one draft object for both engines
        out.append(eng_cls(model, params, draft=d,
                           monitor=mon_cls() if monitor else None,
                           **kw, **extra))
    return out


def _run(models, engines, prompts, max_new=8, eos_id=-1, check_greedy=True):
    """Submit ``prompts`` to both engines, drain them, and check tokens
    (port == JAX engine == port greedy) and every counter."""
    _, _, tm, tp = models
    outs = []
    for eng in engines:
        futs = [eng.submit(p, max_new_tokens=max_new, eos_id=eos_id)
                for p in prompts]
        eng.run_until_idle()
        outs.append([f.result() for f in futs])
    jeng, eng = engines
    for p, want, got in zip(prompts, *outs):
        np.testing.assert_array_equal(got, want)
        if check_greedy:
            np.testing.assert_array_equal(
                got, greedy_generate(tm, tp, p, max_new, eng.max_seq))
    assert eng.metrics == jeng.metrics
    return outs[1]


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n) for n in lens]


# -- drafts on their own -----------------------------------------------------

def test_ngram_draft_prompt_lookup():
    class R:
        tokens = np.array([5, 1, 2, 3, 9, 1, 2, 3], np.int64)
        generated = []

    d = TS.NgramDraft(max_ngram=3)
    np.testing.assert_array_equal(d.propose([(0, R())], 4)[0], [9, 1, 2, 3])
    np.testing.assert_array_equal(d.propose([(0, R())], 7)[0],
                                  [9, 1, 2, 3, 3, 3, 3])


def test_ngram_draft_repeat_last_fallback():
    class R:
        tokens = np.array([4, 7, 11], np.int64)
        generated = [13]

    np.testing.assert_array_equal(TS.NgramDraft().propose([(0, R())], 3)[0],
                                  [13, 13, 13])


def test_ngram_draft_matches_jax_on_random_contexts():
    rng = np.random.default_rng(0)

    class R:
        def __init__(self, n):
            self.tokens = rng.integers(1, 6, size=n)
            self.generated = list(rng.integers(1, 6, size=3))

    items = [(i, R(n)) for i, n in enumerate((1, 2, 5, 9, 30, 64))]
    for k in (1, 4, 9):
        np.testing.assert_array_equal(TS.NgramDraft().propose(items, k),
                                      JS.NgramDraft().propose(items, k))


def test_draft_model_config_matches_jax_and_is_shared(models):
    for arch in ("yi-9b", "granite-moe-1b-a400m"):
        assert dataclasses.asdict(
            TS.draft_model_config(t_get_config(arch))) == dataclasses.asdict(
            JS.draft_model_config(get_config(arch)))
    full = TS.draft_model_config(t_get_config("yi-9b"))
    assert (full.d_model, full.num_layers, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == (
        2048, 2, 2, 1, 128, 5504, 64000)
    cfg = models[2].cfg
    a, b = TS.draft_model_for(cfg, "cpu"), TS.draft_model_for(cfg, "cpu")
    assert a[0] is b[0] and a[1] is b[1]
    assert a[0].cfg.padded_vocab == cfg.padded_vocab
    assert TS.draft_model_for(dataclasses.replace(
        cfg, dtype="bfloat16"), "cpu")[0] is not a[0]
    with pytest.raises(ValueError, match="unknown draft kind"):
        TS.build_draft("beam", cfg, slots=2, max_seq=32, device="cpu")


def test_model_draft_proposes_as_jax_past_the_cache_end(models, drafts):
    """The draft's k+1 greedy steps run past its cache's last position for
    a slot near the sequence limit (writes dropped in both packages); the
    proposals equal the JAX draft's, and ``syncs`` counts one prefill per
    slot."""
    jd, jdp, td, tdp = drafts
    jdraft = JS.ModelDraft(jd, jdp, slots=2, max_seq=MAX_SEQ)
    tdraft = TS.ModelDraft(td, tdp, slots=2, max_seq=MAX_SEQ, device="cpu")

    class R:
        def __init__(self, toks):
            self.tokens, self.generated = toks, []

    a, b = (R(p) for p in _prompts(1, MAX_SEQ - 2, 17))
    for _ in range(2):
        items = [(0, a), (1, b)]
        want = jdraft.propose(items, K)
        np.testing.assert_array_equal(tdraft.propose(items, K), want)
        a.generated.append(int(want[0, 0]))
        b.generated.extend(int(t) for t in want[1, :2])
    assert tdraft.syncs == 2


# -- token parity ------------------------------------------------------------

def test_spec_parity_across_prompt_lengths(models):
    engines = _engines(models)
    assert engines[1]._spec_ok
    _run(models, engines, _prompts(0, 1, 3, 15, 16, 17, 40))
    eng = engines[1]
    assert eng.metrics["spec_steps"] > 0
    assert eng.metrics["spec_emitted"] == eng.metrics["tokens"]


def test_spec_parity_with_model_draft(models, drafts):
    engines = _engines(models, drafts, draft="model")
    _run(models, engines, _prompts(1, 4, 12, 23))
    assert engines[1].metrics["spec_steps"] > 0
    assert engines[1].draft.syncs == 3


def test_spec_parity_mid_generation_eos(models):
    """EOS accepted mid-chain truncates the emission where the plain engine
    stops, EOS included."""
    _, _, tm, tp = models
    (p,) = _prompts(2, 9)
    plain = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    ref = greedy_generate(tm, tp, p, 16, MAX_SEQ)
    # the first token that differs from the one before it, or the fourth
    eos = int(next((t for t, u in zip(ref[1:], ref) if t != u), ref[3]))
    f_plain = plain.submit(p, max_new_tokens=16, eos_id=eos)
    plain.run_until_idle()
    got = _run(models, _engines(models), [p], max_new=16, eos_id=eos,
               check_greedy=False)[0]
    np.testing.assert_array_equal(got, f_plain.result())
    assert int(got[-1]) == eos and len(got) <= 16


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_spec_parity_at_sequence_limit(models, drafts, draft):
    """A prompt near max_seq: verify's candidate positions (and the model
    draft's steps) run past the cache's end, with the writes dropped, and
    emission stops at the sequence limit, like the plain engine."""
    _, _, tm, tp = models
    (p,) = _prompts(3, MAX_SEQ - 4)
    plain = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    f_plain = plain.submit(p, max_new_tokens=16)
    plain.run_until_idle()
    got = _run(models, _engines(models, drafts, draft=draft, slots=2), [p],
               max_new=16, check_greedy=False)[0]
    np.testing.assert_array_equal(got, f_plain.result())
    assert len(got) == MAX_SEQ - len(p) == 4


class _PartlyWrongDraft:
    """The n-gram draft with its proposal ``len(context) % (k + 1)`` made
    wrong, so steps accept 0..k tokens and roll back the rest. Pure numpy:
    the same object drives the JAX engine and the port's."""

    def propose(self, items, k):
        out = TS.NgramDraft().propose(items, k)
        for row, (_slot, r) in enumerate(items):
            j = (len(r.tokens) + len(r.generated)) % (k + 1)
            if j < k:
                out[row, j] = (out[row, j] + 1) % VOCAB
        return out


def test_spec_parity_with_rejected_proposals(models):
    engines = _engines(models, draft=_PartlyWrongDraft())
    _run(models, engines, _prompts(11, 5, 18, 33), max_new=12)
    m = engines[1].metrics
    assert 0 < m["spec_accepted"] < m["spec_proposed"]
    assert m["spec_emitted"] == m["tokens"] == 36


def test_spec_single_token_budget(models):
    _run(models, _engines(models), _prompts(4, 7), max_new=1)


def test_spec_with_chunked_prefill_interleave(models, drafts):
    for draft in ("ngram", "model"):
        engines = _engines(models, drafts, draft=draft, chunk_tokens=16)
        assert engines[1]._chunk_ok and engines[1]._spec_ok
        _run(models, engines, _prompts(5, 60, 6, 9))
        assert engines[1].metrics["prefill_chunks"] > 0
        assert engines[1].metrics["spec_steps"] > 0


# -- verify at the cache's end -----------------------------------------------

def test_decode_verify_matches_jax_past_the_cache_end(models):
    """``decode_verify`` from a prefilled cache against JAX's, with one
    row's candidates running 2 positions past the end: logits 1e-4, caches
    1e-5 (the overflowing writes dropped in both)."""
    jm, jp, tm, tp = models
    t = 48
    rng = np.random.default_rng(6)
    prompt = rng.integers(1, VOCAB, size=(2, t))
    cand = rng.integers(1, VOCAB, size=(2, K + 1))
    pos = np.array([10, t - K + 1])
    _, jcache = jm.prefill(jp, jnp.asarray(prompt), t)
    tcache = bridge.caches_from_numpy(jax.tree.map(np.asarray, jcache),
                                      "cpu")
    jl, jcache = jm.decode_verify(jp, jcache, jnp.asarray(cand),
                                  jnp.asarray(pos))
    tl, tcache = tm.decode_verify(tp, tcache, torch.from_numpy(cand),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for tc, jc in zip(tcache, jcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=1e-5, rtol=1e-5)


# -- fallbacks ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m"])
def test_moe_and_ssm_models_decline_speculation(arch):
    """MoE and SSM models degrade to the plain fused decode with the JAX
    engine's monitor reason, and the tokens stay the JAX engine's."""
    pair = _pair_models(arch)
    engines = _engines(pair, slots=2, monitor=True)
    assert not engines[1]._spec_ok
    _run(pair, engines, _prompts(6, 20, 12), max_new=5, check_greedy=False)
    assert engines[1].metrics["spec_steps"] == 0
    jev, ev = ([{k: v for k, v in e.items() if k != "t"}
                for e in eng.monitor.events(eng.name)] for eng in engines)
    assert ev == jev and ev[0]["event"] == "speculative_unsupported"


def test_no_draft_declines_speculation(models):
    engines = _engines(models, draft=None, monitor=True, slots=2)
    assert not engines[1]._spec_ok
    _run(models, engines, _prompts(7, 10), max_new=3)
    (ev,) = engines[1].monitor.events(engines[1].name)
    assert ev["reason"] == "no draft engine configured"


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m"])
def test_build_paths_skip_draft_on_unsupported_arch(arch):
    rs = serve.build_replicaset(arch, replicas=1, slots=2, max_seq=MAX_SEQ,
                                speculate=K, draft="model", device="cpu")
    eng = rs.engines[0]
    assert eng.draft is None and not eng._spec_ok
    assert not TS.supports_speculation(eng.model, MAX_SEQ)
    rs = serve.build_replicaset("yi-9b", replicas=1, slots=2, max_seq=MAX_SEQ,
                                speculate=K, draft="model", device="cpu")
    assert isinstance(rs.engines[0].draft, TS.ModelDraft)
    assert rs.engines[0]._spec_ok


# -- lifecycle ---------------------------------------------------------------

def test_failover_mid_speculation(models):
    """A speculating replica killed mid-flight: rescheduled requests re-sync
    on the successor and finish token-identical to greedy decode."""
    _, _, tm, tp = models
    rs = ReplicaSet(lambda i, devs: ServingEngine(
        tm, tp, slots=2, max_seq=MAX_SEQ, name=f"spec{i}", speculate=K,
        draft=TS.NgramDraft(), device="cpu"), replicas=2, respawn=True,
        devices=[torch.device("cpu")])
    rs.start()
    try:
        rng = np.random.default_rng(8)
        prompts = [rng.integers(1, VOCAB, size=int(n))
                   for n in rng.integers(5, 25, size=4)]
        reqs = [rs.submit_request(p, max_new_tokens=10) for p in prompts]
        rs.engines[0].kill()
        deadline = time.monotonic() + 60
        while rs.metrics()["failovers"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        for p, r in zip(prompts, reqs):
            np.testing.assert_array_equal(
                r.future.result(timeout=120),
                greedy_generate(tm, tp, p, 10, MAX_SEQ))
        m = rs.metrics()
        assert m["failovers"] >= 1
        assert m["speculative"]["steps"] > 0
        assert 0.0 <= m["speculative"]["accept_rate"] <= 1.0
    finally:
        rs.stop()


def test_model_draft_slot_reuse_resyncs(models, drafts):
    """A slot reused by a new request re-syncs the draft from the new
    context."""
    engines = _engines(models, drafts, draft="model", slots=1)
    rng = np.random.default_rng(9)
    for _ in range(2):                    # sequential requests share slot 0
        _run(models, engines,
             [rng.integers(1, VOCAB, size=int(rng.integers(5, 15)))],
             max_new=6)
    assert engines[1].draft.syncs == 2


# -- observability -----------------------------------------------------------

def test_spec_gauges_and_metrics(models):
    engines = _engines(models, monitor=True)
    _run(models, engines, _prompts(10, 8, 8, 8), max_new=10)
    eng = engines[1]
    m = eng.metrics
    assert m["spec_steps"] > 0 and m["spec_emitted"] == m["tokens"]
    assert m["spec_proposed"] >= m["spec_accepted"] >= 0
    assert m["decode_steps"] < m["tokens"]
    rate = eng.monitor.gauge_stats(eng.name, "spec_accept_rate")
    per_step = eng.monitor.gauge_stats(eng.name, "spec_tokens_per_step")
    assert rate["n"] > 0 and 0.0 <= rate["last"] <= 1.0
    assert per_step["n"] > 0 and per_step["last"] >= 1.0
