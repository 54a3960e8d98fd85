"""The sliding-window families of the port against the JAX package on the
CPU, float32, reduced, params JAX-initialised and bridged: gemma2 (local and
global subs alternating, softcaps, post norms), gemma3 (5 local + 1 global,
QK norm, two rope thetas) and qwen2 (QKV bias). Every zero-initialised leaf
(norms, biases) is drawn at random first, on both sides, so the features
they switch on change the numbers.

Reduced configs set the window to 32 (``configs/base.py``), so gemma2 and
gemma3 keep rolling caches at any ``max_seq`` above 32; at ``max_seq`` 32
gemma2 is all-global, padding-safe, and takes chunked prefill, the prefix
cache and speculation. Logits over prefill plus 16 decode steps agree to
1e-4 (f32 summation order over up to 12 layers); engine tokens and every
engine counter equal the JAX engine's."""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.core.monitoring import Monitor as JaxMonitor  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import speculative as JS  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache  # noqa: E402,E501
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.monitoring import Monitor  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.serving import speculative as TS  # noqa: E402
from repro_torch.serving.engine import (ServingEngine, _padding_safe,  # noqa: E402,E501
                                        greedy_generate)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402

TOL = 1e-4
VOCAB = 503
GEMMA2, GEMMA3, QWEN2 = "gemma2-27b", "gemma3-12b", "qwen2-72b"


def _perturb(tree, seed=0):
    """Every all-zero leaf (norm weights, QKV biases) drawn from N(0, 0.1²)
    in its dtype, so post norms, QK norms and biases are not identities."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size and not x.any():
            return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model with jitted prefill/decode, its params, port model, the
    same params bridged)."""
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    eager = JM.build_model(jcfg)
    jp, _ = eager.init(jax.random.PRNGKey(0))
    jp = jax.tree.map(jnp.asarray, _perturb(jp))
    jm = SimpleNamespace(cfg=jcfg, eager=eager, init_cache=eager.init_cache,
                         prefill=jax.jit(eager.prefill, static_argnums=2),
                         decode=jax.jit(eager.decode))
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)),
                               dtype="float32")
    tm = TM.build_model(tcfg, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@functools.lru_cache(maxsize=None)
def _drafts(arch):
    """The draft model of both packages for ``arch``: JAX's from
    PRNGKey(1), as its ``draft_model_for`` draws it, and the port's with
    those params bridged."""
    jcfg, tcfg = _pair(arch)[0].cfg, _pair(arch)[2].cfg
    jd = JM.build_model(JS.draft_model_config(jcfg))
    jdp, _ = jd.init(jax.random.PRNGKey(1))
    td = TM.build_model(TS.draft_model_config(tcfg), device="cpu")
    return jd, jdp, td, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jdp), "cpu")


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n) for n in lens]


# -- layout -------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GEMMA2, GEMMA3, QWEN2])
def test_port_init_matches_jax_layout(arch):
    """The port's init gives JAX's tree: bq/bk/bv (qwen2), q_norm/k_norm
    (gemma3), post_ln1/post_ln2 (gemma2, gemma3), stacked on n_super, with
    the same shapes and dtypes; the bridge carries it bit for bit."""
    jm, jp, tm, tp = _pair(arch)
    mine = bridge.params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    tl = jax.tree_util.tree_leaves_with_path(mine)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    names = {str(p[-1].key) for p, _ in tl}
    want = {GEMMA2: {"post_ln1", "post_ln2"},
            GEMMA3: {"post_ln1", "post_ln2", "q_norm", "k_norm"},
            QWEN2: {"bq", "bk", "bv"}}[arch]
    assert want <= names
    back = bridge.params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_cache_lengths_follow_the_window():
    """Each sub's cache is its window where the window is shorter than
    max_seq: gemma3 at max_seq 2048 gives its local subs 1024 and its global
    sub 2048; full-width gemma2 (window 4096) keeps 2048 everywhere and is
    padding-safe, gemma3 is not."""
    g3 = TM.build_model(t_get_config(GEMMA3), device="cpu")
    caches = g3.init_cache(4, 2048, "meta")
    assert [c["k"].shape[2] for c in caches] == [1024] * 5 + [2048]
    assert caches[0]["k"].shape == (8, 4, 1024, 8, 256)
    g2 = TM.build_model(t_get_config(GEMMA2), device="cpu")
    assert [c["k"].shape[2] for c in g2.init_cache(4, 2048, "meta")] == \
        [2048, 2048]
    assert _padding_safe(g2, 2048) and not _padding_safe(g3, 2048)
    small = _pair(GEMMA2)[2]
    assert _padding_safe(small, 32) and not _padding_safe(small, 33)


# -- the rolling pieces against JAX's ----------------------------------------

@pytest.mark.parametrize("s,w", [(45, 32), (64, 32), (32, 32), (20, 32)])
def test_prefill_cache_matches_jax(s, w):
    """The last w positions, position p in slot p % w (zero-padded when the
    prompt is shorter)."""
    rng = np.random.default_rng(s)
    k, v = (rng.standard_normal((2, s, 2, 16), np.float32) for _ in "kv")
    jk, jv = JM._build_prefill_cache(jnp.asarray(k), jnp.asarray(v), w)
    tk, tv = TM._build_prefill_cache(torch.from_numpy(k), torch.from_numpy(v),
                                     w)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_rolling_decode_attention_and_writes_match_jax():
    """A decode step at positions before, at and past the window: the slot
    written (pos % W, every row kept) and the attention over the slots that
    hold positions >= 0."""
    cfg = _pair(GEMMA3)[2].cfg
    jcfg = _pair(GEMMA3)[0].cfg
    rng = np.random.default_rng(0)
    w = 32
    pos = np.array([3, 31, 32, 77])
    q = rng.standard_normal((4, 1, cfg.num_heads, cfg.head_dim), np.float32)
    kc, vc = (rng.standard_normal((4, w, cfg.num_kv_heads, cfg.head_dim),
                                  np.float32) for _ in "kv")
    want = JM._decode_attn_rolling(jcfg, jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos), w)
    got = TM._decode_attn_rolling(cfg, torch.from_numpy(q),
                                  torch.from_numpy(kc), torch.from_numpy(vc),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    rows, slots, r, j = TM._write_index(torch.from_numpy(pos), 1, w,
                                        rolling=True)
    assert rows.tolist() == [0, 1, 2, 3] and slots.tolist() == [3, 31, 0, 13]
    # a global cache drops the write past its end instead
    rows, slots, _, _ = TM._write_index(torch.from_numpy(pos), 1, 64)
    assert rows.tolist() == [0, 1, 2] and slots.tolist() == [3, 31, 32]


# -- logits over prefill and 16 decode steps ----------------------------------

# (arch, prompt length, max_seq): gemma2 rolling (prompt and decode past the
# window) and all-global (max_seq 32), gemma3 rolling, qwen2
LOGIT_CASES = [(GEMMA2, 40, 64), (GEMMA2, 12, 32), (GEMMA3, 40, 64),
               (GEMMA3, 20, 64), (QWEN2, 12, 48)]


@pytest.mark.parametrize("arch,s,max_seq", LOGIT_CASES)
def test_prefill_and_decode_logits_match_jax(arch, s, max_seq):
    jm, jp, tm, tp = _pair(arch)
    toks = np.random.default_rng(s).integers(1, VOCAB, (2, s))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_seq)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_seq)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(
                    bridge.caches_to_numpy(tc)),
                jax.tree_util.tree_leaves_with_path(
                    jax.tree.map(np.asarray, jc))):
            assert a.shape == b.shape, path
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                       err_msg=str(path))
        pos = np.full((2,), s)
        # both models get the JAX model's greedy tokens, so every step's
        # logits are compared on the same inputs
        nxt = np.asarray(jnp.argmax(jl[:, -1, :VOCAB], -1))
        for _ in range(16):
            jl, jc = jm.decode(jp, jc, jnp.asarray(nxt[:, None], jnp.int32),
                               jnp.asarray(pos, jnp.int32))
            tl, tc = tm.decode(tp, tc, torch.from_numpy(nxt[:, None].copy()),
                               torch.from_numpy(pos))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                       rtol=TOL)
            nxt = np.asarray(jnp.argmax(jl[:, 0, :VOCAB], -1))
            pos = pos + 1
        for a, b in zip(jax.tree.leaves(bridge.caches_to_numpy(tc)),
                        jax.tree.leaves(jax.tree.map(np.asarray, jc))):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


# -- the engine ---------------------------------------------------------------

def _engines(arch, *, monitor=False, prefix_mb=0, draft=None, **kw):
    """A JAX engine and a port engine of ``arch`` with the same settings;
    ``draft`` "ngram" or "model" gives each its own package's draft."""
    jm, jp, tm, tp = _pair(arch)
    out = []
    for side, (eng_cls, mon_cls, pc_cls, model, params, extra) in enumerate((
            (JaxEngine, JaxMonitor, JaxPrefixCache, jm.eager, jp, {}),
            (ServingEngine, Monitor, PrefixCache, tm, tp,
             {"device": "cpu"}))):
        d = None
        if draft == "ngram":
            d = (JS.NgramDraft, TS.NgramDraft)[side]()
        elif draft == "model":
            dm, dp = _drafts(arch)[2 * side:2 * side + 2]
            d = (JS.ModelDraft, TS.ModelDraft)[side](
                dm, dp, slots=kw["slots"], max_seq=kw["max_seq"], **extra)
        mon = mon_cls() if monitor else None
        pc = pc_cls(kw["chunk_tokens"], budget_bytes=int(prefix_mb * 2**20),
                    monitor=mon) if prefix_mb else None
        out.append(eng_cls(model, params, monitor=mon, prefix_cache=pc,
                           draft=d, **kw, **extra))
    return out


def _run(arch, engines, prompts, max_new):
    """Both engines serve ``prompts`` (submitted in order); tokens equal the
    JAX engine's, and the port's greedy oracle's where the request ends
    before max_seq; every counter equal."""
    _, _, tm, tp = _pair(arch)
    outs = []
    for eng in engines:
        futs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run_until_idle()
        outs.append([f.result() for f in futs])
    jeng, eng = engines
    for p, want, got in zip(prompts, *outs):
        np.testing.assert_array_equal(got, want)
        if len(p) + max_new < eng.max_seq:
            np.testing.assert_array_equal(
                got, greedy_generate(tm, tp, p, max_new, eng.max_seq))
    assert eng.metrics == jeng.metrics
    if eng.prefix_cache is not None:
        assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    return outs[1]


@pytest.mark.parametrize("arch", [GEMMA2, GEMMA3, QWEN2])
def test_engine_tokens_match_jax_engine(arch):
    """The JAX tests' engine (3 slots, max_seq 96): gemma2 and gemma3 are
    rolling there and take exact per-length groups ({5, 9, 5} in two
    calls), with prompts and decodes past the window; qwen2 takes one
    padded batched prefill. Slots are reused."""
    engines = _engines(arch, slots=3, max_seq=96)
    rolling = arch != QWEN2
    assert engines[1]._pad_ok == (not rolling)
    prompts = _prompts(3, 5, 9, 5, 40, 70)
    _run(arch, engines, prompts, max_new=20)
    if rolling:
        # {5, 9, 5} then {40, 70} as slots free
        assert engines[1].metrics["prefills"] == 4


@pytest.mark.parametrize("arch", [GEMMA2, GEMMA3])
def test_rolling_models_decline_chunking_and_speculation(arch):
    """Rolling at max_seq 96: chunking and speculation fall back to the
    whole-prompt path and the plain decode with the JAX engine's monitor
    events, and the tokens stay exact; ``prefill_chunk`` on a rolling cache
    raises instead of writing past the window."""
    engines = _engines(arch, slots=2, max_seq=96, chunk_tokens=16,
                       speculate=4, draft="ngram", monitor=True)
    assert not engines[1]._chunk_ok and not engines[1]._spec_ok
    _run(arch, engines, _prompts(10, 20, 50), max_new=6)
    assert engines[1].metrics["prefill_chunks"] == 0
    assert engines[1].metrics["spec_steps"] == 0
    jev, ev = ([{k: v for k, v in e.items() if k != "t"}
                for e in eng.monitor.events(eng.name)] for eng in engines)
    assert ev == jev
    assert [e["event"] for e in ev] == ["chunked_prefill_unsupported",
                                        "speculative_unsupported"]
    tm = _pair(arch)[2]
    with pytest.raises(ValueError, match="rolling"):
        tm.prefill_chunk(_pair(arch)[3], tm.init_cache(1, 96),
                         torch.ones((1, 8), dtype=torch.long),
                         torch.tensor([0]))


# -- gemma2 at max_seq 32: all-global, padding-safe ---------------------------

G2_SEQ = 32


def test_gemma2_padding_safe_chunked_prefill_and_prefix_hits():
    """Chunks of 8 (prompts on and off the chunk grid), then a 16-token
    shared head: a hit restores it, and the head alone is covered whole."""
    engines = _engines(GEMMA2, slots=3, max_seq=G2_SEQ, chunk_tokens=8,
                       prefix_mb=1)
    assert engines[1]._chunk_ok
    _run(GEMMA2, engines, _prompts(1, 5, 12, 24, 16), max_new=6)
    assert engines[1].metrics["prefill_chunks"] > 0
    head = _prompts(2, 16)[0]
    tails = _prompts(3, 4, 7)
    for p in ([np.concatenate([head, tails[0]])],
              [np.concatenate([head, tails[1]]), head]):
        _run(GEMMA2, engines, p, max_new=5)
    assert engines[1].metrics["prefix_hit_tokens"] >= 32


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_gemma2_padding_safe_speculation(draft):
    """Speculate 4 with each draft, one prompt running into max_seq (25 +
    10 > 32) and one with chunked prefill beside it."""
    engines = _engines(GEMMA2, slots=3, max_seq=G2_SEQ, speculate=4,
                       draft=draft)
    assert engines[1]._spec_ok
    _run(GEMMA2, engines, _prompts(4, 5, 13, 25), max_new=10)
    assert engines[1].metrics["spec_steps"] > 0
    engines = _engines(GEMMA2, slots=2, max_seq=G2_SEQ, speculate=4,
                       draft=draft, chunk_tokens=8)
    _run(GEMMA2, engines, _prompts(5, 6, 20), max_new=6)
    assert engines[1].metrics["spec_steps"] and \
        engines[1].metrics["prefill_chunks"]


# -- entry points -------------------------------------------------------------

def test_build_replicaset_serves_rolling_archs_on_the_cpu():
    """``build_replicaset`` by arch name (reduced) through ``run_load``;
    speculation asked of a rolling arch builds no draft. A qwen2 cut in
    depth writes the cut into its record header."""
    for arch in (GEMMA3, QWEN2):
        rs = serve.build_replicaset(arch, replicas=1, slots=2, max_seq=64,
                                    speculate=4, draft="model", device="cpu")
        eng = rs.engines[0]
        assert (eng.draft is None) == (arch == GEMMA3)
        rs.start()
        try:
            prompts = _prompts(8, 40, 9, 33)
            report = serve.run_load(rs, prompts, rate_rps=50.0,
                                    max_new_tokens=8,
                                    rng=np.random.default_rng(0),
                                    timeout_s=120.0)
        finally:
            rs.stop()
        assert report["completed"] == 3 and report["tokens"] == 24
        assert flash_ops.launches == 0       # CPU tensors: plain version
    cut = dataclasses.replace(t_get_config(QWEN2), num_layers=16)
    meta = serve.record_meta(cut, {"slots": 4})
    assert meta["arch"] == QWEN2 and meta["provider"] == "h100"
    assert meta["model"] == {"num_layers": 16}
    assert serve.model_config(QWEN2, "h100", meta["model"]) == cut
