"""The hybrid family (zamba2: Mamba2 segments, one shared attention+MLP block
applied after each, trailing Mamba2 layers) of the port against the JAX
package on the CPU, float32, reduced (14 layers: two segments of 6, two
applications, 2 trailing), params JAX-initialised and bridged, with the
zero-initialised norms drawn at random on both sides. Logits over prefill
plus 16 decode steps agree to 1e-4 (f32 summation order; the port runs the
chunked SSD op on every length, JAX its sequential scan off the chunk
grid); engine tokens and every engine counter equal the JAX engine's."""
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
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.speculative import NgramDraft as JaxNgram  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.monitoring import Monitor  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.serving.engine import (ServingEngine, _padding_safe,  # noqa: E402,E501
                                        greedy_generate)
from repro_torch.serving.speculative import NgramDraft  # noqa: E402

ARCH = "zamba2-1.2b"
TOL = 1e-4
VOCAB = 503


def _perturb(tree, seed=0):
    """Every all-zero leaf (the norm weights) drawn from N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size and not x.any():
            return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    jcfg = dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype)
    eager = JM.build_model(jcfg)
    jp, _ = eager.init(jax.random.PRNGKey(0))
    jp = jax.tree.map(jnp.asarray, _perturb(jp))
    jm = SimpleNamespace(cfg=jcfg, eager=eager,
                         prefill=jax.jit(eager.prefill, static_argnums=2),
                         decode=jax.jit(eager.decode))
    tcfg = dataclasses.replace(t_reduced(t_get_config(ARCH)), dtype=dtype)
    tm = TM.build_model(tcfg, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=n) for n in lens]


def test_layout_and_kernels():
    """Two segments of 6, two shared-block applications, 2 trailing layers;
    the model's path launches SSD and flash attention; no chunk or verify
    mode, and never padding-safe."""
    _, _, tm, _ = _pair()
    assert TM._hybrid_layout(tm.cfg) == (6, 2, 2)
    assert TM._hybrid_layout(t_get_config(ARCH)) == (6, 6, 2)
    assert tm.kernel_ops == (ssd_ops, flash_ops)
    assert not hasattr(tm, "prefill_chunk") and not hasattr(tm,
                                                            "decode_verify")
    assert not _padding_safe(tm, 2048)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_init_matches_jax_layout_and_bridge_round_trip(dtype):
    """The port's init gives JAX's tree, the shared block unstacked (no
    leading axis) beside the stacked Mamba layers; params and the (Mamba,
    attention) cache pair cross the bridge bit for bit, every leaf in its
    dtype (the SSD state and A_log, D, dt_bias f32)."""
    jm, jp, tm, tp = _pair(dtype)
    mine = bridge.params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    jl = jax.tree_util.tree_leaves_with_path(_np_tree(jp))
    tl = jax.tree_util.tree_leaves_with_path(mine)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert tp["shared"]["attn"]["wq"].shape == (64, 4, 16)
    assert tp["shared"]["ln1"].shape == (64,)
    assert tp["mamba"]["ln"].shape == (14, 64)
    for a, b in zip(jax.tree.leaves(_np_tree(jp)),
                    jax.tree.leaves(bridge.params_to_numpy(tp))):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    toks = np.random.default_rng(0).integers(1, VOCAB, (2, 9))
    _, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), 48)
    jc = _np_tree(jc)
    tc = bridge.caches_from_numpy(jc, "cpu")
    assert isinstance(tc, tuple) and tc[1]["k"].shape == (2, 2, 48, 2, 16)
    assert tc[0]["ssd"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(jc),
                    jax.tree.leaves(bridge.caches_to_numpy(tc))):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("s", [37, 64])
def test_prefill_and_decode_logits_match_jax(s):
    """Prefill (off and on the 32-token chunk grid) then 16 decode steps:
    logits and every cache leaf (conv windows, SSD states, the shared
    block's K/V) within 1e-4."""
    jm, jp, tm, tp = _pair()
    max_seq = 96
    toks = np.random.default_rng(s).integers(1, VOCAB, (2, s))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_seq)

    def same_caches(tc, jc):
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(
                    bridge.caches_to_numpy(tc)),
                jax.tree_util.tree_leaves_with_path(_np_tree(jc))):
            assert a.shape == b.shape, path
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                       err_msg=str(path))
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_seq)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        same_caches(tc, jc)
        pos = np.full((2,), s)
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
        same_caches(tc, jc)


def _engines(monitor=False, **kw):
    jm, jp, tm, tp = _pair()
    return [JaxEngine(jm.eager, jp, monitor=JaxMonitor() if monitor else None,
                      draft=JaxNgram() if kw.get("speculate") else None,
                      **kw),
            ServingEngine(tm, tp, monitor=Monitor() if monitor else None,
                          draft=NgramDraft() if kw.get("speculate") else None,
                          device="cpu", **kw)]


def _run(engines, prompts, max_new):
    _, _, tm, tp = _pair()
    outs = []
    for eng in engines:
        futs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run_until_idle()
        outs.append([f.result() for f in futs])
    jeng, eng = engines
    for p, want, got in zip(prompts, *outs):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, greedy_generate(tm, tp, p, max_new, eng.max_seq))
    assert eng.metrics == jeng.metrics


def test_engine_tokens_match_jax_engine():
    """3 slots, max_seq 96: exact per-length groups ({5, 9, 5} in two
    calls), a prompt past a chunk and one on the chunk grid; slots reused,
    so an admitted slot's Mamba state and K/V replace the last request's."""
    engines = _engines(slots=3, max_seq=96)
    assert not engines[1]._pad_ok
    _run(engines, _prompts(3, 5, 9, 5, 33, 64), max_new=12)
    assert engines[1].metrics["prefills"] == 4


def test_declines_chunking_and_speculation():
    """No ``prefill_chunk`` or ``decode_verify``: chunking and speculation
    fall back with the JAX engine's monitor events, tokens exact."""
    engines = _engines(monitor=True, slots=2, max_seq=96, chunk_tokens=16,
                       speculate=4)
    assert not engines[1]._chunk_ok and not engines[1]._spec_ok
    _run(engines, _prompts(6, 20, 40), max_new=6)
    assert engines[1].metrics["prefill_chunks"] == 0
    assert engines[1].metrics["spec_steps"] == 0
    jev, ev = ([{k: v for k, v in e.items() if k != "t"}
                for e in eng.monitor.events(eng.name)] for eng in engines)
    assert ev == jev
    assert [e["event"] for e in ev] == ["chunked_prefill_unsupported",
                                        "speculative_unsupported"]


def test_build_replicaset_serves_the_hybrid_on_the_cpu():
    """``build_replicaset`` by arch name (reduced) through ``run_load``;
    speculation asked of the hybrid builds no draft."""
    rs = serve.build_replicaset(ARCH, replicas=1, slots=2, max_seq=64,
                                speculate=4, draft="model", device="cpu")
    assert rs.engines[0].draft is None
    rs.start()
    try:
        report = serve.run_load(rs, _prompts(8, 40, 9, 33), rate_rps=50.0,
                                max_new_tokens=8,
                                rng=np.random.default_rng(0),
                                timeout_s=120.0)
    finally:
        rs.stop()
    assert report["completed"] == 3 and report["tokens"] == 24
    assert (flash_ops.launches, ssd_ops.launches) == (0, 0)


def test_cli_serves_a_vres_hybrid_arch_and_replays_it(tmp_path, capsys):
    """A VRE whose ``arch`` is zamba2 (provider ``cpu``: the reduced
    config) serves through ``cli serve --record``; the header names the
    arch, and a pool rebuilt from it replays every record's tokens."""
    import json

    from repro_torch import cli
    from repro_torch.observability import RecordStore

    d = tmp_path / "dep"
    cli.main(["init", "cpu", str(d)])
    raw = json.loads((d / "vre.json").read_text())
    raw.update(arch=ARCH, services=[])
    raw["extra"].update(replicas=1, slots=2, max_seq=64)
    (d / "vre.json").write_text(json.dumps(raw))
    rec = tmp_path / "rec.jsonl"
    capsys.readouterr()
    cli.main(["serve", "--dir", str(d), "--requests", "3", "--rate", "0",
              "--max-new", "4", "--seed", "1", "--record", str(rec)])
    report = json.loads(capsys.readouterr().out)
    assert report["completed"] == 3 and report["tokens"] == 12
    store = RecordStore.load(rec)
    assert (store.meta["arch"], store.meta["provider"]) == (ARCH, "cpu")
    assert len(store) == 4                    # with the warmup's
    replay = serve.replay_file(rec, device="cpu")
    assert replay["token_parity"] == 1.0 and not replay["mismatches"]
