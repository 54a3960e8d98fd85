"""The port's dense transformer against the JAX package's, from the same
JAX-initialised params carried across as numpy (``repro_torch.models.params``).
Reduced yi-9b in float32 on the CPU: prefill caches and logits, then 16
decode steps of logits, then greedy tokens."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving.engine import greedy_generate as jax_greedy  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import greedy_generate  # noqa: E402

# f32 on both sides; the residual is summation order across two layers of
# 64-wide matmuls and a 503-way unembed (logits are O(10))
TOL = 2e-5
MAX_SEQ = 48


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(dtype="float32"):
    jcfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype=dtype)
    tcfg = dataclasses.replace(t_reduced(t_get_config("yi-9b")), dtype=dtype)
    eager = jax_build(jcfg)
    jp, _ = eager.init(jax.random.PRNGKey(0))
    # the same model functions, jitted: eager scans re-trace every call
    jm = SimpleNamespace(cfg=jcfg, init_cache=eager.init_cache,
                         prefill=jax.jit(eager.prefill, static_argnums=2),
                         decode=jax.jit(eager.decode))
    tm = build_model(tcfg, device="cpu")
    tp = bridge.params_from_numpy(_np_tree(jp), "cpu")
    return jm, jp, tm, tp


def _assert_tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bit_exact(dtype):
    jm, jp, tm, tp = _models(dtype)
    assert tp["blocks"][0]["attn"]["wq"].dtype == getattr(torch, dtype)
    assert tp["blocks"][0]["attn"]["wq"].shape == \
        jp["blocks"][0]["attn"]["wq"].shape      # leading n_super axis kept
    _assert_tree_equal(_np_tree(jp), bridge.params_to_numpy(tp))
    toks = np.random.default_rng(0).integers(1, 503, (2, 9))
    _, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), MAX_SEQ)
    jc = _np_tree(jc)
    tc = bridge.caches_from_numpy(jc, "cpu")
    assert tc[0]["k"].shape == jc[0]["k"].shape
    _assert_tree_equal(jc, bridge.caches_to_numpy(tc))


def test_port_init_matches_jax_layout_and_scales():
    """The port's own init draws every leaf with the JAX init's shape, dtype
    and scale (the numbers differ: torch.Generator is not jax.random)."""
    jm, jp, tm, _ = _models()
    tp = tm.init(torch.Generator().manual_seed(0))
    jl = jax.tree_util.tree_leaves_with_path(_np_tree(jp))
    tl = jax.tree_util.tree_leaves_with_path(bridge.params_to_numpy(tp))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.std() > 0:        # norms are zeros on both sides
            np.testing.assert_allclose(b.std(), a.std(), rtol=0.1)
        else:
            assert b.std() == 0


def test_bridge_rejects_foreign_trees():
    with pytest.raises(ValueError):
        bridge.params_from_numpy({"embed": {}}, "cpu")
    with pytest.raises(ValueError):
        bridge.caches_from_numpy([{"k": np.zeros(1)}], "cpu")


def test_prefill_and_decode_match_jax():
    jm, jp, tm, tp = _models()
    toks = np.random.default_rng(1).integers(1, 503, (2, 12))
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), MAX_SEQ)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks), MAX_SEQ)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=TOL, rtol=TOL)
        for a, b in zip(bridge.caches_to_numpy(tc), _np_tree(jc)):
            for key in ("k", "v"):
                np.testing.assert_allclose(a[key], b[key], atol=TOL, rtol=TOL)
        pos = np.full((2,), 12)
        # feed both models the JAX model's greedy tokens, so each step's
        # logits are compared on identical inputs
        nxt = np.asarray(jnp.argmax(jl[:, -1, :503], -1))
        for _ in range(16):
            jl, jc = jm.decode(jp, jc, jnp.asarray(nxt[:, None], jnp.int32),
                               jnp.asarray(pos, jnp.int32))
            tl, tc = tm.decode(tp, tc, torch.from_numpy(nxt[:, None].copy()),
                               torch.from_numpy(pos))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=TOL, rtol=TOL)
            nxt = np.asarray(jnp.argmax(jl[:, 0, :503], -1))
            np.testing.assert_array_equal(
                tl[:, 0, :503].argmax(-1).numpy(), nxt)
            pos = pos + 1


def test_greedy_tokens_match_jax():
    jm, jp, tm, tp = _models()
    rng = np.random.default_rng(2)
    for n in (5, 23):
        prompt = rng.integers(1, 503, size=n)
        np.testing.assert_array_equal(
            greedy_generate(tm, tp, prompt, 16, MAX_SEQ),
            jax_greedy(jm, jp, prompt, 16, MAX_SEQ))


def test_unported_configs_raise():
    for arch in ("qwen2-72b", "gemma2-27b", "mamba2-370m",
                 "granite-moe-1b-a400m"):
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(t_reduced(t_get_config(arch)), device="cpu")
