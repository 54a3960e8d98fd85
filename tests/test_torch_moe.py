"""The port's MoE layer against the JAX package's (its single-rank path),
float32 on the CPU, from the same JAX-initialised params carried across as
numpy: routing, capacity buffers, the capacity layer with and without
drops, llama4's shared expert, and the dropless oracle."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels.grouped_matmul import ops as gmm_ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# f32 on both sides: summation order over d = 64 and the expert FFN
TOL = 2e-5
GRANITE = "granite-moe-1b-a400m"
LLAMA4 = "llama4-maverick-400b-a17b"


def _layer(arch, seed=0):
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), dtype="float32")
    jp, _ = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _x(cfg, b=2, s=24, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model), np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_route_matches_jax():
    jcfg, _, jp, tp = _layer(GRANITE)
    jx, tx = _x(jcfg)
    jw, ji, jaux = jax_moe._route(jp["router"], jx.reshape(-1, 64),
                                  jcfg.moe.top_k)
    tw, ti, taux = moe._route(tp["router"], tx.reshape(-1, 64),
                              jcfg.moe.top_k)
    # the expert ids, in JAX's descending gate order, exactly; the gates to
    # f32 rounding (XLA's and torch's exp differ in the last bit)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("capacity", [1, 3, 6, 40])
def test_expert_buffers_match_jax(capacity):
    """The vectorised rank-ordered scatter fills the same slots as JAX's
    per-expert loop, dropping the same overflow."""
    rng = np.random.default_rng(capacity)
    t, k, e, d = 30, 2, 8, 16
    idx = np.stack([rng.choice(e, size=k, replace=False) for _ in range(t)])
    w = rng.random((t, k)).astype(np.float32)
    x = rng.standard_normal((t, d), np.float32)
    jx, jw, jt, jv = jax_moe._expert_buffers(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx, jnp.int32),
        range(e), capacity)
    tx, tw, tt, tv = moe._expert_buffers(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx), e,
        capacity)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if capacity == 1:
        assert np.asarray(jv).sum() < t * k      # overflow was dropped


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_moe_apply_matches_jax(cf):
    """Reduced granite at its capacity factor (4.0) and at 1.0, where JAX
    drops assignments; the port drops the same ones."""
    jcfg, tcfg, jp, tp = _layer(GRANITE)
    jx, tx = _x(jcfg)
    jy, jaux = jax_moe.moe_apply(jp, jcfg, jx, None, None,
                                 capacity_factor=cf)
    before = gmm_ops.launches
    ty, taux = moe.moe_apply(tp, tcfg, tx, capacity_factor=cf)
    assert gmm_ops.launches == before      # CPU tensors: the plain version
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if cf == 1.0:
        xf = jx.reshape(-1, jcfg.d_model)
        w, i, _ = jax_moe._route(jp["router"], xf, jcfg.moe.top_k)
        cap = jax_moe._capacity(xf.shape[0], jcfg.moe.top_k,
                                jcfg.moe.num_experts, cf)
        valid = jax_moe._expert_buffers(xf, w, i, range(8), cap)[3]
        assert float(valid.sum()) < xf.shape[0] * jcfg.moe.top_k
        ref, _ = moe.moe_apply_ref(tp, tcfg, tx)      # dropless differs
        assert not np.allclose(ty.numpy(), ref.numpy(), atol=1e-3)


def test_llama4_shared_expert_matches_jax():
    jcfg, tcfg, jp, tp = _layer(LLAMA4)
    assert "shared" in tp
    jx, tx = _x(jcfg, seed=3)
    jy, _ = jax_moe.moe_apply(jp, jcfg, jx, None, None)
    ty, _ = moe.moe_apply(tp, tcfg, tx)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4])
def test_capacity_layer_matches_dropless_oracle(arch):
    """With capacity for every assignment, the buffered layer equals the
    dense dropless oracle, in the port and against JAX's oracle."""
    jcfg, tcfg, jp, tp = _layer(arch, seed=4)
    jx, tx = _x(jcfg, seed=5)
    cf = float(tcfg.moe.num_experts)       # capacity = every token
    ty, _ = moe.moe_apply(tp, tcfg, tx, capacity_factor=cf)
    ref, _ = moe.moe_apply_ref(tp, tcfg, tx)
    jref, _ = jax_moe.moe_apply_ref(jp, jcfg, jx)
    np.testing.assert_allclose(ty.numpy(), ref.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=TOL,
                               rtol=TOL)
