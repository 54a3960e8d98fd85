"""The port's flash attention op (plain version on CPU tensors) against the
JAX package's Pallas kernel in interpret mode, its jnp oracle and
``layers.attention``, over the sweep of tests/test_kernels.py. Inputs are
made with numpy from a seed and handed to both frameworks."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402

SWEEP = [
    (128, 4, 4, 32, 0, 0.0),          # MHA
    (192, 4, 2, 64, 0, 0.0),          # GQA, non-multiple seq (padding path)
    (128, 4, 2, 32, 48, 0.0),         # sliding window
    (128, 2, 2, 64, 0, 30.0),         # logit softcap (gemma2)
    (96, 8, 1, 32, 32, 50.0),         # MQA + window + cap
]
# the tolerances of tests/test_kernels.py: f32 agrees to summation order;
# bf16 differs by output rounding (the kernel keeps probabilities in f32)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(s, h, kv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, s, h, d), np.float32)
    k = rng.standard_normal((2, s, kv, d), np.float32)
    v = rng.standard_normal((2, s, kv, d), np.float32)
    # round to the working dtype once, so both frameworks see the same bits
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in (jq, jk, jv))
    return (jq, jk, jv), (tq, tk, tv)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("s,h,kv,d,win,cap", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_flash_matches_pallas_kernel(s, h, kv, d, win, cap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(s, h, kv, d, dtype)
    before = ops.launches
    out = ops.flash_attention(tq, tk, tv, window=win, softcap=cap)
    assert ops.launches == before          # CPU tensors: the plain version
    assert out.dtype == tq.dtype and out.shape == tq.shape
    pallas = jax_flash(jq, jk, jv, window=win, softcap=cap, block_q=64,
                       block_kv=64)
    g = h // kv
    ref = jax_ref(jq.transpose(0, 2, 1, 3),
                  jnp.repeat(jk, g, 2).transpose(0, 2, 1, 3),
                  jnp.repeat(jv, g, 2).transpose(0, 2, 1, 3),
                  window=win, softcap=cap).transpose(0, 2, 1, 3)
    tol = TOL[dtype]
    for want in (pallas, ref):
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(attention_ref(tq, tk, tv, window=win, softcap=cap)), _np(ref),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("s,h,kv,d,win,cap", SWEEP)
def test_port_attention_matches_layers_attention(s, h, kv, d, win, cap):
    """``layers.attention`` (what every prefill runs) in f32, both sides."""
    jcfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32",
                               num_heads=h, num_kv_heads=kv, head_dim=d,
                               attn_softcap=cap)
    tcfg = dataclasses.replace(t_reduced(t_get_config("yi-9b")),
                               dtype="float32", num_heads=h, num_kv_heads=kv,
                               head_dim=d, attn_softcap=cap)
    (jq, jk, jv), (tq, tk, tv) = _inputs(s, h, kv, d, "float32", seed=1)
    want = jax_layers.attention(jcfg, jq, jk, jv, window=win)
    got = t_layers.attention(tcfg, tq, tk, tv, window=win)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="group"):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention(q, torch.zeros(1, 7, 2, 16), torch.zeros(1, 7, 2, 16))
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, torch.zeros(1, 8, 2, 16),
                            torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16))
