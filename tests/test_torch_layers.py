"""Per-function parity of ``repro_torch.models.layers`` with the JAX
package's ``repro.models.layers`` in float32 on the CPU. Inputs come from
numpy with a seed. Tolerance 1e-5: the same arithmetic in another summation
order (XLA-CPU against torch's CPU kernels)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import layers as J  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import layers as T  # noqa: E402

TOL = 1e-5


def _cfgs():
    j = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    t = dataclasses.replace(t_reduced(t_get_config("yi-9b")), dtype="float32")
    return j, t


def _pair(*shape, seed=0, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= scale
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_port_config_is_a_copy():
    j, t = _cfgs()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(get_config("yi-9b")) == \
        dataclasses.asdict(t_get_config("yi-9b"))


def test_rms_norm():
    jx, tx = _pair(2, 5, 64)
    jw, tw = _pair(64, seed=1, scale=0.1)
    _close(T.rms_norm(tx, tw, 1e-6), J.rms_norm(jx, jw, 1e-6))


@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_apply_rope(positions):
    jx, tx = _pair(3, 7, 4, 16)
    if positions == "prefill":
        pos = np.arange(7)[None, :]
    else:
        pos = np.array([[3], [40], [95]])
    _close(T.apply_rope(tx, torch.from_numpy(pos), 10_000.0),
           J.apply_rope(jx, jnp.asarray(pos), 10_000.0))


def _attn_params(seed=2):
    jc, _ = _cfgs()
    d, h, kv, hd = jc.d_model, jc.num_heads, jc.num_kv_heads, jc.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d)}
    pairs = {k: _pair(*s, seed=seed + i, scale=0.125)
             for i, (k, s) in enumerate(shapes.items())}
    return ({k: a for k, (a, _) in pairs.items()},
            {k: b for k, (_, b) in pairs.items()})


def test_qkv_proj():
    jc, tc = _cfgs()
    jp, tp = _attn_params()
    jx, tx = _pair(2, 9, jc.d_model)
    pos = np.arange(9)[None, :]
    want = J.qkv_proj(jp, jc, jx, jnp.asarray(pos), jc.rope_theta)
    got = T.qkv_proj(tp, tc, tx, torch.from_numpy(pos), tc.rope_theta)
    for g, w in zip(got, want):
        _close(g, w)
    _close(T.out_proj(got[0], tp["wo"]),
           jnp.einsum("bshk,hkd->bsd", want[0], jp["wo"]))


def test_decode_attention_padded_cache():
    """A (B, T, KV, hd) cache with rows at different positions: entries past
    each row's ``pos`` hold garbage and must be masked."""
    jc, tc = _cfgs()
    b, t = 3, 24
    jq, tq = _pair(b, 1, jc.num_heads, jc.head_dim, seed=3)
    jk, tk = _pair(b, t, jc.num_kv_heads, jc.head_dim, seed=4)
    jv, tv = _pair(b, t, jc.num_kv_heads, jc.head_dim, seed=5)
    pos = np.array([0, 11, 23])
    want = J.decode_attention(jc, jq, jk, jv, jnp.asarray(pos))
    got = T.decode_attention(tc, tq, tk, tv, torch.from_numpy(pos))
    _close(got, want)


def test_mlp_apply():
    jc, _ = _cfgs()
    d, ff = jc.d_model, jc.d_ff
    pairs = {"wi": _pair(d, ff, seed=6, scale=0.125),
             "wg": _pair(d, ff, seed=7, scale=0.125),
             "wo": _pair(ff, d, seed=8, scale=0.09)}
    jx, tx = _pair(2, 5, d, seed=9)
    _close(T.mlp_apply({k: b for k, (_, b) in pairs.items()}, tx),
           J.mlp_apply({k: a for k, (a, _) in pairs.items()}, jx))


def test_embed_and_unembed_padded_vocab():
    jc, tc = _cfgs()
    assert tc.padded_vocab > tc.vocab_size          # 503 -> 512
    jt, tt = _pair(tc.padded_vocab, tc.d_model, seed=10)
    toks = np.random.default_rng(11).integers(0, tc.vocab_size, (2, 6))
    je = J.embed_apply({"tok": jt}, jnp.asarray(toks), jc.d_model)
    te = T.embed_apply({"tok": tt}, torch.from_numpy(toks), tc.d_model)
    _close(te, je)
    jh, th = _pair(2, 6, tc.d_model, seed=12, scale=0.125)
    got = T.unembed_apply({"tok": tt}, tc, th)
    assert got.dtype == torch.float32 and got.shape[-1] == tc.padded_vocab
    _close(got, J.unembed_apply({"tok": jt}, jc, jh))
