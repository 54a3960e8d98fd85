"""The port's Mamba2 block against the JAX package's, float32 on the CPU,
from the same JAX-initialised params carried across as numpy: the causal
conv and its single-token step, prefill (output and caches) at lengths on
and off the chunk grid, and decode steps from the prefill caches."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import mamba2 as jax_m  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import mamba2 as m  # noqa: E402

# f32 on both sides: summation order, and the chunked against the
# sequential association of the decays (the JAX block scans sequentially off
# the chunk grid)
TOL = 5e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def block():
    jcfg = dataclasses.replace(reduced(get_config("mamba2-370m")),
                               dtype="float32")
    tcfg = dataclasses.replace(t_reduced(t_get_config("mamba2-370m")),
                               dtype="float32")
    jp, _ = jax_m.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, tcfg, jp, jax.tree.map(_t, jp)


def test_causal_conv_and_conv_step_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 24), np.float32)
    w = rng.standard_normal((4, 24), np.float32) * 0.5
    np.testing.assert_allclose(
        m.causal_conv(_t(x), _t(w)).numpy(),
        np.asarray(jax_m.causal_conv(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-6)
    state = rng.standard_normal((2, 3, 24), np.float32)
    xt = rng.standard_normal((2, 24), np.float32)
    js, jo = jax_m.conv_step(jnp.asarray(state), jnp.asarray(xt),
                             jnp.asarray(w))
    ts, to = m.conv_step(_t(state), _t(xt), _t(w))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("s", [64, 45, 4])
def test_prefill_then_decode_match_jax(block, s):
    """64 is on the chunk grid (JAX takes its chunked path), 45 and 4 are
    not (JAX scans sequentially; the port pads with dt = 0)."""
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, jcfg.d_model), np.float32)
    jo, jc = jax_m.mamba_prefill(jp, jcfg, jnp.asarray(h))
    before = ssd_ops.launches
    to, tc = m.mamba_prefill(tp, tcfg, _t(h))
    assert ssd_ops.launches == before      # CPU tensors: the plain version
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL,
                               rtol=TOL)
    for key in ("x", "B", "C"):     # the projections before the conv
        np.testing.assert_allclose(tc["conv"][key].numpy(),
                                   np.asarray(jc["conv"][key]), atol=1e-6,
                                   rtol=1e-6)
    assert tc["ssd"].dtype == torch.float32
    np.testing.assert_allclose(tc["ssd"].numpy(), np.asarray(jc["ssd"]),
                               atol=TOL, rtol=TOL)
    for step in range(4):
        ht = rng.standard_normal((2, 1, jcfg.d_model), np.float32)
        jo, jc = jax_m.mamba_decode(jp, jcfg, jnp.asarray(ht), jc)
        to, tc = m.mamba_decode(tp, tcfg, _t(ht), tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(tc["ssd"].numpy(), np.asarray(jc["ssd"]),
                                   atol=TOL, rtol=TOL)


def test_prefill_matches_the_sequential_oracle(block):
    """The port's chunked prefill against its own sequential ``ssd_ref``."""
    _, tcfg, _, tp = block
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((1, 50, 8, 16), np.float32) * 0.3)
    dt = torch.nn.functional.softplus(_t(rng.standard_normal((1, 50, 8),
                                                             np.float32)))
    A = -torch.exp(tp["A_log"])
    B, C = (_t(rng.standard_normal((1, 50, 16), np.float32) * 0.3)
            for _ in range(2))
    y, st = ssd_ops.ssd_chunked(x, dt, A, B, C, tcfg.ssm.chunk_size)
    ry, rst = m.ssd_ref(x, dt, A, B, C)
    torch.testing.assert_close(y, ry, atol=5e-4, rtol=5e-3)
    torch.testing.assert_close(st, rst, atol=5e-4, rtol=5e-3)


def test_short_prompt_conv_state_is_zero_padded(block):
    """A prompt shorter than conv_width - 1 keeps a full-size conv window,
    zeros in front (the conv's own padding)."""
    _, tcfg, _, tp = block
    h = torch.randn((1, 2, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    _, cache = m.mamba_prefill(tp, tcfg, h)
    x = cache["conv"]["x"]
    assert x.shape == (1, tcfg.ssm.conv_width - 1, 2 * tcfg.d_model)
    assert torch.all(x[:, 0] == 0)
    torch.testing.assert_close(x[:, 1:], (h @ tp["w_x"]))


def test_init_matches_jax_layout_and_dtypes(block):
    jcfg, tcfg, jp, _ = block
    tp = m.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                      3)
    jb, _ = jax_m.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    assert set(tp) == set(jb)
    for k, a in jb.items():
        assert tuple(tp[k].shape) == (3, *a.shape), k
        assert str(tp[k].dtype).removeprefix("torch.") == a.dtype.name, k
    for k in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(tp[k][1].numpy(), np.asarray(jb[k]),
                                   rtol=1e-6)
