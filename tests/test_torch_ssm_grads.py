"""Gradients of the port's SSD op and Mamba2 block against the JAX
package's, float32 on the CPU. The Pallas op has no VJP, so the reference
is what JAX's train path differentiates: ``jax.vjp`` of the jnp
``ssd_chunked`` (and of ``ssd_ref`` off the chunk grid, where JAX's
``mamba_block`` scans sequentially), and ``jax.grad`` through JAX's
``mamba_block``. The port's plain backward of the intra-chunk kernel
(``ssd_intra_chunk_ref_bwd``, which the card's backward kernel is held to)
is checked against ``jax.vjp`` of the same formulas in jnp. Inputs are
made with numpy from a seed and handed to both frameworks."""
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
from repro_torch.kernels.ssd import ops  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    ssd_intra_chunk_closed_bwd, ssd_intra_chunk_ref_bwd)
from repro_torch.models import mamba2 as m  # noqa: E402

# (s, nh, hd, ds, chunk): tests/test_torch_ssd.py's sweep and its lengths
# off the chunk grid
SWEEP = [(64, 2, 16, 8, 16), (128, 4, 32, 16, 32), (128, 4, 32, 16, 64)]
RAGGED = [(100, 4, 32, 16, 32), (13, 2, 16, 8, 16)]
NAMES = ("x", "dt", "A", "B", "C")


def _inputs(s, nh, hd, ds, seed=0, b=2, A=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd), np.float32) * 0.3
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    if A is None:
        A = -np.exp(np.linspace(0.0, 1.0, nh))
    A = np.asarray(A, np.float32)
    B = rng.standard_normal((b, s, ds), np.float32) * 0.3
    C = rng.standard_normal((b, s, ds), np.float32) * 0.3
    dy = rng.standard_normal((b, s, nh, hd), np.float32)
    dst = rng.standard_normal((b, nh, hd, ds), np.float32)
    return (x, dt, A, B, C), (dy, dst)


def _close_of_max(name, got, want, atol_of_max, rtol):
    """Within ``atol_of_max`` of the gradient's largest magnitude plus
    ``rtol`` of each element."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * float(np.abs(want).max()),
                               err_msg=name)


def _port_grads(ins, cots, chunk):
    t = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, st = ops.ssd_chunked(*t, chunk=chunk)
    grads = torch.autograd.grad((y, st), t, tuple(map(torch.from_numpy,
                                                      cots)))
    return [g.numpy() for g in grads]


def _jax_grads(fn, ins, cots):
    def grads(ins, cots):
        _, vjp = jax.vjp(fn, *ins)
        return vjp(cots)
    return jax.jit(grads)(tuple(map(jnp.asarray, ins)),
                          tuple(map(jnp.asarray, cots)))


# f32 both sides, summation orders over up to 128 positions and the two
# frameworks' association of the chunked sums; against the sequential scan
# also the chunked against the sequential association of the decays
# (tests/test_torch_ssd.py's forward tolerance, its atol relative to the
# gradient's largest magnitude)
@pytest.mark.parametrize("s,nh,hd,ds,ch", SWEEP)
def test_chunked_gradients_match_jax_vjp(s, nh, hd, ds, ch):
    ins, cots = _inputs(s, nh, hd, ds)
    got = _port_grads(ins, cots, ch)
    want = _jax_grads(lambda *a: jax_m.ssd_chunked(*a, ch), ins, cots)
    for name, g, w in zip(NAMES, got, want):
        _close_of_max(name, g, w, 1e-5, 1e-4)


@pytest.mark.parametrize("s,nh,hd,ds,ch", RAGGED)
def test_ragged_gradients_match_jax_sequential_scan(s, nh, hd, ds, ch):
    """Off the chunk grid the port pads with dt = 0 and JAX's
    ``mamba_block`` runs ``ssd_ref``: the same gradients, the padding's
    included (dt's at real positions only)."""
    ins, cots = _inputs(s, nh, hd, ds, seed=2)
    got = _port_grads(ins, cots, ch)
    want = _jax_grads(jax_m.ssd_ref, ins, cots)
    assert got[1].shape == (2, s, nh)
    for name, g, w in zip(NAMES, got, want):
        _close_of_max(name, g, w, 5e-4, 5e-3)


def test_chunked_gradients_at_mamba2_decay_range():
    """A = -linspace(1, 16): the cumulative log decay reaches the hundreds
    within a chunk; the decays come from differences of acs, so no
    gradient under- or overflows."""
    s, nh, hd, ds, ch = 128, 4, 16, 16, 64
    ins, cots = _inputs(s, nh, hd, ds, seed=3, A=-np.linspace(1.0, 16.0, nh))
    acs = np.cumsum(ins[1][0, :ch] * ins[2], axis=0)
    assert acs.min() < -100          # the range the test is about
    got = _port_grads(ins, cots, ch)
    want = _jax_grads(lambda *a: jax_m.ssd_chunked(*a, ch), ins, cots)
    # the forward's tolerance: dA sums 2 x 128 x 16 terms per head that
    # cancel to ~1e-2 of their size at these decays
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        _close_of_max(name, g, w, 5e-4, 5e-3)
    seq = _jax_grads(jax_m.ssd_ref, ins, cots)
    for name, g, w in zip(NAMES, got, seq):
        _close_of_max(name, g, w, 5e-4, 5e-3)


def _jnp_intra(a, xdt, B, C):
    """The intra-chunk dual form in jnp, the formulas of the Pallas kernel's
    body over the whole (b, nh, nc) grid."""
    c = a.shape[-1]
    acs = jnp.cumsum(a, axis=-1)
    diff = acs[..., :, None] - acs[..., None, :]
    causal = jnp.tril(jnp.ones((c, c), bool))
    L = jnp.where(causal, jnp.exp(jnp.where(causal, diff, 0.0)), 0.0)
    scores = jnp.einsum("bncs,bnks->bnck", C, B)
    y = jnp.einsum("bhnck,bhnkp->bhncp", scores[:, None] * L, xdt)
    w = jnp.exp(acs[..., -1:] - acs)
    S = jnp.einsum("bncs,bhnc,bhncp->bhnsp", B, w, xdt)
    return y, S


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("s,nh,hd,ds,ch", SWEEP + [(96, 4, 32, 7, 48)])
def test_intra_chunk_plain_backward_matches_jax_vjp(s, nh, hd, ds, ch, wide):
    rng = np.random.default_rng(4)
    b, nc = 2, s // ch
    scale = np.linspace(1.0, 16.0, nh) if wide else np.ones(nh)
    a = (-np.abs(rng.standard_normal((b, nh, nc, ch))) * 0.5
         * scale[None, :, None, None]).astype(np.float32)
    xdt = rng.standard_normal((b, nh, nc, ch, hd), np.float32) * 0.3
    B = rng.standard_normal((b, nc, ch, ds), np.float32) * 0.3
    C = rng.standard_normal((b, nc, ch, ds), np.float32) * 0.3
    dy = rng.standard_normal((b, nh, nc, ch, hd), np.float32)
    dS = rng.standard_normal((b, nh, nc, ds, hd), np.float32)
    got = ssd_intra_chunk_ref_bwd(*map(torch.from_numpy,
                                       (a, xdt, B, C, dy, dS)))
    want = _jax_grads(_jnp_intra, (a, xdt, B, C), (dy, dS))
    for name, g, w in zip(("da", "dxdt", "dB", "dC"), got, want):
        assert g.shape == np.asarray(w).shape
        _close_of_max(name, g.numpy(), w, 1e-5, 1e-4)


# (b, s, nh, hd, ds, chunk): the small cases of the card's SSD backward
# tests (tests/test_torch_kernels_gpu.py), a chunk off the 64-row tile and
# d_state 7 among them
CLOSED_CASES = [(2, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 64),
                (2, 96, 4, 32, 16, 48), (1, 64, 2, 16, 7, 32)]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("b,s,nh,hd,ds,ch", CLOSED_CASES)
def test_closed_form_backward_matches_autograd_and_jax_vjp(b, s, nh, hd, ds,
                                                           ch, wide):
    """The closed-form backward (the kernels' formulas in their order)
    against autograd through the plain version and ``jax.vjp`` of the jnp
    dual form; ``wide`` takes mamba2's decay range, A = -linspace(1, 16),
    where the cumulative log decay reaches the hundreds within a chunk."""
    rng = np.random.default_rng(5)
    nc = s // ch
    dt = np.log1p(np.exp(rng.standard_normal((b, nc, ch, nh))))
    A = -np.linspace(1.0, 16.0, nh) if wide else \
        -np.exp(np.linspace(0.0, 1.0, nh))
    a = (dt * A).transpose(0, 3, 1, 2).astype(np.float32)
    assert not wide or np.cumsum(a, axis=-1).min() < -100
    xdt = rng.standard_normal((b, nh, nc, ch, hd), np.float32) * 0.3
    B = rng.standard_normal((b, nc, ch, ds), np.float32) * 0.3
    C = rng.standard_normal((b, nc, ch, ds), np.float32) * 0.3
    dy = rng.standard_normal((b, nh, nc, ch, hd), np.float32)
    dS = rng.standard_normal((b, nh, nc, ds, hd), np.float32)
    ins = tuple(map(torch.from_numpy, (a, xdt, B, C, dy, dS)))
    got = ssd_intra_chunk_closed_bwd(*ins)
    autograd = ssd_intra_chunk_ref_bwd(*ins)
    jax_vjp = _jax_grads(_jnp_intra, (a, xdt, B, C), (dy, dS))
    for name, g, r, w in zip(("da", "dxdt", "dB", "dC"), got, autograd,
                             jax_vjp):
        assert g.shape == r.shape and torch.isfinite(g).all(), name
        _close_of_max(name, g.numpy(), r.numpy(), 1e-5, 1e-4)
        _close_of_max(name, g.numpy(), w, 1e-5, 1e-4)


def test_ssd_op_rejects_an_unsupported_backward():
    """Off the card the op's backward is autograd through the plain
    version; the kernel's launcher takes CUDA tensors only."""
    a = torch.zeros((1, 2, 1, 8))
    xdt = torch.zeros((1, 2, 1, 8, 16))
    B = torch.zeros((1, 1, 8, 4))
    S = torch.zeros((1, 2, 1, 4, 16))
    with pytest.raises(ValueError, match="cuda tensors"):
        ops.ssd_intra_chunk_bwd(a, xdt, B, B, xdt, S)


# -- mamba_block ---------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    jcfg = dataclasses.replace(reduced(get_config("mamba2-370m")),
                               dtype="float32")
    tcfg = dataclasses.replace(t_reduced(t_get_config("mamba2-370m")),
                               dtype="float32")
    jp, _ = jax_m.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    # non-trivial norm, skip and bias params, so their gradients are
    # checked away from their initial values
    rng = np.random.default_rng(5)
    jp = dict(jp, norm=jnp.asarray(rng.standard_normal(jp["norm"].shape,
                                                       np.float32) * 0.1),
              dt_bias=jnp.asarray(rng.standard_normal(
                  jp["dt_bias"].shape, np.float32) * 0.5))
    return jcfg, tcfg, jp


@pytest.mark.parametrize("s", [64, 45])
def test_mamba_block_output_and_param_grads_match_jax(block, s):
    """On the chunk grid (JAX's chunked op) and off it (JAX's sequential
    scan): the block's output and the gradient of every param of a
    weighted sum of it."""
    jcfg, tcfg, jp = block
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, jcfg.d_model), np.float32)
    wout = rng.standard_normal((2, s, jcfg.d_model), np.float32)

    def jloss(p, h):
        out = jax_m.mamba_block(p, jcfg, h)
        return jnp.sum(out * wout), out
    (_, jout), (jg, jgh) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(h))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    th = torch.from_numpy(h).requires_grad_()
    out = m.mamba_block(tp, tcfg, th)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=5e-5, rtol=5e-5)
    keys = sorted(tp)
    grads = torch.autograd.grad((out * torch.from_numpy(wout)).sum(),
                                [tp[k] for k in keys] + [th])
    for k, g in zip(keys + ["h"], grads):
        want = jgh if k == "h" else jg[k]
        _close_of_max(k, g.numpy(), want, 5e-5, 5e-4)


def test_mamba_block_refuses_the_dry_run_lowering(block):
    _, tcfg, jp = block
    cfg = dataclasses.replace(tcfg, ssd_impl="fused_proxy")
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    with pytest.raises(ValueError, match=r"A\.8"):
        m.mamba_block(tp, cfg, torch.zeros((1, 8, tcfg.d_model)))
