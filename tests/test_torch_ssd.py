"""The port's SSD ops (plain version on CPU tensors) against the JAX
package: ``ssd_intra_chunk`` against the Pallas kernel in interpret mode,
``ssd_chunked`` against ``ssd_chunked_pallas`` and the sequential
``ssd_ref``, over the sweep of tests/test_kernels.py and lengths that are
not a multiple of the chunk (the port pads those with dt = 0). Inputs are
made with numpy from a seed and handed to both frameworks."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssd.kernel import ssd_intra_chunk as jax_intra  # noqa: E402
from repro.kernels.ssd.ops import ssd_chunked_pallas  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd import ops  # noqa: E402

# (s, nh, hd, ds, chunk): tests/test_kernels.py's sweep
SWEEP = [(64, 2, 16, 8, 16), (128, 4, 32, 16, 32), (128, 4, 32, 16, 64)]
# lengths off the chunk grid: one short tail, one short of a single chunk
RAGGED = [(100, 4, 32, 16, 32), (13, 2, 16, 8, 16)]
# tests/test_kernels.py's tolerance: f32 throughout, summation order and the
# chunked against the sequential association of the decays
ATOL, RTOL = 5e-4, 5e-3


def _inputs(s, nh, hd, ds, seed=0, b=2, A=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd), np.float32) * 0.3
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    if A is None:
        A = -np.exp(np.linspace(0.0, 1.0, nh))
    A = np.asarray(A, np.float32)
    B = rng.standard_normal((b, s, ds), np.float32) * 0.3
    C = rng.standard_normal((b, s, ds), np.float32) * 0.3
    arrays = (x, dt, A, B, C)
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a) for a in arrays))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("s,nh,hd,ds,ch", SWEEP)
def test_intra_chunk_matches_pallas_kernel(s, nh, hd, ds, ch):
    rng = np.random.default_rng(1)
    b, nc = 2, s // ch
    a = -np.abs(rng.standard_normal((b, nh, nc, ch), np.float32)) * 0.5
    xdt = rng.standard_normal((b, nh, nc, ch, hd), np.float32) * 0.3
    B = rng.standard_normal((b, nc, ch, ds), np.float32) * 0.3
    C = rng.standard_normal((b, nc, ch, ds), np.float32) * 0.3
    before = ops.launches
    y, S = ops.ssd_intra_chunk(*(torch.from_numpy(v) for v in (a, xdt, B, C)))
    assert ops.launches == before          # CPU tensors: the plain version
    jy, jS = jax_intra(*(jnp.asarray(v) for v in (a, xdt, B, C)),
                       interpret=True)
    assert y.shape == jy.shape and S.shape == jS.shape
    _close(y, jy)
    _close(S, jS)


@pytest.mark.parametrize("s,nh,hd,ds,ch", SWEEP)
def test_chunked_matches_pallas_op_and_sequential_ref(s, nh, hd, ds, ch):
    j, t = _inputs(s, nh, hd, ds)
    y, st = ops.ssd_chunked(*t, chunk=ch)
    assert y.shape == (2, s, nh, hd) and st.shape == (2, nh, hd, ds)
    jy, jst = ssd_chunked_pallas(*j, chunk=ch)
    _close(y, jy)
    _close(st, jst)
    ry, rst = jax_ssd_ref(*j)
    _close(y, ry)
    _close(st, rst)


@pytest.mark.parametrize("s,nh,hd,ds,ch", RAGGED)
def test_chunked_pads_a_ragged_tail_exactly(s, nh, hd, ds, ch):
    """y and the final state at a length off the chunk grid agree with the
    sequential scan: the dt = 0 padding changes nothing."""
    j, t = _inputs(s, nh, hd, ds, seed=2)
    y, st = ops.ssd_chunked(*t, chunk=ch)
    assert y.shape == (2, s, nh, hd)
    ry, rst = jax_ssd_ref(*j)
    _close(y, ry)
    _close(st, rst)


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((1, 2, 1, 8))
    xdt = torch.zeros((1, 2, 1, 8, 16))
    B = torch.zeros((1, 1, 8, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.ssd_intra_chunk(a, xdt[:, :1], B, B)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_intra_chunk(a, xdt, B.bfloat16(), B.bfloat16())
    with pytest.raises(ValueError, match="wants a"):
        ops.ssd_intra_chunk(a[0], xdt, B, B)


def test_chunked_at_mamba2_decay_range():
    """A = -linspace(1, 16) (mamba2's initial decays): the cumulative log
    decay reaches the hundreds within a chunk, so exp(acs_i) and
    exp(-acs_j) alone would under- and overflow in f32; the decays are
    taken from differences of acs, as in the JAX op and the sequential
    scan."""
    s, nh, hd, ds, ch = 128, 4, 16, 16, 64
    j, t = _inputs(s, nh, hd, ds, seed=3, A=-np.linspace(1.0, 16.0, nh))
    acs = np.cumsum(t[1].numpy()[0, :ch] * t[2].numpy(), axis=0)
    assert acs.min() < -100          # the range the test is about
    y, st = ops.ssd_chunked(*t, chunk=ch)
    jy, jst = ssd_chunked_pallas(*j, chunk=ch)
    _close(y, jy)
    _close(st, jst)
    ry, rst = jax_ssd_ref(*j)
    _close(y, ry)
    _close(st, rst)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
def test_y_grid_fills_the_card_at_served_shapes(b, nc):
    """mamba2-370m's prefill groups (nh = 32, chunk 256): one head a block
    leaves at least one block of y for each of the H100's 132 SMs, even for
    one chunk of one prompt."""
    nh, c = 32, 256
    # y: row tiles 0, 1 reach one part of 128 keys each, tiles 2, 3 two
    assert ops.y_blocks(b, nh, nc, c) == b * nc * nh * 6
    assert ops.y_blocks(b, nh, nc, c) >= 132


def test_y_grid_small_and_odd_chunks():
    """Chunks off the 64-row tile and past 256 keys: a row tile has one
    block for each part of 128 keys up to its last row."""
    assert ops._y_units(16) == 1 and ops._y_units(48) == 1
    assert ops._y_units(300) == 1 + 1 + 2 + 2 + 3
    assert ops._y_units(512) == 20
    assert ops.y_blocks(2, 4, 2, 32) == 2 * 2 * 4 * 1


@pytest.mark.parametrize("b,nh,nc,c,ds", [(4, 32, 8, 256, 128),
                                          (4, 64, 8, 256, 64),
                                          (2, 4, 2, 48, 7)])
def test_backward_workspace_holds_no_per_head_dg(b, nh, nc, c, ds):
    """The backward's workspaces at the training microbatches of mamba2-370m
    and zamba2-1.2b and a ragged case: the heads' dG is summed on chip, so
    no buffer grows with heads x c x c; the head term's parts cover every
    head in parts of ``HEADS_PER_PART``."""
    ws = ops.bwd_workspace(b, nh, nc, c, ds)
    per_head_dg = b * nc * nh * c * c
    assert all(np.prod(s) < per_head_dg for s in ws.values())
    assert ws["cb"] == ws["dg"] == (b, nc, c, c)
    tiles = -(-c // 64)
    assert ws["sums"] == (b, nc, nh, tiles * (tiles + 1) // 2, 2, 64)
    parts = ws["hparts"][2]
    assert (parts - 1) * ops.HEADS_PER_PART < nh <= parts * ops.HEADS_PER_PART
    assert ops.bwd_workspace_bytes(b, nh, nc, c, ds) == 4 * sum(
        int(np.prod(s)) for s in ws.values())


def test_device_kernels_profiles_one_call_after_a_warm_one():
    """The profile the card checks read: ``fn`` runs once unrecorded, then
    once recorded; a call that does no device work records no kernel."""
    from repro_torch.kernels.profiling import device_kernels
    calls = []
    assert device_kernels(lambda: calls.append(torch.ones(4) + 1)) == {}
    assert len(calls) == 2
