"""The port's grouped matmul op (plain version on CPU tensors) against the
JAX package's Pallas kernel in interpret mode and its jnp oracle, over the
sweep of tests/test_kernels.py. Inputs are made with numpy from a seed and
handed to both frameworks."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.grouped_matmul.ops import grouped_matmul as jax_gmm  # noqa: E402
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_ref  # noqa: E402
from repro_torch.kernels.grouped_matmul import ops  # noqa: E402

# (E, C, d, f, block_c, block_f, block_d): tests/test_kernels.py's sweep
# (the JAX blocks only steer the Pallas tiling) and a reduced-granite shape
SWEEP = [
    (2, 64, 64, 64, 64, 64, 64),
    (4, 96, 160, 192, 64, 64, 64),     # non-multiples (the padding path)
    (8, 32, 128, 96, 32, 32, 128),
    (8, 5, 64, 64, 128, 128, 256),     # reduced granite: tiny capacity
]
# the tolerances of tests/test_kernels.py: f32 agrees to summation order;
# bf16 differs by one rounding of the output
TOL = {"float32": 3e-4, "bfloat16": 3e-2}


def _inputs(e, c, d, f, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d), np.float32) * 0.3
    w = rng.standard_normal((e, d, f), np.float32) * 0.3
    jx, jw = (jnp.asarray(a).astype(dtype) for a in (x, w))
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jx, jw))
    return (jx, jw), (tx, tw)


@pytest.mark.parametrize("e,c,d,f,bc,bf,bd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_grouped_matmul_matches_pallas_kernel(e, c, d, f, bc, bf, bd,
                                                   dtype):
    (jx, jw), (tx, tw) = _inputs(e, c, d, f, dtype)
    before = ops.launches
    out = ops.grouped_matmul(tx, tw)
    assert ops.launches == before          # CPU tensors: the plain version
    assert out.dtype == tx.dtype and out.shape == (e, c, f)
    want = jax_gmm(jx, jw, block_c=bc, block_f=bf, block_d=bd)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jax_ref(jx, jw), np.float32),
                               atol=tol, rtol=tol)


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.grouped_matmul(x, torch.zeros((2, 5, 6)))
    with pytest.raises(ValueError, match="mixed dtypes"):
        ops.grouped_matmul(x, torch.zeros((2, 4, 6), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="wants x"):
        ops.grouped_matmul(x[0], torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.grouped_matmul(x.to("meta"), torch.zeros((2, 4, 6),
                                                     device="meta"))


# The bf16 kernels' choice on the card (``_plan``), pure Python: the
# streaming kernel up to STREAM_MAX_C rows, the tile kernel above.
@pytest.mark.parametrize("c,variant", [(1, "stream"), (2, "stream"),
                                       (3, "stream"), (15, "stream"),
                                       (16, "stream"), (17, "tile"),
                                       (80, "tile"), (157, "tile"),
                                       (320, "tile")])
def test_plan_picks_the_kernel_by_capacity(c, variant):
    assert ops._plan(c, 1024, 512) == variant
    assert (variant == "stream") == (c <= ops.STREAM_MAX_C)


# Every MoE configuration's expert products, full width and reduced, are
# shapes the bf16 kernels take: wi/wg (d_model -> expert_d_ff) and wo back,
# at a 4-slot decode step's capacity and a 1024-token prefill's.
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("c,variant", [(2, "stream"), (320, "tile")])
def test_plan_takes_every_moe_config(arch, size, c, variant):
    from repro_torch.configs import get_config, reduced
    cfg = get_config(arch)
    if size == "reduced":
        cfg = reduced(cfg)
    d, f = cfg.d_model, cfg.moe.expert_d_ff
    assert ops._plan(c, d, f) == variant
    assert ops._plan(c, f, d) == variant


@pytest.mark.parametrize("d,f", [(100, 64), (64, 100), (12, 8)])
def test_plan_rejects_rows_off_16_bytes(d, f):
    for c in (2, 64):
        with pytest.raises(ValueError, match="multiples of 8"):
            ops._plan(c, d, f)
    # the CPU branch takes the plain version for any shape
    x, w = torch.ones((4, 2, d)), torch.ones((4, d, f))
    torch.testing.assert_close(ops.grouped_matmul(x, w),
                               torch.full((4, 2, f), float(d)))


# The backward's launches (``_bwd_calls``), pure Python on meta tensors (no
# memory), at every MoE configuration's training capacity, full width and
# reduced: bf16 takes the tile kernel's "dx" and "dw" variants on dy, w and
# x themselves (no transposed or padded copy, any capacity); float32, the
# parity path, the f32 kernel on w^T and x^T copied contiguous.
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("size,tokens", [("full", 4 * 2048),
                                         ("reduced", 2 * 33)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_plan_at_training_capacity(arch, size, tokens, dtype):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.moe import _capacity
    cfg = get_config(arch)
    if size == "reduced":
        cfg = reduced(cfg)
    m = cfg.moe
    c = _capacity(tokens, m.top_k, m.num_experts, m.capacity_factor)
    for d, f in ((cfg.d_model, m.expert_d_ff), (m.expert_d_ff, cfg.d_model)):
        x, w, dy = (torch.empty(shape, dtype=dtype, device="meta")
                    for shape in ((m.num_experts, c, d),
                                  (m.num_experts, d, f),
                                  (m.num_experts, c, f)))
        calls = ops._bwd_calls(x, w, dy, True, True)
        e = m.num_experts
        assert {g: v for g, (v, *_) in calls.items()} == (
            {"dx": "dx", "dw": "dw"} if dtype == torch.bfloat16
            else {"dx": "f32", "dw": "f32"})
        (_, a_dx, b_dx, dims_dx), (_, a_dw, b_dw, dims_dw) = \
            calls["dx"], calls["dw"]
        if dtype == torch.bfloat16:
            assert a_dx is dy and b_dx is w and a_dw is x and b_dw is dy
            assert dims_dx == dims_dw == (e, c, d, f)
        else:
            assert a_dx is dy and b_dw is dy
            assert b_dx.shape == (e, f, d) and b_dx.is_contiguous()
            assert a_dw.shape == (e, d, c) and a_dw.is_contiguous()
            # the f32 kernel computes (E, C, f) @ (E, f, d) and (E, d, C)
            # @ (E, C, f)
            assert dims_dx == (e, c, f, d) and dims_dw == (e, d, c, f)
        # one gradient only: one launch
        assert list(ops._bwd_calls(x, w, dy, False, True)) == ["dw"]


def test_backward_plan_rejects_rows_off_16_bytes():
    x, w, dy = (torch.empty(s, dtype=torch.bfloat16, device="meta")
                for s in ((2, 5, 100), (2, 100, 64), (2, 5, 64)))
    with pytest.raises(ValueError, match="multiples of 8"):
        ops._bwd_calls(x, w, dy, True, True)
