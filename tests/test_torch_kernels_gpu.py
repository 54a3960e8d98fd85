"""The CUDA kernels (flash attention, grouped matmul, SSD) against their
plain versions on the card (``pytest -m gpu``). Needs no JAX; skips without
a card, decided inside the test so every worker collects the same tests."""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

# (B, S, H, KV, D, window, softcap): the sweep of tests/test_kernels.py, the
# reduced configs' head dim, the yi-9b prefill shape and the served prefill
# shapes of gemma2 (window inactive), gemma3 (local and global subs), qwen2
# and zamba2
CASES = [
    (2, 128, 4, 4, 32, 0, 0.0),
    (2, 192, 4, 2, 64, 0, 0.0),
    (2, 128, 4, 2, 32, 48, 0.0),
    (2, 128, 2, 2, 64, 0, 30.0),
    (2, 96, 8, 1, 32, 32, 50.0),
    (3, 37, 4, 2, 16, 0, 0.0),
    (1, 300, 2, 1, 256, 0, 0.0),
    (4, 1024, 32, 4, 128, 0, 0.0),
    # the bf16 kernel's edges: D = 16 and 256 with window and softcap, S off
    # the 64-row q tile
    (2, 100, 4, 2, 16, 40, 30.0),
    (1, 200, 2, 1, 256, 64, 50.0),
    (2, 77, 4, 4, 128, 0, 20.0),
    (4, 1024, 32, 16, 128, 4096, 50.0),
    (1, 1900, 16, 8, 256, 1024, 0.0),
    (1, 1900, 16, 8, 256, 0, 0.0),
    (4, 1024, 64, 8, 128, 0, 0.0),
    (1, 1024, 32, 32, 64, 0, 0.0),
    # the embeddings input mode: musicgen-medium's training microbatch (MHA,
    # 24 heads of 64) and internvl2-26b's training batch and forward (48 q
    # over 8 kv heads of 128)
    (4, 2048, 24, 24, 64, 0, 0.0),
    (2, 2048, 48, 8, 128, 0, 0.0),
    (2, 1024, 48, 8, 128, 0, 0.0),
]


def _tol(dtype, s):
    # f32: summation order only (longer rows at S=1024); bf16: output
    # rounding, and the kernel rounds probabilities to bf16 before P.V
    # (relative error at most 2^-9 each)
    if dtype == torch.bfloat16:
        return 2e-2
    return 1e-4 if s >= 1024 else 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,win,cap", CASES)
def test_cuda_kernel_matches_plain_version(b, s, h, kv, d, win, cap, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
               for n in (h, kv, kv))
    before = ops.launches
    out = ops.flash_attention(q, k, v, window=win, softcap=cap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = attention_ref(q, k, v, window=win, softcap=cap)
    tol = _tol(dtype, s)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


# (E, C, d, f): tests/test_kernels.py's sweep, granite's capacity at a
# 4-slot decode step and at a 1024-token prefill (C = 320); then the bf16
# dispatch edges: C = 1, 2, 3, the streaming threshold and one either side,
# ragged prefill capacities, and a streaming call ragged in d and f
GMM_CASES = [(2, 64, 64, 64), (4, 96, 160, 192), (8, 32, 128, 96),
             (32, 2, 1024, 512), (32, 2, 512, 1024), (32, 320, 1024, 512),
             (32, 320, 512, 1024),
             (8, 1, 256, 128), (8, 2, 256, 128), (8, 3, 256, 128),
             (8, 15, 256, 128), (8, 16, 256, 128), (8, 17, 256, 128),
             (8, 80, 1024, 512), (8, 157, 1024, 512), (4, 320, 512, 1024),
             (4, 5, 104, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GMM_CASES)
def test_grouped_matmul_kernel_matches_plain_version(e, c, d, f, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_matmul import ops as gmm
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w = ((torch.randn(shape, generator=gen, device="cuda") * 0.3).to(dtype)
            for shape in ((e, c, d), (e, d, f)))
    variant = ("f32" if dtype == torch.float32 else gmm._plan(c, d, f))
    assert variant == "f32" or (variant == "stream") == (
        c <= gmm.STREAM_MAX_C)
    before = gmm.launches
    by_variant = dict(gmm.launches_by_variant)
    out = gmm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gmm.launches == before + 1
    by_variant[variant] += 1
    assert gmm.launches_by_variant == by_variant
    # JAX's tolerances: f32 summation order; bf16 one output rounding
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), grouped_matmul_ref(x, w).float(),
                               atol=tol, rtol=tol)


# (b, s, nh, hd, ds, chunk): tests/test_kernels.py's sweep, mamba2-370m's
# prefill shape, and lengths off the chunk grid through the padded op; then
# the edges of the tensor-core kernel's tiling: zamba2's d_state 64, a chunk
# off the 64-row tile (48), head dims 16 and 128 at d_state 128, one chunk
# at full width, and three batches of 32 heads; last, zamba2's served
# prefill (64 heads at d_state 64), on and off the chunk grid
SSD_CASES = [(2, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
             (2, 128, 4, 32, 16, 64), (1, 1024, 32, 64, 128, 256),
             (1, 1000, 32, 64, 128, 256), (2, 77, 4, 128, 16, 32),
             (1, 512, 32, 64, 64, 256), (2, 96, 4, 32, 16, 48),
             (1, 256, 4, 16, 128, 256), (1, 256, 4, 128, 128, 256),
             (1, 256, 32, 64, 128, 256), (3, 512, 32, 64, 128, 256),
             (1, 1024, 64, 64, 64, 256), (1, 1000, 64, 64, 64, 256)]
# mamba2's initial decay range, A = -linspace(1, 16, nh): the cumulative log
# decay reaches the thousands within a chunk
SSD_WIDE_DECAY_CASES = [(1, 1024, 32, 64, 128, 256), (2, 96, 4, 32, 16, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hd,ds,ch", SSD_CASES)
def test_ssd_kernel_matches_plain_version(b, s, nh, hd, ds, ch):
    _check_ssd(b, s, nh, hd, ds, ch, wide_decay=False)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hd,ds,ch", SSD_WIDE_DECAY_CASES)
def test_ssd_kernel_at_mamba2_decay_range(b, s, nh, hd, ds, ch):
    _check_ssd(b, s, nh, hd, ds, ch, wide_decay=True)


def _check_ssd(b, s, nh, hd, ds, ch, wide_decay):
    """The kernel alone against its plain version (one launch), then the
    padded op against the sequential scan (one launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
    from repro_torch.models.mamba2 import ssd_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = rnd(b, s, nh, hd) * 0.3
    dt = torch.nn.functional.softplus(rnd(b, s, nh))
    A = -(torch.linspace(1.0, 16.0, nh, device="cuda") if wide_decay else
          torch.exp(torch.linspace(0.0, 1.0, nh, device="cuda")))
    B, C = rnd(b, s, ds) * 0.3, rnd(b, s, ds) * 0.3
    if s % ch == 0:        # the kernel alone against its plain version
        nc = s // ch
        a = (dt.reshape(b, nc, ch, nh) * A).permute(0, 3, 1, 2).contiguous()
        xdt = (x.reshape(b, nc, ch, nh, hd) * dt.reshape(b, nc, ch, nh, 1)
               ).permute(0, 3, 1, 2, 4).contiguous()
        Bc, Cc = (v.reshape(b, nc, ch, ds) for v in (B, C))
        before = ssd.launches
        y, S = ssd.ssd_intra_chunk(a, xdt, Bc, Cc)
        torch.cuda.synchronize()
        assert ssd.launches == before + 1
        ry, rS = ssd_intra_chunk_ref(a, xdt, Bc, Cc)
        torch.testing.assert_close(y, ry, atol=5e-4, rtol=5e-3)
        torch.testing.assert_close(S, rS, atol=5e-4, rtol=5e-3)
    # the op (padded to the chunk grid) against the sequential scan
    before = ssd.launches
    y, st = ssd.ssd_chunked(x, dt, A, B, C, ch)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    ry, rst = ssd_ref(x, dt, A, B, C)
    torch.testing.assert_close(y, ry, atol=5e-4, rtol=5e-3)
    torch.testing.assert_close(st, rst, atol=5e-4, rtol=5e-3)


@pytest.mark.gpu
def test_chunked_prefill_on_the_card_matches_the_whole_prompt_path():
    """A depth-2 float32 model on the card: chunked prefill (prompts longer
    than one chunk, one off the chunk grid, one past a chunk of pad at the
    cache's end) gives the tokens of the whole-prompt prefill on the flash
    kernel, and the chunk path launches no flash kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine, greedy_generate
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("yi-9b")), num_layers=2,
                              dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (40, 77, 98)]
    eng = ServingEngine(model, params, slots=3, max_seq=100, chunk_tokens=16,
                        device="cuda")
    futs = [eng.submit(p, max_new_tokens=2) for p in prompts]
    before = ops.launches
    eng.run_until_idle()
    assert ops.launches == before
    assert eng.metrics["prefill_chunks"] == 3 + 5 + 7
    for p, f in zip(prompts, futs):
        np.testing.assert_array_equal(f.result(),
                                      greedy_generate(model, params, p, 2,
                                                      100))


# (B, S, H, KV, D, window, softcap) for the backward kernel: the training
# shapes of granite (D 64) and a gemma2-like softcap + window at D 128, S
# off the 64-row tile, a window that bites, non-causal-free GQA, and D 256
# at the 32-row tile; then the tensor-core kernel's edges: S = 1000 (off
# the 64-key tile) at GQA groups of 2 and 8, with a window that bites and
# with softcap 50
BWD_CASES = [
    (2, 128, 4, 2, 64, 0, 0.0),
    (1, 200, 4, 1, 128, 0, 0.0),
    (2, 77, 4, 4, 128, 0, 20.0),
    (1, 300, 8, 4, 64, 64, 50.0),
    (1, 130, 2, 1, 256, 0, 0.0),
    (1, 100, 2, 2, 256, 40, 30.0),
    (2, 512, 16, 8, 64, 0, 0.0),
    (1, 1000, 8, 4, 128, 0, 0.0),
    (2, 1000, 16, 2, 64, 0, 0.0),
    (1, 1000, 16, 2, 128, 300, 0.0),
    (1, 1000, 8, 4, 64, 200, 50.0),
    (1, 1000, 16, 2, 128, 0, 50.0),
    # the embeddings input mode's training shapes: musicgen-medium's MHA
    # (GQA ratio 1, 24 heads of 64) and internvl2-26b's 48/8 heads of 128
    (4, 2048, 24, 24, 64, 0, 0.0),
    (2, 2048, 48, 8, 128, 0, 0.0),
]


# q's scale in a softcap case, so that the scaled scores reach a sizable
# share of the cap (unit-scale inputs keep them near N(0, 1), where the
# softcap is close to the identity and its gradient close to 1)
SOFTCAP_Q_SCALE = 8.0


def _bwd_tol(dtype):
    # against an f32 plain backward, relative to the gradient's largest
    # magnitude: f32 summation order; bf16 the gradients' rounding and the
    # bf16 forward's output (its probabilities rounded before P.V) in D
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,win,cap", BWD_CASES)
def test_flash_backward_kernel_matches_plain_backward(b, s, h, kv, d, win,
                                                      cap, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention.ref import attention_ref_bwd
    gen = torch.Generator(device="cuda").manual_seed(0)
    scales = (SOFTCAP_Q_SCALE if cap else 1.0, 1.0, 1.0)
    q, k, v = ((torch.randn((b, s, n, d), generator=gen, device="cuda") * x)
               .to(dtype).requires_grad_()
               for n, x in zip((h, kv, kv), scales))
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    before, before_bwd = ops.launches, ops.bwd_launches
    out = ops.flash_attention(q, k, v, window=win, softcap=cap)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (ops.launches, ops.bwd_launches) == (before + 1, before_bwd + 1)
    refs = attention_ref_bwd(*(t.detach().float() for t in (q, k, v)),
                             dout.float(), window=win, softcap=cap)
    tol = _bwd_tol(dtype)
    for g, r in zip(grads, refs):
        assert g.dtype == dtype and torch.isfinite(g).all()
        err = float((g.float() - r).abs().max())
        assert err <= tol * float(r.abs().max()), (err, float(r.abs().max()))
    if cap:
        # the check tells the softcap apart: without it the plain backward
        # lies further than the tolerance from the kernel's gradients
        nocap = attention_ref_bwd(*(t.detach().float() for t in (q, k, v)),
                                  dout.float(), window=win)
        for g, r in zip(grads, nocap):
            apart = float((g.float() - r).abs().max())
            assert apart > tol * float(r.abs().max()), (apart,
                                                        float(r.abs().max()))


# (E, C, d, f): granite's training capacity at 4 x 2048 tokens (2560), a
# capacity off the multiple of 8, decode-sized capacities, and C = 5, 157
# and 2560 with d and f off the 128-column tile (the contraction of dw
# ragged or long, dx's columns and dw's rows masked)
GMM_BWD_CASES = [(32, 2560, 1024, 512), (32, 2560, 512, 1024),
                 (8, 157, 256, 128), (8, 5, 256, 128), (4, 2, 104, 72),
                 (4, 5, 104, 72), (4, 157, 104, 72), (4, 2560, 104, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GMM_BWD_CASES)
def test_grouped_matmul_backward_matches_plain_backward(e, c, d, f, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_matmul import ops as gmm
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w = ((torch.randn(shape, generator=gen, device="cuda") * 0.3)
            .to(dtype).requires_grad_() for shape in ((e, c, d), (e, d, f)))
    dy = (torch.randn((e, c, f), generator=gen, device="cuda") * 0.3).to(dtype)
    before = (gmm.launches, gmm.bwd_launches)
    by_variant = dict(gmm.launches_by_variant)
    dx, dw = torch.autograd.grad(gmm.grouped_matmul(x, w), (x, w), dy)
    torch.cuda.synchronize()
    assert (gmm.launches, gmm.bwd_launches) == (before[0] + 1, before[1] + 2)
    # the forward's kernel, then dx and dw: the tile kernel's variants in
    # bf16, the f32 kernel in f32
    if dtype == torch.bfloat16:
        by_variant[gmm._plan(c, d, f)] += 1
        by_variant["dx"] += 1
        by_variant["dw"] += 1
    else:
        by_variant["f32"] += 3
    assert gmm.launches_by_variant == by_variant
    xr, wr = (t.detach().float().requires_grad_() for t in (x, w))
    rx, rw = torch.autograd.grad(grouped_matmul_ref(xr, wr), (xr, wr),
                                 dy.float())
    # f32: summation order over up to 2560 terms; bf16: one output rounding
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    for g, r in ((dx, rx), (dw, rw)):
        assert g.dtype == dtype
        err = float((g.float() - r).abs().max())
        assert err <= tol * float(r.abs().max()), (err, float(r.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d", [(2, 1024, 8, 2, 128),
                                        (2, 1000, 16, 8, 64),
                                        (4, 2048, 24, 24, 64)])
def test_flash_backward_runs_agree(b, s, h, kv, d):
    """Two bf16 backward calls on the same inputs: dK and dV (summed in
    registers) are equal bit for bit; dQ (summed by f32 atomics, in an order
    that varies from run to run) agrees within the bf16 tolerance of the
    check against the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for n in (h, kv, kv))
    dout = torch.randn((b, s, h, d), generator=gen,
                       device="cuda").to(torch.bfloat16)
    out, lse = ops._forward(q, k, v, True, 0, 0.0, with_lse=True)
    first, second = (ops.flash_attention_bwd(q, k, v, out, dout, lse)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    spread = float((first[0].float() - second[0].float()).abs().max())
    assert spread <= _bwd_tol(torch.bfloat16) * float(
        first[0].float().abs().max())


# (b, s, nh, hd, ds, chunk) for the SSD backward: tests/test_kernels.py's
# sweep, the tiling edges of SSD_CASES on the chunk grid (a chunk off the
# 64-row tile, head dims 16 and 128, d_state 7, 16 and 64), and the training
# microbatches of mamba2-370m and zamba2-1.2b
SSD_BWD_CASES = [(2, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
                 (2, 128, 4, 32, 16, 64), (2, 96, 4, 32, 16, 48),
                 (1, 256, 4, 16, 128, 256), (1, 256, 4, 128, 128, 256),
                 (1, 512, 32, 64, 64, 256), (1, 64, 2, 16, 7, 32),
                 (4, 2048, 32, 64, 128, 256), (4, 2048, 64, 64, 64, 256)]
# each gradient within the forward's tolerance, its atol taken relative to
# the gradient's largest magnitude: f32 throughout, summation orders
SSD_BWD_TOL = dict(atol_of_max=5e-4, rtol=5e-3)


def _ssd_kernel_inputs(b, s, nh, hd, ds, ch, wide_decay, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    nc = s // ch
    dt = torch.nn.functional.softplus(rnd(b, s, nh))
    A = -(torch.linspace(1.0, 16.0, nh, device="cuda") if wide_decay else
          torch.exp(torch.linspace(0.0, 1.0, nh, device="cuda")))
    a = (dt.reshape(b, nc, ch, nh) * A).permute(0, 3, 1, 2).contiguous()
    xdt = (rnd(b, s, nh, hd).reshape(b, nc, ch, nh, hd) * 0.3
           * dt.reshape(b, nc, ch, nh, 1)).permute(0, 3, 1, 2, 4).contiguous()
    Bc, Cc = (rnd(b, nc, ch, ds) * 0.3 for _ in range(2))
    return a, xdt, Bc, Cc


@pytest.mark.gpu
@pytest.mark.parametrize("wide_decay", [False, True])
@pytest.mark.parametrize("b,s,nh,hd,ds,ch", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain_backward(b, s, nh, hd, ds, ch,
                                                    wide_decay):
    """The op's gradients on the card (the forward and backward kernels,
    one launch each, through ``SSDIntraChunk``) against the plain backward
    on the same inputs and output gradients; a second backward call gives
    the same bits (the heads' sums run in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref_bwd
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = [t.requires_grad_() for t in _ssd_kernel_inputs(
        b, s, nh, hd, ds, ch, wide_decay, gen)]
    dy = torch.randn(ins[1].shape, generator=gen, device="cuda")
    dS = torch.randn((b, nh, s // ch, ds, hd), generator=gen, device="cuda")
    before = (ssd.launches, ssd.bwd_launches)
    y, S = ssd.ssd_intra_chunk(*ins)
    assert y.grad_fn is not None and S.grad_fn is not None
    grads = torch.autograd.grad((y, S), ins, (dy, dS))
    torch.cuda.synchronize()
    assert (ssd.launches - before[0], ssd.bwd_launches - before[1]) == (1, 1)
    refs = ssd_intra_chunk_ref_bwd(*(t.detach() for t in ins), dy, dS)
    for name, g, r in zip(("da", "dxdt", "dB", "dC"), grads, refs):
        assert torch.isfinite(g).all(), name
        top = float(r.abs().max())
        torch.testing.assert_close(
            g, r, atol=SSD_BWD_TOL["atol_of_max"] * top,
            rtol=SSD_BWD_TOL["rtol"], msg=lambda m: f"{name}: {m}")
    again = ssd.ssd_intra_chunk_bwd(*(t.detach() for t in ins), dy, dS)
    assert all(torch.equal(g, h) for g, h in zip(grads, again))


def _ssd_bwd_args(case, gen):
    """The backward's inputs at ``case`` with mamba2's decay range, and
    output gradients."""
    b, s, nh, hd, ds, ch = case
    a, xdt, Bc, Cc = _ssd_kernel_inputs(b, s, nh, hd, ds, ch, True, gen)
    dy = torch.randn(xdt.shape, generator=gen, device="cuda")
    dS = torch.randn((b, nh, s // ch, ds, hd), generator=gen, device="cuda")
    return a, xdt, Bc.contiguous(), Cc.contiguous(), dy, dS


# the backward's four grids, by kernel name
# a rank's shard of mamba2-370m under a (data 1, model 2) policy: 16 of its
# 32 SSM heads, B and C whole (d_state 128), at sharded_mamba2's prefill
# (1 x 1024) and training microbatch (2 x 2048), the models' decay range
SSD_LOCAL_SHARD_CASES = [(1, 1024, 16, 64, 128, 256),
                         (2, 2048, 16, 64, 128, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hd,ds,ch", SSD_LOCAL_SHARD_CASES)
def test_ssd_kernel_at_a_local_shard(b, s, nh, hd, ds, ch):
    _check_ssd(b, s, nh, hd, ds, ch, wide_decay=True)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hd,ds,ch", SSD_LOCAL_SHARD_CASES)
def test_ssd_backward_at_a_local_shard(b, s, nh, hd, ds, ch):
    test_ssd_backward_kernel_matches_plain_backward(b, s, nh, hd, ds, ch,
                                                    wide_decay=True)


SSD_BWD_GRIDS = ("bwd_prep_kernel", "bwd_dg_kernel", "bwd_head_kernel",
                 "bwd_dbc_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hd,ds,ch", [(1, 512, 32, 64, 64, 256),
                                             (4, 2048, 64, 64, 64, 256)])
def test_ssd_backward_gives_the_same_bits_run_to_run(b, s, nh, hd, ds, ch):
    """Two backward calls on the same inputs give the same bits, at
    zamba2's d_state and at its training microbatch: every sum of the four
    grids runs in a fixed order, none by atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd import ops as ssd
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = _ssd_bwd_args((b, s, nh, hd, ds, ch), gen)
    one = ssd.ssd_intra_chunk_bwd(*args)
    two = ssd.ssd_intra_chunk_bwd(*args)
    for name, g, h in zip(("da", "dxdt", "dB", "dC"), one, two):
        assert torch.equal(g, h), name


@pytest.mark.gpu
def test_ssd_backward_launches_only_its_four_grids():
    """One profiled backward call at mamba2's training microbatch: its four
    grids, each once, and no other device work (the wrapper only
    allocates)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.profiling import device_kernels
    from repro_torch.kernels.ssd import ops as ssd
    gen = torch.Generator(device="cuda").manual_seed(2)
    args = _ssd_bwd_args((4, 2048, 32, 64, 128, 256), gen)
    grids = device_kernels(lambda: ssd.ssd_intra_chunk_bwd(*args))
    roles = [[g for g in SSD_BWD_GRIDS if g in n] for n in grids]
    assert all(len(r) == 1 for r in roles), grids
    assert sorted(r[0] for r in roles) == sorted(SSD_BWD_GRIDS), grids
    assert all(calls == 1 for _, calls in grids.values()), grids


@pytest.mark.gpu
def test_ssd_chunked_gradients_on_the_card_match_the_cpu():
    """The chunked op's gradients for x, dt, A, B and C at a ragged length
    on the card (the kernels) against the CPU (autograd through the plain
    version), from the same inputs: the intra-chunk term's gradient is not
    dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd import ops as ssd
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    b, s, nh, hd, ds, ch = 2, 200, 4, 32, 16, 64
    x = torch.randn((b, s, nh, hd), generator=gen) * 0.3
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=gen))
    A = -torch.linspace(1.0, 16.0, nh)
    B, C = (torch.randn((b, s, ds), generator=gen) * 0.3 for _ in range(2))
    wy = torch.randn((b, s, nh, hd), generator=gen)
    wst = torch.randn((b, nh, hd, ds), generator=gen)
    grads = {}
    for dev in ("cpu", "cuda"):
        ins = [t.to(dev).requires_grad_() for t in (x, dt, A, B, C)]
        y, st = ssd.ssd_chunked(*ins, ch)
        loss = (y * wy.to(dev)).sum() + (st * wst.to(dev)).sum()
        before = ssd.bwd_launches
        grads[dev] = torch.autograd.grad(loss, ins)
        assert ssd.bwd_launches == before + (dev == "cuda")
    for name, g, r in zip(("x", "dt", "A", "B", "C"), grads["cuda"],
                          grads["cpu"]):
        torch.testing.assert_close(g.cpu(), r, atol=5e-4 * float(
            r.abs().max()), rtol=5e-3, msg=lambda m: f"{name}: {m}")


# -- the distributed layer on the card ----------------------------------------

GLOO_CASES = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
              "send_recv", "dtensor_partial_to_replicate",
              "dtensor_partial_to_shard", "dtensor_shard_to_replicate",
              "dtensor_shard0_to_shard1"]


@pytest.fixture(scope="module")
def gloo_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_dist_ranks
    from repro_torch.distributed.spawn import run_ranks
    return run_ranks(torch_dist_ranks.gloo_cuda_collectives, 2,
                     backend="gloo", device_type="cuda", timeout=300,
                     threads=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GLOO_CASES)
def test_gloo_collective_of_cuda_tensors_goes_through_the_host(gloo_cuda,
                                                                case):
    """Two ranks share the card over gloo, which takes no CUDA tensor: each
    collective, the port's helpers' and DTensor's redistributes, gives the
    exact result on the card, and was staged through the host."""
    for rank_out in gloo_cuda:
        on_card, equal, staged = rank_out[case]
        assert on_card and equal, (case, rank_out[case])
        assert sum(staged.values()) >= 1, (case, staged)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_a_strided_local_shard():
    """A Shard of a middle dim taken as a view is strided: the flash and
    grouped-matmul wrappers raise on it rather than read it wrong (the
    sharded path hands them contiguous locals)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    q = torch.randn(2, 64, 8, 64, device="cuda",
                    dtype=torch.bfloat16).chunk(2, dim=2)[0]
    k = torch.randn(2, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    assert not q.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k, k.clone())
    x = torch.randn(8, 32, 64, device="cuda",
                    dtype=torch.bfloat16).chunk(2, dim=0)[0].transpose(1, 2)
    w = torch.randn(4, 32, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_ops.grouped_matmul(x, w)


@pytest.mark.gpu
def test_flash_backward_sums_dq_where_the_meta_rule_says():
    """A meta call (the dry-run) cannot ask the library whether the
    backward sums dQ into a zeroed f32 buffer, so the wrapper allocates it
    by ``SUMS_DQ_HEAD_DIMS``: the library's answer, at every head dim and
    dtype the kernel takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lib = ops.load_library()
    for dtype, code in ops._DTYPE_CODE.items():
        for d in ops.BWD_HEAD_DIMS:
            want = dtype == torch.bfloat16 and d in ops.SUMS_DQ_HEAD_DIMS
            assert bool(lib.flash_attention_bwd_sums_dq(code, d)) == want
