"""The port's step analysis (``repro_torch.launch.op_analysis``, the
counterpart of JAX's ``hlo_analysis``) against programs with known costs,
the kernels' cost functions against ``PERF.md``'s bounds, each kernel op's
meta branch against its cost function, and the dry-run's lowering proxies
against JAX's on the same numpy inputs in float32.

The JAX package's ``tests/test_hlo_analysis.py`` holds its analyzer to the
same three programs (a loop of 5 products, a 3 x 4 nested loop, the bytes
of one 256^2 product). The fake-process-group check runs in a process of
its own (``tests/torch_dryrun_cells.py``): the group is global.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import costs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch.op_analysis import analyze_step, trips

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")


def run_cells(name: str, timeout: int = 300):
    """``tests/torch_dryrun_cells.py``'s ``name`` in a process of its own:
    its JSON line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, str(TESTS)])
    r = subprocess.run([sys.executable, "-m", "torch_dryrun_cells", name],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=TESTS)
    assert r.returncode == 0, r.stdout[-3000:] + "\n" + r.stderr[-5000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# -- programs with known costs (JAX's test_hlo_analysis) --------------------

def test_loop_dot_flops_exact():
    ws = torch.zeros(5, 64, 64, dtype=torch.bfloat16)
    x = torch.zeros(8, 64, dtype=torch.bfloat16)

    def f(ws, x):
        h = x
        for w in ws:
            h = torch.tanh(h @ w)
        return h.sum()
    _, stats = analyze_step(f, ws, x)
    assert stats.dot_flops == 5 * 2 * 8 * 64 * 64
    assert stats.flops == stats.dot_flops


@pytest.mark.parametrize("weight_loops", [False, True])
def test_nested_loops_multiply(weight_loops):
    """A 3 x 4 nested loop of (2, 32) x (32, 32) products: every iteration
    run, or two of each ``trips`` loop, the second weighted by the rest of
    its count (on meta tensors, as the dry-run weights its loops)."""
    dev = "meta" if weight_loops else "cpu"
    ws = torch.zeros(3, 4, 32, 32, device=dev)
    x = torch.zeros(2, 32, device=dev)

    def f(ws, x):
        h = x
        for i in trips(3):
            for j in trips(4):
                h = torch.tanh(h @ ws[i, j])
        return h.sum()
    _, stats = analyze_step(f, ws, x, weight_loops=weight_loops)
    assert stats.dot_flops == 3 * 4 * 2 * 2 * 32 * 32


def test_memory_bytes_reasonable():
    a = torch.zeros(256, 256)
    _, stats = analyze_step(lambda a: (a @ a).sum(), a)
    # the product reads 2 x 256 KB and writes 256 KB (+ the sum), as JAX's
    assert 0.5e6 < stats.hbm_bytes < 4e6
    # the argument, then the product and the sum live beside it
    assert stats.memory["argument_bytes"] == 256 * 256 * 4
    assert stats.memory["peak_bytes"] >= 2 * 256 * 256 * 4


def test_dtensor_product_counts_rank_local_flops():
    """On a (16, 16) fake mesh a (64, 4096) x (4096, 4096) DTensor product
    counts rank 0's local (4, 4096) x (4096, 256) product only, the same on
    the first call (when DTensor's sharding propagation runs it on fake
    tensors at the global shapes) and the second. A Shard(0) -> Shard(1)
    redistribution counts one all-to-all, where the fake group's ``cpu``
    mesh would run an all-gather and a chunk."""
    out = run_cells("dtensor_product")
    assert out["calls"] == [2 * 4 * 4096 * 256] * 2 == [8_388_608] * 2
    # a Shard -> Shard move is the one all-to-all a CUDA mesh issues: rank
    # 0's (4, 4096) f32 rows become its (64, 256) columns, over 16 ranks
    out_bytes = 64 * 256 * 4
    assert out["shard_to_shard"] == {"all-to-all": {
        "count": 1, "raw_bytes": out_bytes,
        "wire_bytes": out_bytes * 15 / 16}}


# -- the kernels' cost functions ---------------------------------------------

# PERF.md §6's bounds, ms, at their shapes (B, S, H, KV, D, window) bf16
@pytest.mark.parametrize("fn, args, table", [
    ("attention_bound_ms", (4, 1024, 32, 4, 128, 0), "0.0348"),
    ("attention_bound_ms", (4, 2048, 24, 24, 64, 0), "0.0521"),
    ("attention_bound_ms", (2, 2048, 48, 8, 128, 0), "0.1043"),
    ("attention_bound_ms", (2, 1024, 48, 8, 128, 0), "0.0261"),
    ("attention_bwd_bound_ms", (4, 2048, 32, 4, 128, 0), "0.3476"),
    ("attention_bwd_bound_ms", (4, 2048, 16, 8, 64, 0), "0.0869"),
    ("attention_bwd_bound_ms", (4, 2048, 24, 24, 64, 0), "0.1303"),
    ("attention_bwd_bound_ms", (2, 2048, 48, 8, 128, 0), "0.2607"),
    ("attention_bwd_bound_ms", (1, 2048, 16, 8, 256, 1024), "0.0652"),
    ("attention_bwd_bound_ms", (1, 2048, 16, 8, 256, 0), "0.0869"),
    ("gmm_bound_ms", (32, 320, 1024, 512), "0.0194"),
    ("gmm_bound_ms", (32, 2, 1024, 512), "0.0101"),
    ("gmm_bwd_bound_ms", (32, 2560, 1024, 512), "0.1737"),
])
def test_bf16_bounds_match_perf_table(fn, args, table):
    ms, _ = getattr(costs, fn)(*args, torch.bfloat16)
    assert abs(ms - float(table)) <= 0.5 * 10.0 ** -len(table.split(".")[1])


# (b, nh, nc, c, hd, ds): mamba2's and zamba2's prefill of 1 x 1024, their
# training microbatches of 4 x 2048, chunks of 256
@pytest.mark.parametrize("fn, args, table, by", [
    ("ssd_bound_ms", (1, 32, 4, 256, 64, 128), "0.00672", "operations"),
    ("ssd_bound_ms", (1, 64, 4, 256, 64, 64), "0.0115", "bytes"),
    ("ssd_bwd_bound_ms", (4, 32, 8, 256, 64, 128), "0.1092", "operations"),
    ("ssd_bwd_bound_ms", (4, 64, 8, 256, 64, 64), "0.1590", "operations"),
])
def test_ssd_bounds_match_perf_table(fn, args, table, by):
    ms, bound_by = getattr(costs, fn)(*args)
    assert abs(ms - float(table)) <= 0.5 * 10.0 ** -len(table.split(".")[1])
    assert bound_by == by


@pytest.mark.parametrize("s, window", [(1, 0), (7, 0), (1024, 0), (100, 40),
                                       (2048, 1024), (40, 40), (30, 64)])
def test_attention_pairs_counts_the_unmasked_pairs(s, window):
    qpos = np.arange(s)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, int)
    assert costs.attention_pairs(s, window) == int(np.sum(qpos - lo + 1))


# -- each kernel op on meta: its report, no launch, no plain version --------

def _meta(shape, dtype, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _fwd_bwd(op, inputs):
    def step(*xs):
        out = op(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(outs, xs,
                                   [torch.empty_like(o) for o in outs])
    return analyze_step(step, *inputs)[1]


def _no_launch_no_plain(monkeypatch, module, plain):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on meta tensors")
    monkeypatch.setattr(module, plain, refuse)
    monkeypatch.setattr(module, "load_library", refuse)
    before = (module.launches, module.bwd_launches)
    return lambda: (module.launches, module.bwd_launches) == before


@pytest.mark.parametrize("b, s, h, kv, d, window, dtype", [
    (2, 128, 4, 2, 128, 0, torch.bfloat16),
    (1, 96, 4, 4, 64, 40, torch.bfloat16),
    (1, 64, 2, 1, 256, 0, torch.float32),
])
def test_flash_meta_reports_its_cost(monkeypatch, b, s, h, kv, d, window,
                                     dtype):
    unchanged = _no_launch_no_plain(monkeypatch, fa_ops, "attention_ref")
    q = _meta((b, s, h, d), dtype)
    k, v = _meta((b, s, kv, d), dtype), _meta((b, s, kv, d), dtype)
    stats = _fwd_bwd(lambda q, k, v: fa_ops.flash_attention(
        q, k, v, window=window), (q, k, v))
    fwd = costs.attention_cost(b, s, h, kv, d, window, dtype)
    bwd = costs.attention_bwd_cost(b, s, h, kv, d, window, dtype)
    assert stats.kernel_calls == {"flash_attention": {"fwd": 1, "bwd": 1}}
    assert stats.kernel_flops["flash_attention"] == {"fwd": fwd.flops,
                                                     "bwd": bwd.flops}
    assert stats.kernel_bytes["flash_attention"] == {"fwd": fwd.bytes,
                                                     "bwd": bwd.bytes}
    assert unchanged()


@pytest.mark.parametrize("e, c, d, f, dtype", [
    (4, 40, 64, 32, torch.bfloat16),      # the tile kernel
    (4, 2, 64, 32, torch.bfloat16),       # the streaming kernel
    (3, 10, 16, 24, torch.float32),       # the f32 kernel, on copies
])
def test_grouped_matmul_meta_reports_its_cost(monkeypatch, e, c, d, f,
                                              dtype):
    unchanged = _no_launch_no_plain(monkeypatch, gmm_ops,
                                    "grouped_matmul_ref")
    by_variant = dict(gmm_ops.launches_by_variant)
    stats = _fwd_bwd(gmm_ops.grouped_matmul,
                     (_meta((e, c, d), dtype), _meta((e, d, f), dtype)))
    # dx = dy.w^T is (E, C, f) @ (E, f, d), dw = x^T.dy (E, d, C) @ (E, C, f)
    want = {"fwd": costs.gmm_cost(e, c, d, f, dtype),
            "dx": costs.gmm_cost(e, c, f, d, dtype),
            "dw": costs.gmm_cost(e, d, c, f, dtype)}
    assert stats.kernel_calls == {"grouped_matmul": dict.fromkeys(want, 1)}
    assert stats.kernel_flops["grouped_matmul"] == {
        k: v.flops for k, v in want.items()}
    assert stats.kernel_bytes["grouped_matmul"] == {
        k: v.bytes for k, v in want.items()}
    bwd = costs.gmm_bwd_cost(e, c, d, f, dtype)
    assert want["dx"].flops + want["dw"].flops == bwd.flops
    assert unchanged() and gmm_ops.launches_by_variant == by_variant


@pytest.mark.parametrize("b, nh, nc, c, hd, ds", [(1, 4, 2, 64, 16, 32),
                                                  (2, 2, 3, 96, 64, 16)])
def test_ssd_meta_reports_its_cost(monkeypatch, b, nh, nc, c, hd, ds):
    unchanged = _no_launch_no_plain(monkeypatch, ssd_ops,
                                    "ssd_intra_chunk_ref")
    f32 = torch.float32
    stats = _fwd_bwd(ssd_ops.ssd_intra_chunk,
                     (_meta((b, nh, nc, c), f32),
                      _meta((b, nh, nc, c, hd), f32),
                      _meta((b, nc, c, ds), f32), _meta((b, nc, c, ds), f32)))
    fwd = costs.ssd_cost(b, nh, nc, c, hd, ds)
    bwd = costs.ssd_bwd_cost(b, nh, nc, c, hd, ds)
    assert stats.kernel_calls == {"ssd_intra_chunk": {"fwd": 1, "bwd": 1}}
    assert stats.kernel_flops["ssd_intra_chunk"] == {"fwd": fwd.flops,
                                                     "bwd": bwd.flops}
    assert stats.kernel_bytes["ssd_intra_chunk"] == {"fwd": fwd.bytes,
                                                     "bwd": bwd.bytes}
    assert unchanged()


def test_meta_allocates_the_cards_workspaces():
    """A meta call allocates what the card's wrapper does (the SSD
    backward's workspaces, the bf16 flash backward's f32 dQ buffer), so the
    step's peak memory counts them."""
    f32 = torch.float32
    b, nh, nc, c, hd, ds = 1, 4, 2, 64, 16, 32
    args = (_meta((b, nh, nc, c), f32, False),
            _meta((b, nh, nc, c, hd), f32, False),
            _meta((b, nc, c, ds), f32, False), _meta((b, nc, c, ds), f32,
                                                     False))
    dy, ds_ = _meta((b, nh, nc, c, hd), f32, False), \
        _meta((b, nh, nc, ds, hd), f32, False)
    _, stats = analyze_step(ssd_ops.ssd_intra_chunk_bwd, *args, dy, ds_)
    outs = sum(t.numel() * 4 for t in args)
    assert stats.memory["temp_bytes"] >= outs + \
        ssd_ops.bwd_workspace_bytes(b, nh, nc, c, ds)


# -- the dry-run's lowering proxies against JAX's ----------------------------

def test_attention_fused_proxy_matches_jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config, reduced as j_reduced
    from repro.models.layers import attention_fused_proxy as j_proxy
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as L

    rng = np.random.RandomState(0)
    cfg, jcfg = reduced(get_config("yi-9b")), j_reduced(j_get_config("yi-9b"))
    b, s, h, kv, d = 2, 24, 4, 2, cfg.head_dim
    q, k, v = (rng.randn(b, s, n, d).astype(np.float32) * 0.5
               for n in (h, kv, kv))
    for window in (0, 8):
        want = np.asarray(j_proxy(jcfg, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window))
        got = L.attention_fused_proxy(cfg, torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), window=window)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    del jax


def test_ssd_fused_proxy_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.mamba2 import ssd_fused_proxy as j_proxy
    from repro_torch.models.mamba2 import ssd_fused_proxy

    rng = np.random.RandomState(1)
    b, s, nh, hd, ds, chunk = 2, 32, 3, 8, 4, 8
    x = rng.randn(b, s, nh, hd).astype(np.float32) * 0.5
    dt = rng.rand(b, s, nh).astype(np.float32)
    A = -np.exp(rng.randn(nh)).astype(np.float32)
    B, C = (rng.randn(b, s, ds).astype(np.float32) * 0.5 for _ in range(2))
    want_y, want_s = j_proxy(*(jnp.asarray(t) for t in (x, dt, A, B, C)),
                             chunk)
    got_y, got_s = ssd_fused_proxy(*(torch.from_numpy(t)
                                     for t in (x, dt, A, B, C)), chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
    assert got_s.dtype == torch.float32


def test_mamba_block_and_attention_dispatch_the_proxies_as_jax():
    """``ssd_impl="fused_proxy"`` makes ``mamba_block`` (JAX's at
    ``mamba2.py:242``) take the SSD proxy, and ``attn_impl`` the attention
    proxy (``layers.py:329``): the port's block against JAX's from the same
    params, f32, on the chunk grid; and a train step through the block, whose
    unread dt params get zero gradients, as from ``jax.grad``."""
    import dataclasses
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config, reduced as j_reduced
    from repro.models import mamba2 as jm
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as m

    jcfg = dataclasses.replace(j_reduced(j_get_config("mamba2-370m")),
                               dtype="float32", ssd_impl="fused_proxy")
    cfg = dataclasses.replace(reduced(get_config("mamba2-370m")),
                              dtype="float32", ssd_impl="fused_proxy")
    jp, _ = jm.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)).requires_grad_()
         for k, v in jp.items()}
    h = np.random.RandomState(2).randn(2, 2 * cfg.ssm.chunk_size,
                                       cfg.d_model).astype(np.float32) * 0.5
    want = np.asarray(jm.mamba_block(jp, jcfg, jnp.asarray(h)))
    got = m.mamba_block(p, cfg, torch.from_numpy(h))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    grads = torch.autograd.grad(got.sum(), list(p.values()),
                                allow_unused=True)
    unread = {k for k, g in zip(p, grads) if g is None}
    assert unread and unread <= {"A_log", "dt_bias", "w_dt"}

    tcfg = dataclasses.replace(reduced(get_config("yi-9b")),
                               attn_impl="fused_proxy")
    q, k, v = (torch.randn(1, 8, n, tcfg.head_dim) for n in (4, 2, 2))
    torch.testing.assert_close(L.attention(tcfg, q, k, v),
                               L.attention_fused_proxy(tcfg, q, k, v))
