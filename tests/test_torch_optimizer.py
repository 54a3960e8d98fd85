"""The port's AdamW against the JAX package's, float32 params on the CPU,
from the same numpy params and gradients: the schedule, five updates with
f32, bf16 and int8 moments, clipping, and no decay on 1-D params."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

# a stacked 3-D leaf, a matrix, a 1-D norm and a bias inside a list, as the
# models' trees hold them
SHAPES = {"blocks": [{"w": (3, 8, 16), "ln": (16,)}],
          "embed": {"tok": (24, 16)}, "final_norm": (16,)}


def _draw(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_draw(rng, v, scale) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _torch(tree):
    return adamw.tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _assert_trees(t_tree, j_tree, atol, rtol=0.0):
    j_leaves = jax.tree.leaves(j_tree)
    t_leaves = adamw.leaves(t_tree)
    assert len(j_leaves) == len(t_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.dtype == getattr(torch, np.asarray(j).dtype.name) or \
            np.asarray(j).dtype.name == "bfloat16"
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j).astype(np.float32),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("warmup,total,peak,min_frac",
                         [(5, 10, 3e-4, 0.1), (2, 100, 1e-3, 0.0),
                          (0, 50, 3e-4, 0.1), (100, 10_000, 3e-4, 0.1)])
def test_schedule_matches_jax(warmup, total, peak, min_frac):
    jcfg = jax_adamw.OptimizerConfig(peak_lr=peak, warmup_steps=warmup,
                                     total_steps=total, min_lr_frac=min_frac)
    tcfg = adamw.OptimizerConfig(peak_lr=peak, warmup_steps=warmup,
                                 total_steps=total, min_lr_frac=min_frac)
    steps = np.arange(0, total + 20, dtype=np.int32)
    want = np.asarray(jax_adamw.schedule(jcfg, jnp.asarray(steps)))
    got = adamw.schedule(tcfg, torch.tensor(steps)).numpy()
    # f32 on both sides; XLA's and torch's cos differ in the last bit,
    # which is large against the tail of a cosine to 0: atol 1e-6 of peak
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * peak)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_update_matches_jax_over_five_steps(moments):
    rng = np.random.default_rng(0)
    params = _draw(rng, SHAPES, 1.0)
    kw = dict(warmup_steps=2, total_steps=10, moment_dtype=moments)
    jcfg = jax_adamw.OptimizerConfig(**kw)
    tcfg = adamw.OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_adamw.init(jp, jcfg)
    tp = _torch(params)
    ts = adamw.init(tp, tcfg)
    for _ in range(5):
        grads = _draw(rng, SHAPES, 3.0)     # above the clip norm
        jp, js, jstats = jax_adamw.update(jax.tree.map(jnp.asarray, grads),
                                          js, jp, jcfg)
        tp, ts, tstats = adamw.update(_torch(grads), ts, tp, tcfg)
        # f32: the norm's summation order
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                                   rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 5
    # params: a few f32 roundings of lr * step (~3e-4) apart
    _assert_trees(tp, jp, atol=1e-6)
    if moments == "int8":
        for key in ("m", "v"):
            # a payload may round the other way where x / scale sits on .5
            got = np.concatenate([t.numpy().ravel()
                                  for t in adamw.leaves(ts[key])])
            want = np.concatenate([np.asarray(j).ravel()
                                   for j in jax.tree.leaves(js[key])])
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            _assert_trees(ts[key + "_scale"], js[key + "_scale"], 0.0,
                          rtol=1e-5)
    else:
        # moments in their storage dtype: bf16 to one rounding
        tol = 1e-6 if moments == "float32" else 1e-2
        _assert_trees(ts["m"], js["m"], atol=tol, rtol=tol)
        _assert_trees(ts["v"], js["v"], atol=tol, rtol=tol)


@pytest.mark.parametrize("clip_norm", [0.0, 1.0, 1e4])
def test_clipping_matches_jax(clip_norm):
    """Off (0), biting (1.0 against a norm of ~70) and slack (1e4)."""
    rng = np.random.default_rng(1)
    params = _draw(rng, SHAPES, 1.0)
    grads = _draw(rng, SHAPES, 5.0)
    jcfg = jax_adamw.OptimizerConfig(clip_norm=clip_norm, warmup_steps=0)
    tcfg = adamw.OptimizerConfig(clip_norm=clip_norm, warmup_steps=0)
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, _ = jax_adamw.update(jax.tree.map(jnp.asarray, grads),
                                jax_adamw.init(jp, jcfg), jp, jcfg)
    tp = _torch(params)
    tp, _, stats = adamw.update(_torch(grads), adamw.init(tp, tcfg), tp, tcfg)
    _assert_trees(tp, jp, atol=1e-6)
    assert float(stats["grad_norm"]) > 50


def test_no_decay_on_1d_params():
    """Zero gradients leave the moments 0 and the Adam term 0, so only the
    decay moves a param: the 2-D and 3-D ones shrink by lr * wd, the 1-D
    ones stay, as in JAX."""
    rng = np.random.default_rng(2)
    params = _draw(rng, SHAPES, 1.0)
    zeros = adamw.tree_map(np.zeros_like, params)
    jcfg = jax_adamw.OptimizerConfig(warmup_steps=0, weight_decay=0.5)
    tcfg = adamw.OptimizerConfig(warmup_steps=0, weight_decay=0.5)
    tp = _torch(params)
    tp, _, stats = adamw.update(_torch(zeros), adamw.init(tp, tcfg), tp, tcfg)
    lr = float(stats["lr"])
    for key, got in (("final_norm", tp["final_norm"]),
                     ("ln", tp["blocks"][0]["ln"])):
        want = params["final_norm"] if key == "final_norm" else \
            params["blocks"][0]["ln"]
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tp["embed"]["tok"].numpy(),
                               params["embed"]["tok"] * (1 - lr * 0.5),
                               rtol=1e-6)
    np.testing.assert_allclose(tp["blocks"][0]["w"].numpy(),
                               params["blocks"][0]["w"] * (1 - lr * 0.5),
                               rtol=1e-6)
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, _ = jax_adamw.update(jax.tree.map(jnp.asarray, zeros),
                                jax_adamw.init(jp, jcfg), jp, jcfg)
    _assert_trees(tp, jp, atol=1e-7)


def test_bf16_params_round_to_their_dtype_and_chunks_agree(monkeypatch):
    """bf16 params stay bf16 after a step (no f32 master copy), and the
    chunked update equals the whole-leaf one."""
    rng = np.random.default_rng(3)
    params = _draw(rng, SHAPES, 1.0)
    grads = _draw(rng, SHAPES, 1.0)
    cfg = adamw.OptimizerConfig(warmup_steps=0)
    runs = []
    for chunk in (adamw.CHUNK, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        tp = adamw.tree_map(lambda x: torch.tensor(x).to(torch.bfloat16),
                            params)
        tp, ts, _ = adamw.update(_torch(grads), adamw.init(tp, cfg), tp, cfg)
        assert all(t.dtype == torch.bfloat16 for t in adamw.leaves(tp))
        runs.append((tp, ts))
    for a, b in zip(adamw.leaves(runs[0]), adamw.leaves(runs[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_of_a_full_width_leaf_matches_jax(dtype, monkeypatch):
    """A 19M-element leaf (musicgen-medium's two stacked MLP ``wo``
    gradients) beside a small one, the large one in chunks (of 5M elements
    here): the norm is JAX's, and the f64 one, within the rounding of f32
    sums over 19M terms (~25 halvings, 2^-24 each); a running f32 sum on
    the CPU is 1e-3 off."""
    monkeypatch.setattr(adamw, "NORM_CHUNK", 5_000_000)
    rng = np.random.default_rng(0)
    tree = {"wo": (rng.standard_normal((2, 6144, 1536)) * 0.05
                   + 0.01).astype(np.float32),
            "ln": rng.standard_normal(1536).astype(np.float32)}
    tt = adamw.tree_map(lambda x: torch.tensor(x).to(getattr(torch, dtype)),
                        tree)
    exact = np.sqrt(sum(np.sum(t.double().numpy() ** 2)
                        for t in adamw.leaves(tt)))
    jt = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.dtype(dtype)), tt)
    got = float(adamw.global_norm(tt))
    np.testing.assert_allclose(got, float(jax_adamw.global_norm(jt)),
                               rtol=1e-5)
    np.testing.assert_allclose(got, exact, rtol=1e-5)
