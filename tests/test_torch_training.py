"""The port's training path against the JAX package's, float32 on the CPU:
the loss, the microbatch pick, the gradients of the flash op's and the
grouped matmul's plain paths, five train steps of reduced yi-9b,
granite-moe and gemma2, and of musicgen and internvl2 on (B, S, d)
embedding batches (each block remat'd), from bridged params at 1 and 2
microbatches, and the remat policies. The SSM and hybrid are in
test_torch_ssm_training.py."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS, SHAPES, get_config, reduced  # noqa: E402
from repro.kernels.grouped_matmul.ref import \
    grouped_matmul_ref as jax_gmm_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.optim.adamw import OptimizerConfig as JaxOpt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref_bwd  # noqa: E402
from repro_torch.kernels.grouped_matmul import ops as gmm_ops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import (train_state_from_numpy,  # noqa: E402
                                       train_state_to_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import OptimizerConfig  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

TRANSFORMERS = ["yi-9b", "granite-moe-1b-a400m", "gemma2-27b"]
# the embeddings input mode, each super-block under remat "full" on both
# sides: the blocks' input (the batch) needs no gradient, and the first
# block's params get theirs all the same
EMBEDDINGS = ["musicgen-medium", "internvl2-26b"]
OPT = dict(warmup_steps=2, total_steps=10)


def _cfgs(arch, **over):
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               **over)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)),
                               dtype="float32", **over)
    return jcfg, tcfg


def _batches(vocab, n, b=4, s=32, seed=0, d=0):
    """Token batches, or with ``d`` unit-scale (B, S, d) f32 embeddings
    beside the token labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(1, vocab, size=(b, s + 1)).astype(np.int32)
        out.append({"inputs": toks[:, :-1], "labels": toks[:, 1:]})
        if d:
            out[-1]["inputs"] = rng.standard_normal((b, s, d)).astype(
                np.float32)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- the loss and the microbatch pick ----------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    """A padded vocab (Vp 40 > 33) and, optionally, a label mask."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 33,
                             None if mask is None else jnp.asarray(mask))
    got = tts.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), 33,
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an all-zero mask divides by 1, as JAX's maximum(sum, 1)
    zero = np.zeros((2, 7), np.float32)
    assert float(tts.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 33,
                                   torch.from_numpy(zero))) == 0.0


def test_pick_microbatches_matches_jax_for_every_config():
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            for dp in (1, 4, 16):
                assert tts.pick_microbatches(
                    t_get_config(arch), T_SHAPES[name], dp) == \
                    jts.pick_microbatches(get_config(arch), shape, dp), \
                    (arch, name, dp)


def test_state_axes_matches_jax():
    axes = {"embed": {"tok": ("vocab", "embed")}, "final_norm": ("norm",)}
    assert tts.state_axes(axes) == jts.state_axes(axes)


# -- the plain paths' gradients ------------------------------------------------

@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 0.0), (0, 30.0),
                                        (8, 50.0)])
def test_flash_op_gradients_match_jax_attention(window, cap):
    """jax.grad of JAX's ``layers.attention`` (its naive path at this size)
    against autograd through the port's op on the CPU (the plain version),
    GQA 4 q heads over 2 kv heads."""
    jcfg = dataclasses.replace(reduced(get_config("gemma2-27b")),
                               attn_softcap=cap, dtype="float32")
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 24, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    w = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_layers.attention(jcfg, q, k, v, window=window) * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa_ops.flash_attention(tq, tk, tv, window=window, softcap=cap)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    # the plain backward the card's kernel is held to: the same gradients
    plain = attention_ref_bwd(*map(torch.from_numpy, (q, k, v, w)),
                              window=window, softcap=cap)
    for g, p, jg in zip(got, plain, want):
        torch.testing.assert_close(p, g, atol=0, rtol=0)
        # f32: summation order over 24 keys and 16 head dims
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-5,
                                   rtol=2e-5)


def test_grouped_matmul_gradients_match_jax_ref():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 13, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24, 40)).astype(np.float32)
    dy = rng.standard_normal((4, 13, 40)).astype(np.float32)
    want = jax.grad(lambda x, w: jnp.sum(jax_gmm_ref(x, w) * dy),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = torch.autograd.grad(gmm_ops.grouped_matmul(tx, tw), (tx, tw),
                              torch.from_numpy(dy))
    for g, jg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-5,
                                   rtol=2e-5)


# -- the train step ------------------------------------------------------------

def _jax_and_port(arch, mb, **over):
    jcfg, tcfg = _cfgs(arch, **over)
    jmodel = jax_build(jcfg)
    jstate, _ = jts.init_state(jmodel, JaxOpt(**OPT), jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(jmodel, jcfg, JaxOpt(**OPT),
                                        jts.TrainStepConfig(microbatches=mb)))
    tmodel = build_model(tcfg, device="cpu")
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tstep = tts.make_train_step(tmodel, tcfg, OptimizerConfig(**OPT),
                                tts.TrainStepConfig(microbatches=mb))
    return jcfg, jstate, jstep, tstate, tstep


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", TRANSFORMERS + EMBEDDINGS)
def test_train_step_matches_jax_over_five_steps(arch, mb):
    embeddings = arch in EMBEDDINGS
    jcfg, jstate, jstep, tstate, tstep = _jax_and_port(
        arch, mb, **({"remat_policy": "full"} if embeddings else {}))
    d = jcfg.d_model if embeddings else 0
    for batch in _batches(jcfg.vocab_size, 5, d=d):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, _tb(batch))
        # f32 both sides: the loss over 128 tokens and the grad norm over
        # every param, summed in other orders
        for key, rtol in (("loss", 1e-5), ("aux_loss", 1e-5),
                          ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, atol=1e-6, err_msg=key)
    want = jax.tree.leaves(jstate["params"])
    got = adamw.leaves(tstate["params"])
    assert len(got) == len(want)
    # tests/test_training.py's tolerance for accumulation orders
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-4)
    assert int(tstate["opt"]["count"]) == 5
    if embeddings:
        # every leaf, the first block's among them, had a non-zero gradient
        # (its first moment is not zero)
        paths = jax.tree_util.tree_leaves_with_path(tstate["opt"]["m"])
        assert [p for p, m in paths if not m.any()] == []


def test_moe_aux_term_is_differentiable():
    """granite's Switch aux term reaches the router's gradient: with the
    CE term's coefficient the same, a larger ``aux_coef`` changes it."""
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tb(_batches(tcfg.vocab_size, 1)[0])
    grads = []
    for coef in (0.0, 10.0):
        loss_fn = tts.make_loss_fn(model, tcfg, tts.TrainStepConfig(
            aux_coef=coef))
        router = params["blocks"][0]["moe"]["router"].requires_grad_()
        tot, _ = loss_fn(params, batch["inputs"], batch["labels"])
        grads.append(torch.autograd.grad(tot, router)[0])
        router.requires_grad_(False)
    assert not torch.allclose(grads[0], grads[1])


@pytest.mark.parametrize("policy", ["none", "minimal"])
def test_remat_policies_give_the_same_gradients(policy):
    """``full`` (recompute each super-block) against ``none`` and
    ``minimal`` (keep the matmul outputs): one step's loss and updated
    params agree to f32 rounding."""
    results = []
    for p in ("full", policy):
        _, tcfg = _cfgs("granite-moe-1b-a400m", remat_policy=p)
        model = build_model(tcfg, device="cpu")
        state = tts.init_state(model, OptimizerConfig(**OPT),
                               torch.Generator().manual_seed(0))
        step = tts.make_train_step(model, tcfg, OptimizerConfig(**OPT),
                                   tts.TrainStepConfig())
        state, m = step(state, _tb(_batches(tcfg.vocab_size, 1)[0]))
        results.append((state, m))
    (sa, ma), (sb, mb) = results
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)
    assert float(ma["grad_norm"]) == pytest.approx(float(mb["grad_norm"]),
                                                   rel=1e-5)
    for a, b in zip(adamw.leaves(sa["params"]), adamw.leaves(sb["params"])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_split_blocks_forward_equals_the_stacked_forward():
    _, tcfg = _cfgs("gemma2-27b")
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    inputs = _tb(_batches(tcfg.vocab_size, 1)[0])["inputs"]
    with torch.no_grad():
        a, _ = model.forward(params, inputs)
        b, _ = model.forward(model.split_blocks(params), inputs)
    assert torch.equal(a, b)


def test_train_state_crosses_to_numpy_and_back():
    jcfg, jstate, _, tstate, _ = _jax_and_port("granite-moe-1b-a400m", 1)
    back = train_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            jax.tree.map(np.asarray, jstate))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="train state"):
        train_state_from_numpy({"params": back["params"]}, "cpu")
