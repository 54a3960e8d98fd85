"""The port's Mamba2 and hybrid training path against the JAX package's,
float32 on the CPU, reduced mamba2-370m (2 layers) and zamba2-1.2b (14
layers: two segments of 6, each followed by the shared block, and 2
trailing): ``forward``'s logits and the loss gradients of every param,
five train steps from bridged params (losses, grad norms, lr, params),
per-layer gradients from ``split_blocks``, the remat policies, and
``launch/train.py`` saving and resuming."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.optim.adamw import OptimizerConfig as JaxOpt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import (params_from_numpy,  # noqa: E402
                                       train_state_from_numpy,
                                       train_state_to_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import OptimizerConfig  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
OPT = dict(warmup_steps=2, total_steps=10)


def _cfgs(arch, **over):
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               **over)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)),
                               dtype="float32", **over)
    return jcfg, tcfg


def _batches(vocab, n, b=4, s=64, seed=0):
    """Batches of 64 tokens: two chunks of the reduced chunk 32, so the
    inter-chunk recurrence is in every gradient."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(1, vocab, size=(b, s + 1)).astype(np.int32)
        out.append({"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _perturbed(params, seed=1):
    """JAX params with the zero-initialised norms and biases (and the
    constant A_log, D) moved off their initial values, so their gradients
    are checked where they are not special."""
    rng = np.random.default_rng(seed)
    special = {"ln", "norm", "final_norm", "dt_bias", "D", "ln1", "ln2"}

    def move(path, x):
        key = getattr(path[-1], "key", None)
        if key in special:
            return x + jnp.asarray(rng.standard_normal(x.shape) * 0.1,
                                   x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(move, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_loss_gradients_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    jparams = _perturbed(jparams)
    batch = _batches(jcfg.vocab_size, 1, b=2)[0]

    def jloss(p):
        logits, aux = jmodel.forward(p, jnp.asarray(batch["inputs"]))
        return jts.cross_entropy(logits, jnp.asarray(batch["labels"]),
                                 jcfg.vocab_size), (logits, aux)
    (jl, (jlogits, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams)
    model = build_model(tcfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = adamw.leaves(params)
    for t in leaves:
        t.requires_grad_()
    tb = _tb(batch)
    logits, aux = model.forward(params, tb["inputs"])
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert logits.shape == jlogits.shape
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    loss = tts.cross_entropy(logits, tb["labels"], tcfg.vocab_size)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree.leaves(jg)
    assert len(grads) == len(want)
    # f32: the loss over 128 tokens, every layer's summation orders; each
    # gradient within 1e-4 of its largest magnitude
    for i, (g, w) in enumerate(zip(grads, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")


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


@pytest.mark.parametrize("arch,mb", [("mamba2-370m", 1), ("mamba2-370m", 2),
                                     ("zamba2-1.2b", 1)])
def test_train_step_matches_jax_over_five_steps(arch, mb):
    """tests/test_torch_training.py's transformer parity for the SSM and
    the hybrid: losses, grad norms and lr each step, params after five."""
    jcfg, jstate, jstep, tstate, tstep = _jax_and_port(arch, mb)
    for batch in _batches(jcfg.vocab_size, 5):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, _tb(batch))
        for key, rtol in (("loss", 1e-5), ("aux_loss", 1e-5),
                          ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rtol, atol=1e-6, err_msg=key)
    want = jax.tree.leaves(jstate["params"])
    got = adamw.leaves(tstate["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-4)
    assert int(tstate["opt"]["count"]) == 5
    # the state crosses back leaf for leaf (the f32 A_log, D and dt_bias
    # with their moments)
    back = train_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax.tree.map(np.asarray, jstate))):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_split_blocks_gives_each_layer_its_own_gradient(arch):
    """``split_blocks`` views each Mamba2 layer of the stacked params (no
    copy); the forward gives the stacked form's logits, and each layer's
    gradient is a tensor of that layer's shape, not a scatter into the
    stack."""
    _, tcfg = _cfgs(arch)
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    split = model.split_blocks(params)
    n = tcfg.num_layers
    assert len(split["mamba"]) == n
    w_x = params["mamba"]["mamba"]["w_x"]
    assert split["mamba"][1]["mamba"]["w_x"].data_ptr() == \
        w_x[1].data_ptr()
    inputs = _tb(_batches(tcfg.vocab_size, 1, b=2)[0])["inputs"]
    with torch.no_grad():
        a, _ = model.forward(params, inputs)
        b, _ = model.forward(split, inputs)
    assert torch.equal(a, b)
    leaves = tts._grad_leaves(model, params)
    per_layer = [leaves["mamba"][i]["mamba"]["w_x"] for i in range(n)]
    logits, _ = model.forward(leaves, inputs)
    grads = torch.autograd.grad(logits.sum(), per_layer)
    assert all(g.shape == w_x.shape[1:] for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("policy", ["full", "minimal"])
def test_remat_policies_give_the_same_gradients(policy):
    """Each Mamba2 layer under ``full`` (recomputed in the backward) or
    ``minimal`` (matmul outputs kept) against ``none``: one zamba2 step's
    loss and updated params agree to f32 rounding."""
    results = []
    for p in ("none", policy):
        _, tcfg = _cfgs("zamba2-1.2b", remat_policy=p)
        model = build_model(tcfg, device="cpu")
        state = tts.init_state(model, OptimizerConfig(**OPT),
                               torch.Generator().manual_seed(0))
        step = tts.make_train_step(model, tcfg, OptimizerConfig(**OPT),
                                   tts.TrainStepConfig())
        state, m = step(state, _tb(_batches(tcfg.vocab_size, 1, b=2)[0]))
        results.append((state, m))
    (sa, ma), (sb, mb) = results
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)
    assert float(ma["grad_norm"]) == pytest.approx(float(mb["grad_norm"]),
                                                   rel=1e-5)
    for a, b in zip(adamw.leaves(sa["params"]), adamw.leaves(sb["params"])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_embeddings_input_mode_still_raises_naming_a7c():
    cfg = t_reduced(t_get_config("musicgen-medium"))
    with pytest.raises(NotImplementedError, match=r"A\.7c"):
        build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=r"A\.7c"):
        tts.make_train_step(None, cfg, OptimizerConfig(),
                            tts.TrainStepConfig())


def test_launch_train_mamba2_saves_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu --arch
    mamba2-370m``: 6 steps saved at 3 and 6, then a resume of 3 from step
    6 gives the losses of an uninterrupted 9-step run's last 3."""
    base = ["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
            "--global-batch", "4", "--seq-len", "64", "--ckpt-every", "3"]
    full = train_driver.main(base + ["--steps", "9", "--ckpt-dir",
                                     str(tmp_path / "full")])
    first = train_driver.main(base + ["--steps", "6", "--ckpt-dir",
                                      str(tmp_path / "cut")])
    capsys.readouterr()
    resumed = train_driver.main(base + ["--steps", "3", "--resume",
                                        "--ckpt-dir", str(tmp_path / "cut")])
    assert "[resume] restored step 6" in capsys.readouterr().out
    np.testing.assert_allclose(first, full[:6], rtol=1e-6)
    np.testing.assert_allclose(resumed, full[6:], rtol=1e-6)
    assert all(np.isfinite(full)) and full[-1] < full[0]
