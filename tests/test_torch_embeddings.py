"""The ``embeddings`` input mode (``musicgen-medium``, ``internvl2-26b``: a
stub front end's (B, S, d) float embeddings take the place of token ids)
of the port against the JAX package on the CPU, reduced, float32, from
JAX-initialised params carried across (``repro_torch.models.params``), the
zero-initialised norms drawn at random on both sides: forward logits;
prefill, its caches and decode steps, and prefill(S-1) + decode(1) against
forward(S); ``prefill_chunk`` and ``decode_verify``; the SSM and hybrid
builders switched to the embeddings mode; the gradients of a train step
under remat (every leaf, the first block's among them; none for the
inputs; the tied table's through the unembedding alone, its pad rows
zero); ``launch.train --arch musicgen-medium`` saving and resuming, with
the JAX driver's printed lines; a VRE's ``data`` and ``lm-trainer``
beside JAX's; and the serving engine's refusal."""
import dataclasses
import functools
import re
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core.services  # noqa: E402,F401
import repro_torch.core.services  # noqa: E402,F401
from repro.configs import get_config, reduced  # noqa: E402
from repro.core.vre import VREConfig as JaxVREConfig  # noqa: E402
from repro.core.vre import \
    VirtualResearchEnvironment as JaxVRE  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.vre import (VirtualResearchEnvironment,  # noqa: E402
                                  VREConfig)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.models.params import train_state_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

ARCHS = ["musicgen-medium", "internvl2-26b"]
# f32 on both sides: summation orders over two 64-wide layers and a
# 503-way unembedding (logits of O(10)); the SSM also a chunked against a
# sequential scan (tests/test_torch_hybrid.py's tolerance). The reduced
# hybrid's 14 layers on unit-scale embeddings (8 times smaller than its
# scaled token embeddings) amplify rounding: a relative change of 1e-7 in
# its inputs moves either package's own logits (of O(30)) by 2e-4 to 3e-4,
# as far as the two packages lie apart
TOL = 5e-5
SSM_TOL = {"mamba2-370m": 1e-4, "zamba2-1.2b": 1e-3}
MAX_SEQ = 48


def _perturb(tree, seed=0):
    """Every all-zero leaf (the norm weights) drawn from N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size and not x.any():
            return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def _cfgs(arch, **over):
    over = {"dtype": "float32", **over}
    return (dataclasses.replace(reduced(get_config(arch)), **over),
            dataclasses.replace(t_reduced(t_get_config(arch)), **over))


@functools.lru_cache(maxsize=None)
def _pair(arch, input_mode="embeddings"):
    """(JAX model with jitted calls, JAX params, port model, port params)
    for the reduced ``arch`` in ``input_mode``."""
    jcfg, tcfg = _cfgs(arch, input_mode=input_mode)
    eager = JM.build_model(jcfg)
    jp, _ = eager.init(jax.random.PRNGKey(0))
    jp = jax.tree.map(jnp.asarray, _perturb(jp))
    jm = SimpleNamespace(cfg=jcfg, eager=eager,
                         forward=jax.jit(eager.forward),
                         prefill=jax.jit(eager.prefill, static_argnums=2),
                         decode=jax.jit(eager.decode))
    if hasattr(eager, "prefill_chunk"):
        jm.prefill_chunk = jax.jit(eager.prefill_chunk)
        jm.decode_verify = jax.jit(eager.decode_verify)
    tm = TM.build_model(tcfg, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _emb(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _same_caches(tc, jc, tol):
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(bridge.caches_to_numpy(tc)),
            jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                             jc))):
        assert a.shape == b.shape, path
        _close(a, b, tol, str(path))


def _check_stack(arch, tol, steps):
    """Forward logits; prefill (caches too) and ``steps`` decode steps of
    fresh embeddings; then prefill(S-1) + decode(1) against forward(S) in
    the port, at JAX's bound (tests/test_decode_consistency.py)."""
    jm, jp, tm, tp = _pair(arch)
    d, s = tm.cfg.d_model, 23
    x = _emb((2, s, d), 1)
    with torch.inference_mode():
        full, _ = tm.forward(tp, torch.from_numpy(x))
        _close(full, jm.forward(jp, jnp.asarray(x))[0], tol, "forward")
        jl, jc = jm.prefill(jp, jnp.asarray(x), MAX_SEQ)
        tl, tc = tm.prefill(tp, torch.from_numpy(x), MAX_SEQ)
        _close(tl, jl, tol, "prefill")
        _same_caches(tc, jc, tol)
        pos = np.full((2,), s, np.int32)
        for i in range(steps):
            xi = _emb((2, 1, d), 10 + i)
            jl, jc = jm.decode(jp, jc, jnp.asarray(xi), jnp.asarray(pos))
            tl, tc = tm.decode(tp, tc, torch.from_numpy(xi),
                               torch.from_numpy(pos.astype(np.int64)))
            _close(tl, jl, tol, f"decode step {i}")
            pos = pos + 1
        _same_caches(tc, jc, tol)
        _, tc = tm.prefill(tp, torch.from_numpy(x[:, :-1]), MAX_SEQ)
        last, _ = tm.decode(tp, tc, torch.from_numpy(x[:, -1:]),
                            torch.full((2,), s - 1))
    ref = full[:, -1]
    rel = float((last[:, 0] - ref).abs().max() / ref.abs().max())
    assert rel < 2e-2, rel
    return tm


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    tm = _check_stack(arch, TOL, steps=8)
    assert tm.kernel_ops == (flash_ops,)
    # no sqrt(d) scale: the embeddings enter the stack as they are
    x = torch.from_numpy(_emb((1, 3, tm.cfg.d_model), 2))
    assert torch.equal(TM._embed_inputs(tm.cfg, _pair(arch)[3]["embed"], x),
                       x)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_and_decode_verify_match_jax(arch):
    """Two chunks of 8 then a verify of 4 (B, C, d) inputs against the
    same calls in JAX, each from zeroed caches; the chunks' logits are the
    forward's at their positions."""
    jm, jp, tm, tp = _pair(arch)
    d = tm.cfg.d_model
    x = _emb((2, 20, d), 3)
    jc = jm.eager.init_cache(2, MAX_SEQ)[0]
    tc = tm.init_cache(2, MAX_SEQ)
    with torch.inference_mode():
        full, _ = tm.forward(tp, torch.from_numpy(x))
        for lo, hi, name in ((0, 8, "prefill_chunk"), (8, 16,
                                                       "prefill_chunk"),
                             (16, 20, "decode_verify")):
            pos = np.full((2,), lo, np.int32)
            jl, jc = getattr(jm, name)(jp, jc, jnp.asarray(x[:, lo:hi]),
                                       jnp.asarray(pos))
            tl, tc = getattr(tm, name)(tp, tc, torch.from_numpy(
                x[:, lo:hi]), torch.from_numpy(pos.astype(np.int64)))
            _close(tl, jl, TOL, f"{name} at {lo}")
            _close(tl, full[:, lo:hi], TOL, f"{name} at {lo} vs forward")
        _same_caches(tc, jc, TOL)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_and_hybrid_builders_take_embeddings(arch):
    """``dataclasses.replace(reduced(cfg), input_mode="embeddings")`` in
    both packages: the SSM stack and the hybrid's segments take (B, S, d)
    inputs as the transformer does."""
    _check_stack(arch, SSM_TOL[arch], steps=4)


def _embedding_batches(cfg, n, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return [{"inputs": rng.standard_normal((b, s, cfg.d_model)).astype(
                np.float32),
             "labels": rng.integers(1, cfg.vocab_size, size=(b, s)).astype(
                 np.int32)} for _ in range(n)]


@pytest.mark.parametrize("policy", ["full", "minimal"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_reach_every_leaf_under_remat(arch, policy):
    """A train step's loss gradient in the embeddings mode, each block
    remat'd: every leaf gets a non-zero gradient, the first block's too
    (the checkpoint is non-reentrant, so a block whose input needs no
    gradient still passes its params theirs); the inputs get none; the
    table gets its gradient through the unembedding alone (JAX's), so its
    pad rows, masked out of the loss, get exactly zero."""
    jcfg, tcfg = _cfgs(arch, remat_policy=policy)
    jp, _ = JM.build_model(jcfg).init(jax.random.PRNGKey(0))
    batch = _embedding_batches(tcfg, 1)[0]
    model = TM.build_model(tcfg, device="cpu")
    # the train step's leaves: per-block views, each requiring grad
    params = tts._grad_leaves(model, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))
    leaves = jax.tree.leaves(params)
    inputs = torch.from_numpy(batch["inputs"])
    loss_fn = tts.make_loss_fn(model, tcfg, tts.TrainStepConfig())
    tot, _ = loss_fn(params, inputs, torch.from_numpy(batch["labels"]))
    grads = dict(zip(map(id, leaves), torch.autograd.grad(tot, leaves)))
    assert not inputs.requires_grad and inputs.grad is None
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        assert float(grads[id(leaf)].abs().max()) > 0, path
    first = params["blocks"][0][0]["attn"]["wq"]
    assert float(grads[id(first)].abs().max()) > 0
    tok = grads[id(params["embed"]["tok"])]
    assert tok.shape[0] > tcfg.vocab_size
    assert not tok[tcfg.vocab_size:].any()

    def jloss(p):
        logits, _ = JM.build_model(jcfg).forward(p, jnp.asarray(
            batch["inputs"]))
        from repro.training.train_step import cross_entropy
        return cross_entropy(logits, jnp.asarray(batch["labels"]),
                             jcfg.vocab_size)
    want = jax.grad(jloss)(jp)["embed"]["tok"]
    _close(tok, want, 2e-5, "the table's gradient")


def test_launch_train_musicgen_saves_resumes_and_prints_jax_lines(
        tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch musicgen-medium
    --reduced --device cpu``: 6 steps saved at 3 and 6, then a resume of
    3 from step 6 gives an uninterrupted 9-step run's losses; the printed
    lines are the JAX driver's with the numbers left out (the inits
    differ: torch.Generator is not jax.random)."""
    base = ["--arch", "musicgen-medium", "--reduced", "--global-batch", "4",
            "--seq-len", "32", "--ckpt-every", "3"]
    port = base + ["--device", "cpu"]
    full = train_driver.main(port + ["--steps", "9", "--ckpt-dir",
                                     str(tmp_path / "full")])
    printed = capsys.readouterr().out
    first = train_driver.main(port + ["--steps", "6", "--ckpt-dir",
                                      str(tmp_path / "cut")])
    capsys.readouterr()
    resumed = train_driver.main(port + ["--steps", "3", "--resume",
                                        "--ckpt-dir", str(tmp_path / "cut")])
    assert "[resume] restored step 6" in capsys.readouterr().out
    assert first + resumed == full        # the same ops on the same CPU
    # finite; on noise inputs at this size the loss does not fall within
    # nine steps, in JAX's driver either
    assert all(np.isfinite(full))
    jax_train.main(base + ["--steps", "9", "--ckpt-dir",
                           str(tmp_path / "jax")])
    jax_printed = capsys.readouterr().out

    def shape(text):
        return [re.sub(r"-?[\d.,]+(e[-+]\d+)?", "#", ln)
                for ln in text.splitlines()]
    assert shape(printed) == shape(jax_printed)
    assert printed.splitlines()[-1].startswith("done: 9 steps,")


def test_vre_data_and_lm_trainer_train_musicgen_as_jax(tmp_path):
    """A VRE's ``data`` service yields the JAX service's (B, S, d)
    embedding batches, and its ``lm-trainer``, started from the JAX
    trainer's state, gives JAX's five losses (provider cpu: reduced
    widths in bf16, tests/test_torch_trainer_service.py's tolerance)."""
    kw = dict(name="t", mesh_shape=(1, 1), arch="musicgen-medium",
              services=["volumes", "data", "lm-trainer"], provider="cpu",
              extra={"global_batch": 4, "seq_len": 32})
    jv = JaxVRE(JaxVREConfig(workdir=str(tmp_path / "jax"), **kw))
    tv = VirtualResearchEnvironment(VREConfig(workdir=str(tmp_path / "port"),
                                              **kw))
    jv.instantiate()
    tv.instantiate()
    try:
        jb, tb = (next(iter(v.service("data"))) for v in (jv, tv))
        assert tb["inputs"].shape == (4, 32, 64)
        assert tb["inputs"].dtype == np.float32
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))
        jt, tt = jv.service("lm-trainer"), tv.service("lm-trainer")
        tt.state = train_state_from_numpy(jax.tree.map(np.asarray, jt.state),
                                          "cpu")
        want = jt.train_steps(jv.service("data"), 5)
        got = tt.train_steps(tv.service("data"), 5)
        np.testing.assert_allclose(got, want, rtol=2e-3)
        assert tt.health() and tt.metrics() == {"step": 5, "loss": got[-1]}
    finally:
        jv.destroy()
        tv.destroy()


def test_engine_refuses_an_embeddings_model():
    """The engine takes token prompts only, as JAX's: an embeddings model's
    engine, and a pool of them, refuse a request naming the input mode
    before it is queued."""
    _, _, tm, tp = _pair("musicgen-medium")
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="input_mode 'embeddings'"):
        eng.submit(np.arange(1, 6))
    assert eng.queue.empty() and eng.metrics["requests"] == 0
    rs = serve.build_replicaset(tm.cfg, replicas=1, slots=2, max_seq=MAX_SEQ,
                                device="cpu", params=tp)
    try:
        with pytest.raises(ValueError, match="input_mode 'embeddings'"):
            rs.submit(np.arange(1, 6))
    finally:
        rs.stop()
    # a token model of the same widths is served
    _, _, tok_model, tok_params = _pair("musicgen-medium", "tokens")
    ok = ServingEngine(tok_model, tok_params, slots=2, max_seq=MAX_SEQ,
                       device="cpu")
    fut = ok.submit(np.arange(1, 6), max_new_tokens=2)
    ok.run_until_idle()
    assert len(fut.result()) == 2
