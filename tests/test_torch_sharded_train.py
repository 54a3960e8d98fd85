"""The port's sharded train step on 4 gloo ranks on the CPU, float32,
against the single-device step of the port and of the JAX package from the
same JAX-initialised params (bridged as numpy), as JAX's
``test_sharded_train_step_matches_single_device``: reduced yi-9b on a
(data 2, model 2) mesh ("heads" mode) and on (data 1, model 4) ("expand":
4 q heads over 4 ranks, the 2 kv heads replicated and expanded), reduced
granite-moe on (data 2, model 2) (the MoE expert-parallel); reduced
mamba2-370m and zamba2-1.2b on both meshes (``d_inner`` and the SSM heads
over ``model``, the SSD op's forward and backward on each rank's heads;
zamba2's shared block "heads" at (2, 2), "expand" at (1, 4)); two steps
of 2 microbatches against two single-device steps; and yi with 6 q heads
over 2 kv heads on (data 1, model 4), "expand" with the q heads padded to
8 (zero wq columns and wo rows, their gradients masked). One spawn of the
ranks for every run (``tests/torch_dist_ranks.py``)."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.optim.adamw import OptimizerConfig as JaxOpt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import train_state_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import OptimizerConfig  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

OPT = dict(warmup_steps=2, total_steps=10)
# 6 q heads over 2 kv heads: over 4 model ranks, padded to 8
PADDED = {"num_heads": 6, "num_kv_heads": 2}
# (arch, config overrides, mesh shape, the policy's mode and h_pad)
RUNS = [("yi-9b", {}, (2, 2), "heads", 4), ("yi-9b", {}, (1, 4), "expand", 4),
        ("yi-9b", PADDED, (1, 4), "expand", 8),
        ("granite-moe-1b-a400m", {}, (2, 2), "heads", 4),
        ("mamba2-370m", {}, (2, 2), "none", 0),
        ("mamba2-370m", {}, (1, 4), "none", 0),
        ("zamba2-1.2b", {}, (2, 2), "heads", 4),
        ("zamba2-1.2b", {}, (1, 4), "expand", 4)]
IDS = ["yi-heads-2x2", "yi-expand-1x4", "yi-padded-expand-1x4",
       "granite-heads-2x2", "mamba2-2x2", "mamba2-1x4", "zamba2-heads-2x2",
       "zamba2-expand-1x4"]


def _batches(vocab, n=2, b=8, s=32):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        toks = rng.integers(1, vocab, size=(b, s + 1)).astype(np.int32)
        out.append({"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _cfgs(arch, over):
    return (dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                                **over),
            dataclasses.replace(t_reduced(t_get_config(arch)),
                                dtype="float32", **over))


def _jax_state(arch, over):
    jstate, _ = jts.init_state(jax_build(_cfgs(arch, over)[0]),
                               JaxOpt(**OPT), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jstate)


def _reference(arch, over, state, batches):
    """JAX's single-device steps (one microbatch, as JAX's test) from the
    numpy train ``state``, and the port's."""
    jcfg, tcfg = _cfgs(arch, over)
    jstate = jax.tree.map(jnp.asarray, state)
    jstep = jax.jit(jts.make_train_step(jax_build(jcfg), jcfg, JaxOpt(**OPT),
                                        jts.TrainStepConfig()))
    tstate = train_state_from_numpy(state, "cpu")
    tstep = tts.make_train_step(build_model(tcfg, device="cpu"), tcfg,
                                OptimizerConfig(**OPT), tts.TrainStepConfig())
    jloss, tloss, norms = [], [], []
    for batch in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        jloss.append(float(jm["loss"]))
        tloss.append(float(tm["loss"]))
        norms.append(float(tm["grad_norm"]))
    return {
        "jax": (jloss, [np.asarray(x) for x in
                        jax.tree.leaves(jstate["params"])]),
        "port": (tloss, [x.numpy() for x in adamw.leaves(tstate["params"])],
                 [x.numpy() for x in adamw.leaves(tstate["opt"]["m"])]),
        "grad_norms": norms}


def _unpad(leaves_, like, h_pad):
    """The sharded run's leaves cut to the unpadded shapes of ``like``,
    asserting the padded q-head slices (wq's columns, wo's rows) zero."""
    out = []
    for x, want in zip(leaves_, like):
        if x.shape != want.shape:
            axis = [i for i, (a, b) in enumerate(zip(x.shape, want.shape))
                    if a != b]
            assert len(axis) == 1 and x.shape[axis[0]] == h_pad
            pad = np.take(x, range(want.shape[axis[0]], h_pad), axis[0])
            assert not pad.any()
            x = np.take(x, range(want.shape[axis[0]]), axis[0])
        out.append(x)
    return out


@pytest.fixture(scope="module")
def runs():
    """The sharded steps on the ranks while this process takes the
    single-device steps."""
    batches = _batches(reduced(get_config("yi-9b")).vocab_size)
    keys = {(arch, tuple(sorted(over.items()))) for arch, over, *_ in RUNS}
    states = {k: _jax_state(k[0], dict(k[1])) for k in keys}
    args = [(arch, over, shape, 2, states[arch, tuple(sorted(over.items()))])
            for arch, over, shape, _, _ in RUNS]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        sharded = pool.submit(run_ranks, ranks.sharded_steps, 4,
                              args=(args, batches), timeout=600)
        refs = {k: _reference(k[0], dict(k[1]), state, batches)
                for k, state in states.items()}
        sharded = sharded.result()[0]
    return {name: (refs[run[0], tuple(sorted(run[1].items()))], res)
            for name, run, res in zip(IDS, RUNS, sharded)}


@pytest.mark.parametrize("name,run", zip(IDS, RUNS), ids=IDS)
def test_sharded_step_matches_single_device(runs, name, run):
    """Losses to rtol 1e-4 and params to atol 1e-4, rtol 1e-3 (JAX's test's
    tolerances), against the port's single-device step and JAX's; the
    first moments (the gradients' running mean) to 1e-3 of each leaf's
    largest. A param past the tolerance passes only where its first moment
    is below 1e-3 of its leaf's largest, and at most 1e-4 of the params:
    Adam's normalised step m / sqrt(v) turns the last bits of a near-zero
    gradient, summed in another order, into up to 2 lr (one weight of
    granite's experts moves 2.1e-4, its moment 4.8e-7 of a leaf's 1.9e-3)."""
    _, over, _, mode, h_pad = run
    ref, got = runs[name]
    assert (got["mode"], got["h_pad"]) == (mode, h_pad)
    if h_pad > over.get("num_heads", h_pad):
        # the padded q heads stay zero (their gradients masked); the rest
        # is held to the unpadded single-device params below
        got = dict(got, params=_unpad(got["params"], ref["port"][1], h_pad),
                   m=_unpad(got["m"], ref["port"][2], h_pad))
    losses = [m["loss"] for m in got["metrics"]]
    for side in ("port", "jax"):
        np.testing.assert_allclose(losses, ref[side][0], rtol=1e-4,
                                   err_msg=side)
    # the global norm: each rank's shards, one all-reduce
    np.testing.assert_allclose([m["grad_norm"] for m in got["metrics"]],
                               ref["grad_norms"], rtol=1e-4)
    assert len(got["params"]) == len(ref["port"][1])
    near_zero = {"port": 0, "jax": 0}
    for i, (p, m) in enumerate(zip(got["params"], got["m"])):
        m1 = ref["port"][2][i]
        top = np.abs(m1).max()
        np.testing.assert_allclose(m, m1, atol=1e-3 * top, rtol=0)
        for side in ("port", "jax"):
            want = ref[side][1][i]
            off = np.abs(p - want) > 1e-4 + 1e-3 * np.abs(want)
            assert (np.abs(m1[off]) < 1e-3 * top).all(), (side, i)
            near_zero[side] += int(off.sum())
    total = sum(p.size for p in got["params"])
    assert max(near_zero.values()) <= 1e-4 * total, (near_zero, total)
