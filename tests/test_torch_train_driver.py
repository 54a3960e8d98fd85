"""``python -m repro_torch.launch.train`` on the CPU, and train states
crossing between the packages' checkpoint stores: a run cut at step 6 and
resumed gives the losses of an uninterrupted run; a state JAX saved
continues in the port with JAX's next losses, and the reverse."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JaxStore  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.optim.adamw import OptimizerConfig as JaxOpt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import (train_state_from_numpy,  # noqa: E402
                                       train_state_to_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import OptimizerConfig  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

ARGS = ["--reduced", "--device", "cpu", "--global-batch", "4",
        "--seq-len", "32"]
OPT = dict(warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-1b-a400m"])
def test_resumed_run_gives_the_uninterrupted_losses(arch, tmp_path, capsys):
    whole = train.main(ARGS + ["--arch", arch, "--steps", "10",
                               "--ckpt-every", "5",
                               "--ckpt-dir", str(tmp_path / "whole")])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done: 10 steps" in out
    cut = str(tmp_path / "cut")
    first = train.main(ARGS + ["--arch", arch, "--steps", "6",
                               "--ckpt-every", "3", "--ckpt-dir", cut])
    rest = train.main(ARGS + ["--arch", arch, "--steps", "4", "--resume",
                              "--ckpt-every", "3", "--ckpt-dir", cut])
    assert "[resume] restored step 6" in capsys.readouterr().out
    # the same ops on the same CPU: equal, not close
    assert first + rest == whole
    assert CheckpointStore(cut).latest_step() == 10
    assert all(np.isfinite(whole))


def test_default_ckpt_dir_lies_under_the_temp_dir(tmp_path, monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert train.parse_args([]).ckpt_dir == str(tmp_path / "repro_ckpt")
    assert train.parse_args(["--ckpt-dir", "d"]).ckpt_dir == "d"


def test_resume_without_a_checkpoint_starts_at_step_0(tmp_path, capsys):
    losses = train.main(ARGS + ["--steps", "2", "--resume",
                                "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and "[resume]" not in capsys.readouterr().out
    assert CheckpointStore(str(tmp_path)).latest_step() == 2


def _setup(arch="granite-moe-1b-a400m", dtype="float32"):
    jcfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), dtype=dtype)
    jmodel = jax_build(jcfg)
    jstate, _ = jts.init_state(jmodel, JaxOpt(**OPT), jax.random.PRNGKey(0))
    jstep = jax.jit(jts.make_train_step(jmodel, jcfg, JaxOpt(**OPT),
                                        jts.TrainStepConfig()))
    tmodel = build_model(tcfg, device="cpu")
    tstep = tts.make_train_step(tmodel, tcfg, OptimizerConfig(**OPT),
                                tts.TrainStepConfig())
    like = tts.init_state(tmodel, OptimizerConfig(**OPT),
                          torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, size=(4, 4, 33)).astype(np.int32)
    batches = [{"inputs": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    return jstate, jstep, tstep, like, batches


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return jax.tree.map(jnp.asarray, batch)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """JAX trains 2 steps and saves; the port restores that step into its
    own (differently initialised) state and its next 2 losses are JAX's."""
    jstate, jstep, tstep, like, batches = _setup()
    for b in batches[:2]:
        jstate, _ = jstep(jstate, _jb(b))
    JaxStore(str(tmp_path)).save(jstate, 2, blocking=True)
    tstate = CheckpointStore(str(tmp_path)).restore(like)
    for a, b in zip(adamw.leaves(tstate), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for b in batches[2:]:
        jstate, jm = jstep(jstate, _jb(b))
        tstate, tm = tstep(tstate, _tb(b))
        # f32: tests/test_torch_training.py's loss tolerance
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert int(tstate["opt"]["count"]) == 4


def test_port_checkpoint_continues_in_jax(tmp_path):
    """The reverse: the port trains 2 steps from JAX's params and saves;
    JAX restores and its next 2 losses are the port's."""
    jstate, jstep, tstep, _, batches = _setup()
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for b in batches[:2]:
        tstate, _ = tstep(tstate, _tb(b))
    CheckpointStore(str(tmp_path)).save(tstate, 2, blocking=True)
    jstate = JaxStore(str(tmp_path)).restore(jstate)
    for b in batches[2:]:
        jstate, jm = jstep(jstate, _jb(b))
        tstate, tm = tstep(tstate, _tb(b))
        np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]),
                                   rtol=1e-5)


def test_bf16_train_state_crosses_bit_for_bit(tmp_path):
    """A bf16 model's state (bf16 params, f32 moments and router) through
    both stores, each way, with no leaf changed."""
    jstate, jstep, tstep, like, batches = _setup(dtype="bfloat16")
    jstate, _ = jstep(jstate, _jb(batches[0]))
    JaxStore(str(tmp_path / "j")).save(jstate, 1, blocking=True)
    tstate = CheckpointStore(str(tmp_path / "j")).restore(like)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate))
    got = jax.tree.leaves(train_state_to_numpy(tstate))
    assert [a.dtype for a in got] == [b.dtype for b in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    CheckpointStore(str(tmp_path / "t")).save(tstate, 1, blocking=True)
    back = JaxStore(str(tmp_path / "t")).restore(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
