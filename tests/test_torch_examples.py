"""The port's examples (``examples/torch_*.py``) on the CPU, each at its JAX
example's sizes (``--device cpu``): the paper's pipeline through a
straggler and a dead worker, the quickstart session, batched serving held
to the greedy oracle and to JAX's router, the training example in both of
its modes (and the reason the JAX ``--full`` mode cannot run), and the
crash-restart flow. Without a card and without ``--device cpu`` each
raises."""
import dataclasses
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import greedy_generate  # noqa: E402

import torch_elastic_restart  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_batched  # noqa: E402
import torch_train_e2e  # noqa: E402
import torch_workflow_pipeline  # noqa: E402

FULL_PARAMS = 137_841_408


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The examples' many small ops on one thread: under the suite's
    parallel workers, torch's pool of a thread a core oversubscribes the
    host many times over (two of these tests, 4 s alone, took 179 s beside
    five CPU-bound processes, and 31 s there on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_workflow_pipeline_is_exact_through_a_straggler_and_a_dead_worker():
    out = torch_workflow_pipeline.main(["--device", "cpu"])
    assert out["provider"] == "cpu"
    assert abs(out["rms"] - out["expected"]) < 1e-9
    assert out["stats"]["executed"] >= 14


def test_quickstart_session_on_the_host():
    out = torch_quickstart.main(["--device", "cpu"])
    assert (out["provider"], out["arch"]) == ("cpu", "yi-9b")
    assert out["endpoints"] == ["volumes", "data", "lm-trainer", "workflows",
                                "dashboard"]
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    # the sum of squares of 0..9999 that JAX's example computes
    assert out["sumsq"] == 333283335000.0
    assert "lm-trainer/step" in out["dashboard_counters"]
    # no service of either package is built through the image cache,
    # so the warm re-apply counts the JAX example's 0 hits
    assert out["image_cache_hits"] == 0


def test_quickstart_arch_chooses_the_trainers_model():
    out = torch_quickstart.main(["--device", "cpu", "--arch", "mamba2-370m"])
    assert (out["provider"], out["arch"]) == ("cpu", "mamba2-370m")
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    assert out["sumsq"] == 333283335000.0


def test_serve_batched_outputs_equal_the_greedy_oracle():
    out = torch_serve_batched.main(["--device", "cpu"])
    assert (out["arch"], out["max_seq"], out["rolling"]) == (
        "gemma2-27b-reduced", 96, True)
    assert out["tokens"] == 80 and out["oracle_equal_tokens"] == 8
    assert sum(m["completed"] for m in out["metrics"].values()) == 10
    cfg = reduced(get_config("gemma2-27b"))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch_serve_batched.make_prompts(cfg.vocab_size)
    for prompt, got in zip(prompts, out["outputs"], strict=True):
        np.testing.assert_array_equal(
            got, greedy_generate(model, params, prompt, 8, 96))


def test_serve_batched_tokens_equal_jax_routers():
    """Reduced widths in float32, the params of JAX's ``model.init`` bridged:
    the port's router gives JAX's router's tokens for the example's
    prompts."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced as jax_reduced
    from repro.models.model import build_model as jax_build_model
    from repro.serving.engine import EdgeRouter, ServingEngine
    from repro_torch.models.params import params_from_numpy

    jcfg = dataclasses.replace(jax_reduced(jax_get_config("gemma2-27b")),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    prompts = torch_serve_batched.make_prompts(jcfg.vocab_size)
    router = EdgeRouter([ServingEngine(jmodel, jparams, slots=3, max_seq=96,
                                       name=f"r{i}") for i in range(2)])
    futs = [router.submit(p, max_new_tokens=8) for p in prompts]
    router.drain()
    want = [np.asarray(f.result()) for f in futs]

    tcfg = dataclasses.replace(reduced(get_config("gemma2-27b")),
                               dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    got, _, metrics = torch_serve_batched.serve(tmodel, tparams, prompts, 96,
                                                "cpu")
    assert sum(m["completed"] for m in metrics.values()) == 10
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


def test_train_e2e_full_config_is_jax_examples():
    from repro.configs import get_config as jax_get_config
    cfg = torch_train_e2e.full_config()
    jcfg = dataclasses.replace(
        jax_get_config("yi-9b"), num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=32000,
        skip_shapes=())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count() == FULL_PARAMS


def test_train_e2e_full_reaches_launch_train_with_its_config(tmp_path):
    ckpt = tmp_path / "ckpt"
    try:
        out = torch_train_e2e.main([
            "--full", "--device", "cpu", "--steps", "1", "--global-batch",
            "2", "--seq-len", "32", "--microbatches", "1", "--ckpt-dir",
            str(ckpt)])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)     # a 1.4 GB train state
    assert (out["mode"], out["arch"], out["device"]) == (
        "full", torch_train_e2e.FULL_ARCH, "cpu")
    assert out["params"] == FULL_PARAMS
    assert (out["steps"], out["global_batch"], out["seq_len"],
            out["microbatches"]) == (1, 2, 32, 1)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])


def test_train_e2e_cpu_demo_trains_the_reduced_model(tmp_path):
    out = torch_train_e2e.main(["--device", "cpu", "--ckpt-dir",
                                str(tmp_path / "ckpt")])
    assert (out["mode"], out["arch"], out["device"]) == ("cpu demo", "yi-9b",
                                                         "cpu")
    assert out["params"] == reduced(get_config("yi-9b")).param_count()
    losses = out["losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert len(out["step_s"]) == 30


def test_jax_train_e2e_full_cannot_find_its_config():
    """The reason the port's ``--full`` hands its config to
    ``launch.train.run`` itself: JAX's example patches
    ``repro.configs.base``, which its ``launch.train`` does not read, and
    its lookup imports ``repro.configs.None``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "examples" /
                                            "train_e2e.py"), "--full"],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode != 0
    assert "ModuleNotFoundError: No module named 'repro.configs.None'" \
        in r.stderr
    assert "full config: 138M params" in r.stdout


def test_elastic_restart_continues_the_run():
    out = torch_elastic_restart.main(["--device", "cpu"])
    assert (out["provider"], out["arch"]) == ("cpu", "mamba2-370m")
    assert len(out["losses1"]) == len(out["losses2"]) == 6
    assert np.isfinite(out["losses1"] + out["losses2"]).all()
    assert out["losses2"][0] < out["losses1"][0] + 1.0


@pytest.mark.parametrize("module,argv", [
    ("torch_workflow_pipeline", []), ("torch_quickstart", []),
    ("torch_elastic_restart", []), ("torch_serve_batched", []),
    ("torch_train_e2e", ["--full"]), ("torch_train_e2e", [])])
def test_example_raises_without_a_card(module, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the example would run on it")
    with pytest.raises(RuntimeError, match="CUDA|devices"):
        importlib.import_module(module).main(argv)


def test_serve_batched_layers_cut_only_the_cards_model():
    with pytest.raises(ValueError, match="--layers"):
        torch_serve_batched.main(["--device", "cpu", "--layers", "4"])
