"""The port stands alone: importing any of ``repro_torch`` loads neither JAX
nor any module of the JAX package, and no source of the port (or
``chip_smoke.py``, or an example of the port, ``examples/torch_*.py``)
imports them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.launch.serve" in mods
    assert {"repro_torch.core.elastic", "repro_torch.fleet.arbiter",
            "repro_torch.fleet.driver", "repro_torch.serving.autoscaler",
            "repro_torch.observability.metrics",
            "repro_torch.observability.slo",
            "repro_torch.observability.telemetry",
            "repro_torch.optim.adamw", "repro_torch.training.train_step",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.distributed.sharding",
            "repro_torch.distributed.comm",
            "repro_torch.distributed.collectives",
            "repro_torch.distributed.pipeline",
            "repro_torch.distributed.spawn"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_port_sources_do_not_import_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                     r"from\s+(jax|repro)\b(?!_torch))", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
    assert (ROOT / "chip_smoke.py").exists()
    assert [f.stem for f in EXAMPLES] == [
        "torch_elastic_restart", "torch_quickstart", "torch_serve_batched",
        "torch_train_e2e", "torch_workflow_pipeline"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if bad.search(f.read_text())]
    assert offenders == []


def test_training_modules_import_without_jax():
    """The trainer's modules alone, in a fresh process: no JAX, nothing of
    the JAX package."""
    mods = ["repro_torch.optim.adamw", "repro_torch.training.train_step",
            "repro_torch.launch.train"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_distributed_modules_and_rank_bodies_import_without_jax():
    """The distributed layer and the multi-rank tests' rank bodies (which
    every spawned rank imports), in a fresh process: no JAX, nothing of the
    JAX package."""
    mods = ["repro_torch.distributed.spawn", "repro_torch.launch.specs",
            "repro_torch.distributed.pipeline",
            "repro_torch.distributed.collectives", "torch_dist_ranks"]
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_port_examples_import_without_jax():
    """The port's examples, imported in a fresh process: no JAX, nothing of
    the JAX package."""
    mods = [f.stem for f in EXAMPLES]
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) == 5
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
