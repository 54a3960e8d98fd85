"""The port's serving plane on the CPU: engine tokens against the JAX
package's ``greedy_generate`` (float32, params bridged from the JAX model),
slot reuse, a 2-replica ReplicaSet, the Poisson driver, and entry points
that refuse to fall back to the CPU silently."""
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.serving.engine import greedy_generate as jax_greedy  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine, greedy_generate  # noqa: E402
from repro_torch.serving.replica import ReplicaSet, partition_devices  # noqa: E402

MAX_SEQ = 96


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    eager = jax_build(jcfg)
    jp, _ = eager.init(jax.random.PRNGKey(0))
    jm = SimpleNamespace(cfg=jcfg, init_cache=eager.init_cache,
                         prefill=jax.jit(eager.prefill, static_argnums=2),
                         decode=jax.jit(eager.decode))
    tcfg = dataclasses.replace(t_reduced(t_get_config("yi-9b")),
                               dtype="float32")
    tm = build_model(tcfg, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def test_engine_matches_jax_greedy_oracle(models):
    """Padded batched prefill (bucket 16; 15/16/17 and 31/33 straddle a
    bucket edge) plus the fused decode emit exactly the JAX oracle's
    tokens."""
    jm, jp, tm, tp = models
    eng = ServingEngine(tm, tp, slots=3, max_seq=MAX_SEQ, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 503, size=n)
               for n in (5, 9, 13, 7, 15, 16, 17, 31, 33)]
    futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    for p, f in zip(prompts, futs):
        want = jax_greedy(jm, jp, p, 6, MAX_SEQ)
        np.testing.assert_array_equal(f.result(), want)
        np.testing.assert_array_equal(
            greedy_generate(tm, tp, p, 6, MAX_SEQ), want)


def test_continuous_batching_slot_reuse(models):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, slots=2, max_seq=64, device="cpu")
    futs = [eng.submit(np.arange(1, 5), max_new_tokens=4) for _ in range(5)]
    eng.run_until_idle()
    outs = [f.result() for f in futs]
    assert all(len(o) == 4 for o in outs)
    for o in outs[1:]:                      # identical prompts -> identical
        np.testing.assert_array_equal(o, outs[0])
    # batched admission: every request prefilled, in <= ceil(5/2) calls
    assert eng.metrics["prefill_requests"] == 5
    assert eng.metrics["prefills"] <= 3
    assert eng.load == 0 and all(a is None for a in eng.active)


def test_replicaset_two_replicas_complete_every_request(models):
    _, _, tm, tp = models
    cpu = torch.device("cpu")
    rs = ReplicaSet(lambda i, devs: ServingEngine(
        tm, tp, slots=2, max_seq=64, name=f"r{i}", device=devs[0]),
        replicas=2, devices=[cpu])
    assert partition_devices([cpu], 2) == [(cpu,), (cpu,)]
    rs.start()
    try:
        futs = [rs.submit(np.arange(1, 4 + i % 5), max_new_tokens=3)
                for i in range(8)]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        rs.stop()
    assert all(len(o) == 3 for o in outs)
    m = rs.metrics()
    assert m["total"]["completed"] == 8 and m["failovers"] == 0
    assert all(n > 0 for n in (m["per_replica"]["r0"]["requests"],
                               m["per_replica"]["r1"]["requests"]))
    assert rs.placements() == {"r0": (cpu,), "r1": (cpu,)}


def test_replicaset_fails_over_a_killed_replica(models):
    _, _, tm, tp = models
    rs = ReplicaSet(lambda i, devs: ServingEngine(
        tm, tp, slots=2, max_seq=64, name=f"r{i}", device="cpu"),
        replicas=2, devices=[torch.device("cpu")], respawn=True)
    rs.start()
    try:
        dead = rs.engines[0]
        dead.kill()
        deadline = time.monotonic() + 30
        while rs.metrics()["failovers"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dead not in rs.engines and rs.size == 2     # respawned
        futs = [rs.submit(np.arange(1, 6), max_new_tokens=3)
                for _ in range(4)]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        rs.stop()
    assert all(len(o) == 3 for o in outs)
    assert rs.metrics()["failovers"] == 1


def test_run_load_tiny():
    rs = serve.build_replicaset("yi-9b", replicas=2, slots=2, max_seq=48,
                                device="cpu")
    assert rs.engines[0].cfg.d_model == 64          # reduced by default
    rs.start()
    try:
        rng = np.random.default_rng(0)
        prompts = serve.make_prompts(4, rs.engines[0].cfg.vocab_size, rng)
        rep = serve.run_load(rs, prompts, rate_rps=50.0, max_new_tokens=3,
                             rng=rng)
    finally:
        rs.stop()
    assert rep["completed"] == 4 and rep["tokens"] == 12
    assert rep["tok_per_s"] > 0 and rep["ttft_p50_s"] is not None
    assert rep["prefill_requests"] == 4


def test_main_on_cpu(capsys):
    rep = serve.main(["--device", "cpu", "--requests", "3", "--rate", "0",
                      "--max-new", "2", "--replicas", "1"])
    assert rep["completed"] == 3
    assert '"completed": 3' in capsys.readouterr().out


def test_main_rejects_bad_flags():
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--slots", "0"])


def test_entry_points_without_a_device_raise_on_a_cpu_host(models,
                                                           monkeypatch):
    """No silent CPU fallback: with no card and no ``device``, every entry
    point raises and names the ``device="cpu"`` option."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm, tp = models
    match = 'device="cpu"'
    with pytest.raises(RuntimeError, match=match):
        build_model(tm.cfg)
    with pytest.raises(RuntimeError, match=match):
        ServingEngine(tm, tp, slots=2, max_seq=64)
    with pytest.raises(RuntimeError, match=match):
        serve.build_replicaset("yi-9b", replicas=1, slots=2, max_seq=64)
    with pytest.raises(RuntimeError, match=match):
        serve.main(["--requests", "1"])
