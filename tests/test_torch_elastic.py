"""Elastic serving in the port, held against the JAX package's
``repro.core.elastic`` and ``launch.serve.run_elastic_serve``: the same
resize sequence on both (a VRE at (1, 1) serving five prompts, resized to
(2, 1) with them in flight, then serving them again on the grown mesh;
JAX on two forced host devices in a subprocess, the port on two shares of
the host) gives the greedy oracle's tokens and a no-resize run's, on
disjoint replica slices; ``rebalance``, ``detach_requests`` and ``adopt``
carry every future; an infeasible resize is cleared and logged as JAX
logs it; and ``run_elastic_serve`` reports JAX's keys. Reduced yi-9b in
float32, params bridged from the JAX model."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.core.services as jax_services  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.core import elastic as jax_elastic  # noqa: E402
from repro.core.vre import VREConfig as JVREConfig  # noqa: E402
from repro.core.vre import VirtualResearchEnvironment as JVRE  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
import repro_torch.core.services as services  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import elastic  # noqa: E402
from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment  # noqa: E402
from repro_torch.device import DeviceShare, device_pool  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, greedy_generate  # noqa: E402
from repro_torch.serving.replica import ReplicaSet  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
EXTRA = {"replicas": "auto", "slots": 2, "max_seq": 64}
NEW = 6
WAVES = dict(waves=2, requests_per_wave=4, rate_rps=0.0, max_new_tokens=3)


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 503, size=int(n))
            for n in rng.integers(4, 12, size=5)]


# the JAX side of the resize sequence, on two forced host devices
JAX_SEQUENCE = """
    import dataclasses, json, tempfile
    import jax, numpy as np
    import repro.core.services as services
    from repro.configs import get_config, reduced
    from repro.core import elastic
    from repro.core.vre import VREConfig, VirtualResearchEnvironment
    from repro.launch.serve import run_elastic_serve
    from repro.models.model import build_model

    cfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    model = build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    services._SERVED_MODEL_CACHE[("yi-9b", "cpu")] = (cfg, model, params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 503, size=int(n))
               for n in rng.integers(4, 12, size=5)]

    def vre(name):
        v = VirtualResearchEnvironment(VREConfig(
            name=name, mesh_shape=(1, 1), services=["lm-server"],
            arch="yi-9b", workdir=tempfile.mkdtemp(), extra=EXTRA))
        v.instantiate()
        return v

    v = vre("rz")
    rs = v.service("lm-server").replicaset
    reqs = [rs.submit_request(p, max_new_tokens=NEW) for p in prompts]
    v.request_resize((2, 1))
    ev = elastic.resize_serving(v)
    carried = [r.future.result(timeout=300).tolist() for r in reqs]
    rs = v.service("lm-server").replicaset
    after = [rs.submit_request(p, max_new_tokens=NEW).future.result(
        timeout=300).tolist() for p in prompts]
    sets = [sorted(map(str, s)) for s in rs.placements().values()]
    status = v.status()
    v.destroy()
    v = vre("waves")
    report = run_elastic_serve(v, force_resize=True,
                               rng=np.random.default_rng(0), **WAVES)
    v.destroy()
    print(json.dumps({
        "carried": carried, "after": after, "slices": sets,
        "mesh": status["mesh"], "pending": status["pending_resize"],
        "report": report}, default=str))
"""


@pytest.fixture(scope="module")
def jax_sequence():
    """The JAX sequence's output, run beside the module's port tests."""
    code = "\n".join([f"EXTRA = {EXTRA!r}", f"NEW = {NEW}",
                      f"WAVES = {WAVES!r}",
                      textwrap.dedent(JAX_SEQUENCE)])
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)

    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-5000:]
        return json.loads(out.strip().splitlines()[-1])
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def f32_models():
    """One float32 reduced yi-9b in both packages (params bridged)."""
    jcfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    jmodel = jax_build(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(t_reduced(t_get_config("yi-9b")),
                               dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jcfg, jmodel, jp), (tcfg, tmodel, tp)


@pytest.fixture
def seeded(monkeypatch, f32_models):
    jax_ent, port_ent = f32_models
    monkeypatch.setitem(jax_services._SERVED_MODEL_CACHE, ("yi-9b", "cpu"),
                        jax_ent)
    monkeypatch.setitem(services._SERVED_MODEL_CACHE, ("yi-9b", "cpu"),
                        port_ent)
    return port_ent


def _vre(tmp_path, name, shares=2, extra=EXTRA):
    vre = VirtualResearchEnvironment(VREConfig(
        name=name, mesh_shape=(1, 1), services=["lm-server"],
        provider="cpu", arch="yi-9b", workdir=str(tmp_path / name),
        extra=dict(extra)))
    vre.device_pool = device_pool("cpu", shares)
    vre.instantiate()
    return vre


def test_resize_sequence_tokens_equal_jaxs_and_the_oracle(
        tmp_path, jax_sequence, seeded):
    _, model, params = seeded
    prompts = _prompts()
    oracle = [greedy_generate(model, params, p, NEW, EXTRA["max_seq"])
              .tolist() for p in prompts]
    # the no-resize run
    vre = _vre(tmp_path, "still", shares=1)
    rs = vre.service("lm-server").replicaset
    still = [rs.submit(p, max_new_tokens=NEW).result(timeout=120).tolist()
             for p in prompts]
    rs = None
    vre.destroy()
    # the resize with the prompts in flight
    vre = _vre(tmp_path, "rz")
    rs = vre.service("lm-server").replicaset
    assert list(rs.placements().values()) == [(DeviceShare(
        torch.device("cpu"), 0),)]
    reqs = [rs.submit_request(p, max_new_tokens=NEW) for p in prompts]
    rs = None
    assert vre.request_resize((2, 1)) == (2, 1)
    ev = elastic.resize_serving(vre)
    carried = [r.future.result(timeout=120).tolist() for r in reqs]
    rs = vre.service("lm-server").replicaset
    after = [rs.submit(p, max_new_tokens=NEW).result(timeout=120).tolist()
             for p in prompts]
    slices = [set(s) for s in rs.placements().values()]
    status = vre.status()
    events = [e for e in vre.monitor.events()
              if e["event"] == "resize_applied"]
    vre.destroy()
    assert carried == after == still == oracle
    assert isinstance(ev["report"], elastic.ResizeReport)
    assert ev["report"].new_shape == (2, 1) and ev["downtime_s"] >= 0
    assert 0 <= ev["carried_requests"] <= len(prompts)
    assert len(slices) == 2 and slices[0].isdisjoint(slices[1])
    assert status["mesh"] == [2, 1] and status["pending_resize"] is None
    assert status["granted_devices"] == 2
    assert events and events[0]["new"] == [2, 1]
    theirs = jax_sequence()
    assert theirs["carried"] == theirs["after"] == oracle
    assert theirs["mesh"] == status["mesh"]
    assert theirs["pending"] is None and len(theirs["slices"]) == 2


def test_run_elastic_serve_reports_jaxs_keys(tmp_path, jax_sequence,
                                             seeded):
    vre = _vre(tmp_path, "waves")
    try:
        ours = serve.run_elastic_serve(vre, force_resize=True,
                                       rng=np.random.default_rng(0), **WAVES)
    finally:
        vre.destroy()
    theirs = jax_sequence()["report"]
    assert ours.keys() == theirs.keys()
    for a, b in zip(ours["waves"], theirs["waves"]):
        assert a.keys() == b.keys()
    assert [r.keys() for r in ours["resizes"]] == \
        [r.keys() for r in theirs["resizes"]]
    for key in ("requests", "completed", "completion_rate", "final_mesh"):
        assert ours[key] == theirs[key], key
    assert ours["completion_rate"] == 1.0 and ours["final_mesh"] == [2, 1]
    assert [w["mesh"] for w in ours["waves"]] == [[1, 1], [2, 1]]
    assert ours["waves"][1]["placements"] == {
        "replica0": ["cpu#0"], "replica1": ["cpu#1"]}
    assert [w["placements"].keys() for w in ours["waves"]] == \
        [w["placements"].keys() for w in theirs["waves"]]
    assert ours["resizes"][0]["old_shape"] == [1, 1]


@pytest.mark.parametrize("shares", [1, None])
def test_infeasible_resize_is_cleared_and_logged_as_jaxs(tmp_path, shares):
    """Past the pool (the host's one device, or a pool of one share) the
    pending shape is cleared, the VRE keeps running, and the event names
    what was wanted and what there is, as JAX's does."""
    logged = {}
    for name, cls, config, mod in (("jax", JVRE, JVREConfig, jax_elastic),
                                   ("port", VirtualResearchEnvironment,
                                    VREConfig, elastic)):
        vre = cls(config(name="inf", mesh_shape=(1, 1), services=[],
                         provider="cpu", workdir=str(tmp_path / name)))
        if name == "port" and shares:
            vre.device_pool = device_pool("cpu", shares)
        vre.instantiate()
        vre.request_resize((4096, 1))
        assert mod.resize_serving(vre) is None
        assert vre.pending_resize is None and vre.state == "RUNNING"
        assert mod.resize_if_requested(vre, state={"x": 1}) == \
            (None, {"x": 1})
        logged[name] = [{k: v for k, v in e.items() if k not in ("t", "ts")}
                        for e in vre.monitor.events()
                        if e["event"] == "resize_infeasible"]
        vre.destroy()
    assert logged["port"] == logged["jax"]
    assert logged["port"][0]["want"] == 4096
    assert logged["port"][0]["have"] == 1


def test_infeasible_resize_rearms_the_autoscaler(tmp_path, seeded):
    vre = _vre(tmp_path, "arm", shares=1,
               extra={**EXTRA, "autoscale": True})
    try:
        scaler = vre.service("lm-server").autoscaler
        scaler._resize_requested = True          # an episode already fired
        vre.request_resize()
        assert elastic.resize_serving(vre) is None
        assert scaler._resize_requested is False
    finally:
        vre.destroy()


def _pool(models, n_replicas=2, shares=2):
    _, model, params = models
    return serve.replicaset_for(model, params, replicas=n_replicas, slots=2,
                                max_seq=64, devices=device_pool("cpu",
                                                                shares))


def test_rebalance_carries_every_future(seeded):
    _, model, params = seeded
    prompts = _prompts() * 2
    oracle = [greedy_generate(model, params, p, NEW, 64).tolist()
              for p in prompts]
    rs = _pool(seeded)
    rs.start()
    try:
        reqs = [rs.submit_request(p, max_new_tokens=NEW) for p in prompts]
        stats = rs.rebalance(replicas=3)
        outs = [r.future.result(timeout=120).tolist() for r in reqs]
        assert stats["replicas"] == 3 and rs.size == 3
        assert 0 <= stats["requeued"] <= len(prompts)
        # three replicas on two shares: each share in use, fairly
        used = [s for devs in rs.placements().values() for s in devs]
        assert sorted(map(str, used)) == ["cpu#0", "cpu#0", "cpu#1"]
        m = rs.metrics()
        assert m["rebalances"] == 1 and m["total"]["completed"] == len(
            prompts)
    finally:
        rs.stop()
    assert outs == oracle


def test_detach_and_adopt_carry_every_future(seeded):
    """Queued and active requests leave a stopped pool with their futures
    attached and finish on the successor with the oracle's tokens."""
    _, model, params = seeded
    prompts = _prompts()
    oracle = [greedy_generate(model, params, p, NEW, 64).tolist()
              for p in prompts]
    old = _pool(seeded, n_replicas=1, shares=1)
    old.start()
    reqs = [old.submit_request(p, max_new_tokens=NEW) for p in prompts]
    carried = old.detach_requests()
    assert all(not r.future.done() for r in carried)
    assert all(r.generated == [] for r in carried)
    new = _pool(seeded)
    assert new.adopt_prefix_cache(old.prefix_cache) == 0
    new.start()
    try:
        new.adopt(carried)
        outs = [r.future.result(timeout=120).tolist() for r in reqs]
    finally:
        new.stop()
    assert outs == oracle


class _StuckEngine:
    """A replica whose decode thread does not stop: one request active,
    one queued."""
    name = "stuck"

    def __init__(self):
        import queue
        self.queue = queue.Queue()
        self.active = [Request(np.arange(1, 5))]
        self.active[0].slot = 0
        self.queue.put(Request(np.arange(1, 6)))

    def stop(self, timeout=None):
        return False


def test_detach_fails_a_stuck_replicas_active_slots():
    rs = ReplicaSet(lambda i, devs: _StuckEngine(), replicas=1)
    active = rs.engines[0].active[0]
    out = rs.detach_requests(timeout=0.01)
    assert len(out) == 1 and not out[0].future.done()
    with pytest.raises(RuntimeError, match="unresponsive during detach"):
        active.future.result(timeout=0)


def test_resize_carries_state_through_the_checkpoint_store(tmp_path):
    vre = VirtualResearchEnvironment(VREConfig(
        name="st", mesh_shape=(1, 1), services=["volumes"], provider="cpu",
        workdir=str(tmp_path)))
    vre.device_pool = device_pool("cpu", 2)
    vre.instantiate()
    state = {"w": torch.arange(6, dtype=torch.float32), "step": np.int64(3)}
    report, restored = vre.resize((2, 1), state=state)
    try:
        assert report.old_shape == (1, 1) and report.new_shape == (2, 1)
        assert [f.name for f in dataclasses.fields(report)] == [
            f.name for f in dataclasses.fields(jax_elastic.ResizeReport)]
        assert torch.equal(restored["w"], state["w"])
        assert int(restored["step"]) == 3
        assert vre.mesh.shape == {"data": 2, "model": 1}
    finally:
        vre.destroy()



def test_recorder_follows_the_pool_across_a_resize(tmp_path, seeded):
    """The successor pool appends to the predecessor's record file: one
    meta header a generation, a ``resize`` control record, and every
    carried request recorded once with the disruption it rode through."""
    from repro_torch.observability import RecordStore

    _, model, params = seeded
    path = tmp_path / "rec.jsonl"
    vre = _vre(tmp_path, "rec", extra={**EXTRA, "record_path": str(path)})
    prompts = _prompts()
    rs = vre.service("lm-server").replicaset
    reqs = [rs.submit_request(p, max_new_tokens=NEW) for p in prompts]
    rs = None
    vre.request_resize((2, 1))
    ev = elastic.resize_serving(vre)
    outs = [r.future.result(timeout=120).tolist() for r in reqs]
    vre.destroy()
    store = RecordStore.load(path)
    assert outs == [greedy_generate(model, params, p, NEW, 64).tolist()
                    for p in prompts]
    assert len(store.records) == len(prompts)
    (control,) = [c for c in store.controls if c["event"] == "resize"]
    assert control["carried_requests"] == ev["carried_requests"]
    assert control["new_shape"] == [2, 1]
    disrupted = [r for r in store.records if r.get("disruptions")]
    assert len(disrupted) == ev["carried_requests"]
    assert all({"detached", "resize", "adopted"} <= {
        d["event"] for d in r["disruptions"]} for r in disrupted)
