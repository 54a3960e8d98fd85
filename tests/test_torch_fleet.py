"""The port's fleet arbiter held against the JAX package's: one scripted
sequence (admission, queueing, proposals granted, shrunk, deferred and
no-op, preemption by admission pressure and by proposal, quotas, release,
the background ticker and TTL re-resolution of the endpoint directory)
drives both arbiters over stub VREs and string devices, and every verdict,
grant, queue, preemption count and ``status()`` must be equal. Then a
reduced fleet on the CPU over four shares of the host, arbitrated (one
prefix cache shared across the VREs) and static (one cache each)."""
import dataclasses
import time

import pytest

pytest.importorskip("jax")

from repro.core.monitoring import Monitor as JMonitor  # noqa: E402
from repro.fleet.arbiter import FleetArbiter as JArbiter  # noqa: E402
from repro.fleet.arbiter import ResourceClaim as JClaim  # noqa: E402
from repro_torch.core.monitoring import Monitor  # noqa: E402
from repro_torch.device import DeviceShare, device_pool  # noqa: E402
from repro_torch.fleet import driver  # noqa: E402
from repro_torch.fleet.arbiter import FleetArbiter, ResourceClaim  # noqa: E402


@dataclasses.dataclass
class StubConfig:
    name: str
    mesh_shape: tuple = (1, 1)
    arch: str = None
    extra: dict = dataclasses.field(default_factory=dict)


class _StubEndpoints:
    def __init__(self, vre):
        self.vre = vre

    def entries(self):
        return {"svc": {"address": f"vre://{self.vre.config.name}/svc"
                                   f"@g{self.vre.generation}",
                        "meta": {}}}

    def resolve(self, name):
        if name != "svc":
            raise KeyError(name)
        return self.entries()["svc"]["address"]


@dataclasses.dataclass
class _StubReport:
    old_shape: tuple
    new_shape: tuple


class StubVRE:
    """Just enough VRE for an arbiter: lifecycle, pending-resize
    bookkeeping, and a resize that swaps the mesh shape in place."""
    monitor_cls = Monitor

    def __init__(self, config):
        self.config = config
        self.pending_resize = None
        self.device_pool = None
        self.arbiter = None
        self.claim = None
        self.generation = 0
        self.state = "DEFINED"
        self.services = {}
        self.monitor = self.monitor_cls(name=config.name)
        self.endpoints = _StubEndpoints(self)

    def instantiate(self):
        self.generation += 1
        self.state = "RUNNING"

    def resize(self, new_mesh_shape, state=None, state_reshard=None):
        old = self.config.mesh_shape
        self.config = dataclasses.replace(self.config,
                                          mesh_shape=tuple(new_mesh_shape))
        self.generation += 1
        self.pending_resize = None
        return _StubReport(old, tuple(new_mesh_shape)), None

    def destroy(self):
        self.state = "DESTROYED"


class JStubVRE(StubVRE):
    monitor_cls = JMonitor


ARBITERS = {"jax": (JArbiter, JClaim, JStubVRE),
            "port": (FleetArbiter, ResourceClaim, StubVRE)}


def _status(arb):
    """``status()`` with the queue waits (host clock) reduced to whether
    the tenant waited."""
    st = arb.status()
    st["queue_wait_s"] = {n: w > 0 for n, w in st["queue_wait_s"].items()}
    return st


def _events(evs):
    return [{k: v for k, v in e.items() if k != "downtime_s"} for e in evs]


def _script(arbiter_cls, claim_cls, vre_cls):
    """The scripted fleet: every step's answer, in order."""
    arb = arbiter_cls(devices=[f"d{i}" for i in range(6)],
                      vre_factory=vre_cls, endpoint_ttl_s=0.05)
    log = []

    def step(label, out):
        log.append((label, out, _status(arb), arb.placements()))

    def submit(name, shape, **claim):
        out = arb.submit(StubConfig(name, shape), claim_cls(**claim))
        out = {k: v for k, v in out.items() if k != "vre"}
        step(f"submit {name}", out)

    for bad in ({"min_devices": 0}, {"min_devices": 3, "max_devices": 2},
                {"min_devices": 2, "max_devices": 4, "quota_devices": 1}):
        with pytest.raises(ValueError) as exc:
            claim_cls(**bad).validate()
        log.append(("bad claim", str(exc.value)))
    for shape, claim in (((3, 1), dict(max_devices=2)),
                         ((7, 1), dict(max_devices=8))):
        with pytest.raises(ValueError) as exc:
            arb.submit(StubConfig("x", shape), claim_cls(**claim))
        log.append(("bad submit", str(exc.value)))

    submit("a", (2, 1), max_devices=6)
    submit("b", (1, 1), max_devices=6, priority=1)
    step("propose a grant", arb.propose_resize("a", (3, 1)))
    step("propose a again", arb.propose_resize("a", (3, 1)))
    step("propose a shrunk", arb.propose_resize("a", (6, 1)))
    step("apply", _events(arb.apply_pending()))
    submit("hi", (2, 1), min_devices=1, max_devices=6, priority=3)
    submit("lo", (1, 1), max_devices=2)                  # behind the head
    step("tick: admission pressure", arb.tick())
    step("apply shrinks", _events(arb.apply_pending()))
    step("tick: admit", arb.tick())
    step("propose b deferred",
         arb.propose_resize("b", (4, 1), pressure=2.5))
    step("propose hi preempts",
         arb.propose_resize("hi", (3, 1), pressure=0.5))
    step("apply preemption", _events(arb.apply_pending()))
    with pytest.raises(KeyError):
        arb.propose_resize("nobody", (2, 1))
    a1 = arb.resolve("hi", "svc")
    arb.vre("hi").resize((3, 1))                         # behind the lease
    fresh = arb.resolve("hi", "svc")
    time.sleep(0.06)
    step("ttl", [a1, fresh, arb.resolve("hi", "svc"),
                 arb.directory.refreshes])
    arb.release("a")
    step("release a", None)
    step("apply after release", _events(arb.apply_pending()))
    step("tick", arb.tick())
    arb.release("hi")
    step("release hi", None)
    submit("q", (1, 1), max_devices=6, quota_devices=2, priority=1)
    step("propose q quota", arb.propose_resize("q", (6, 1)))
    step("propose q quota again", arb.propose_resize("q", (6, 1)))
    step("propose b shrink", arb.propose_resize("b", (1, 1)))
    step("apply rest", _events(arb.apply_pending()))
    arb.start_ticker(interval_s=0.01)
    try:
        submit("late", (3, 1), max_devices=6, priority=2)
        deadline = time.monotonic() + 10
        while arb.vre("late") is None:
            assert time.monotonic() < deadline, arb.status()
            time.sleep(0.005)
    finally:
        assert arb.stop_ticker()
    step("ticker admitted late", None)
    for name in list(arb.status()["vres"]):
        arb.release(name)
    time.sleep(0.06)
    with pytest.raises(KeyError):
        arb.resolve("late", "svc")
    step("all released", None)
    return log


def test_scripted_fleet_equals_jaxs():
    logs = {name: _script(*spec) for name, spec in ARBITERS.items()}
    assert len(logs["port"]) == len(logs["jax"])
    for ours, theirs in zip(logs["port"], logs["jax"]):
        assert ours == theirs, ours[0]
    labels = dict((entry[0], entry[1]) for entry in logs["port"])
    assert labels["propose a shrunk"]["verdict"] == "shrunk"
    assert labels["propose b deferred"]["verdict"] == "deferred"
    assert labels["propose hi preempts"]["preempted"] == ["a"]
    assert labels["tick: admission pressure"]["preempt_reserved"]
    assert labels["propose q quota"]["quota_capped"]
    assert labels["propose q quota again"]["verdict"] == "noop"
    final = logs["port"][-1][2]
    assert final["admissions"] == 6 and final["preemptions"] >= 2


def test_arbiter_default_pool_is_the_cards_shares(monkeypatch):
    monkeypatch.setattr("torch.cuda.device_count", lambda: 2)
    arb = FleetArbiter(vre_factory=StubVRE)
    assert [str(d) for d in arb.pool] == ["cuda:0#0", "cuda:1#0"]
    # two shares of one card are two devices to the arbiter
    pool = device_pool("cpu", 2)
    assert pool == [DeviceShare(pool[0].device, 0),
                    DeviceShare(pool[0].device, 1)]
    arb = FleetArbiter(devices=pool, vre_factory=StubVRE)
    arb.submit(StubConfig("a", (1, 1)), ResourceClaim(max_devices=2))
    arb.submit(StubConfig("b", (1, 1)), ResourceClaim(max_devices=2))
    grants = arb.placements()
    assert grants == {"a": [pool[0]], "b": [pool[1]]}
    assert arb.submit(StubConfig("c", (1, 1)),
                      ResourceClaim())["status"] == "queued"


@pytest.mark.parametrize("static", [False, True])
def test_reduced_fleet_over_shares_of_the_host(tmp_path, static):
    """Two tenants of the reduced yi-9b on four shares of the host: every
    request and every carried request completes; arbitrated, the second
    tenant's first phase hits the prompt head the first tenant cached
    (one prefix cache across the VREs), while static tenants keep their
    own caches."""
    report = driver.run_fleet_scenario(
        2, devices=device_pool("cpu", 4), provider="cpu",
        workdir=str(tmp_path), requests_per_phase=6, max_new_tokens=4,
        wave_repeats=1, static=static, tick_interval_s=0.02,
        telemetry_port=None if static else 0,
        rng=__import__("numpy").random.default_rng(0))
    assert report["completion_rate"] == 1.0
    assert report["carried"]["completed"] == report["carried"]["requests"]
    assert report["pool_devices"] == 4
    second = report["phases"][1]
    assert report["mode"] == ("static" if static else "arbitrated")
    if static:
        assert report["arbiter"]["preemptions"] == 0
        assert report["arbiter"]["grants"] == {"vre0": 2, "vre1": 2}
        assert second["vre0"]["prefix_cache"] != second["vre1"][
            "prefix_cache"]
    else:
        assert report["arbiter"]["preemptions"] >= 1
        assert report["arbiter"]["grants"] == {"vre0": 1, "vre1": 3}
        assert second["vre1"]["mesh"] == [3, 1]
        assert second["vre1"]["prefix_hit_tokens"] > 0
        assert second["vre0"]["prefix_cache"] == second["vre1"][
            "prefix_cache"]
        assert report["telemetry"]["url"].startswith("http://127.0.0.1:")
