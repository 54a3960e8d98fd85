"""The port's live telemetry plane held against the JAX package's: the
Prometheus exposition text for equal samples, the malformed inputs
``validate_exposition`` flags, the SLO engine's burn rates and the
autoscaler's decisions for one monitor feed, the HTTP routes' answers, the
``repro_*`` names and labels a serving VRE exposes, and scrapes racing an
elastic resize over two shares of the host."""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core.monitoring import Monitor as JMonitor  # noqa: E402
from repro.core.registry import StaleEndpoint as JStale  # noqa: E402
from repro.observability import metrics as jmetrics  # noqa: E402
from repro.observability import slo as jslo  # noqa: E402
from repro.observability import telemetry as jtelemetry  # noqa: E402
from repro.serving import autoscaler as jautoscaler  # noqa: E402
from repro.serving.replica import ReplicaSet as JReplicaSet  # noqa: E402
from repro_torch.core.monitoring import Monitor  # noqa: E402
from repro_torch.core.registry import StaleEndpoint  # noqa: E402
from repro_torch.observability import metrics, slo, telemetry  # noqa: E402
from repro_torch.serving import autoscaler  # noqa: E402
from repro_torch.serving.replica import ReplicaSet  # noqa: E402

PACKAGES = {
    "jax": dict(metrics=jmetrics, slo=jslo, telemetry=jtelemetry,
                autoscaler=jautoscaler, Monitor=JMonitor, Stale=JStale,
                pool=lambda n: JReplicaSet(lambda i: _FakeEngine(),
                                           replicas=n)),
    "port": dict(metrics=metrics, slo=slo, telemetry=telemetry,
                 autoscaler=autoscaler, Monitor=Monitor, Stale=StaleEndpoint,
                 pool=lambda n: ReplicaSet(lambda i, devs: _FakeEngine(),
                                           replicas=n)),
}


def _both(fn):
    """``fn(package namespace)`` for the JAX package and the port."""
    return {name: fn(pkg) for name, pkg in PACKAGES.items()}


def _samples(m):
    S = m.MetricSample
    return [
        S("queue_depth", 3.0, {"vre": "a"}),
        S("queue_depth", 5.0, {"vre": "b"}, help="depth"),
        S("queue_depth", 7.0, {"vre": "a"}),          # dup key: keep last
        S("engine_tokens_total", 42.0, kind="counter", help='a "b"\nc'),
        S("g", float("nan"), {"k": 'x"y\\z'}),
        S("g", float("inf"), {"k": "b"}),
        S("g", float("-inf"), {"k": "c", "a": "z\nq"}),
        S("h", 1e-9), S("h", 123456789.0, {"big": "1"}),
    ]


# -- exposition --------------------------------------------------------------

@pytest.mark.parametrize("namespace", ["repro", "vre_fleet"])
def test_render_exposition_text_equals_jaxs(namespace):
    text = _both(lambda p: p["metrics"].render_exposition(
        _samples(p["metrics"]), namespace=namespace))
    assert text["port"] == text["jax"]
    assert text["port"].count(f"# TYPE {namespace}_queue_depth gauge") == 1
    assert metrics.validate_exposition(text["port"]) == []


@pytest.mark.parametrize("bad", [
    dict(name="bad name!", value=1.0), dict(name="x", value=1.0,
                                            kind="histogram")])
def test_render_exposition_rejects_as_jax(bad):
    msgs = {}
    for name, p in PACKAGES.items():
        with pytest.raises(ValueError) as exc:
            p["metrics"].render_exposition([p["metrics"].MetricSample(**bad)])
        msgs[name] = str(exc.value)
    assert msgs["port"] == msgs["jax"]


MALFORMED = [
    "repro_x 1.0\n",
    "repro x 1.0\n",
    "# TYPE repro_x wat\n",
    "# TYPE repro_x gauge\n# TYPE repro_x gauge\nrepro_x 1\n",
    "repro_x 1\n# TYPE repro_x gauge\n",
    'repro_x{a="1",b=2} 3\n',
    "repro_x 1.2.3\n",
    "repro_x NaN\nrepro_y +Inf\nrepro_z -Inf 1700000000\n",
    "# HELP repro_x some help\n\n# TYPE\nrepro_x{} 1\n",
    'repro_x{a="\\"q\\""} 1e-3\n',
]


@pytest.mark.parametrize("text", MALFORMED)
def test_validate_exposition_flags_as_jax(text):
    errs = _both(lambda p: p["metrics"].validate_exposition(text))
    assert errs["port"] == errs["jax"]


def test_registry_series_and_derived_rates_as_jax():
    def run(p):
        reg = p["metrics"].MetricsRegistry(series_window=3)
        n = {"v": 0.0}
        reg.add_source(lambda: [p["metrics"].MetricSample(
            "engine_tokens_total", n["v"], {"vre": "t"}, kind="counter")],
            name="fake")
        reg.add_source(lambda: 1 / 0, name="bad")
        out = []
        for v in (0.0, 50.0, 50.0, 80.0):
            n["v"] = v
            out.append(sorted((s.name, s.kind, tuple(sorted(
                s.labels.items()))) for s in reg.snapshot()))
            time.sleep(0.002)
        return out, [v for _, v in reg.series("engine_tokens_total",
                                               vre="t")], reg.source_errors
    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][1] == [50.0, 50.0, 80.0] and got["port"][2] == 4


# -- SLO engine and autoscaler ------------------------------------------------

FEED = [("r0", "latency_s", x) for x in (0.01, 0.02, 0.5, 0.7, 0.03)] + \
    [("r1", "latency_s", x) for x in (0.2, 0.01)] + \
    [("r0", "ttft_s", x) for x in (0.04, 0.2, 0.3)] + \
    [("r1", "queue_wait_s", 0.5)]
SLO_CFG = {"ttft_p95_s": 0.1, "latency_p95_s": 0.1, "queue_wait_p95_s": 0.2,
           "window_s": 30.0, "error_budget": 0.25}


def test_slo_burn_rates_equal_jaxs():
    def run(p):
        mon = p["Monitor"]()
        engine = p["slo"].SLOEngine(
            mon, p["slo"].targets_from_config(SLO_CFG),
            services=lambda: ["r0", "r1"], burn_threshold=1.5)
        out = [engine.evaluate()]
        for svc, gauge, v in FEED:
            mon.gauge(svc, gauge, v)
            out.append(engine.evaluate())
        reg = p["metrics"].MetricsRegistry()
        reg.register_slo(engine, vre="t")
        text = "\n".join(ln for ln in reg.render().splitlines()
                         if "telemetry_" not in ln)
        return out, engine.burn_rate, engine.burning, text
    got = _both(run)
    assert got["port"] == got["jax"]
    last = got["port"][0][-1]
    assert last["latency_p95"]["error_rate"] == pytest.approx(3 / 7)
    assert last["latency_p95"]["burn_rate"] == pytest.approx(12 / 7)
    assert got["port"][2] is True


class _FakeEngine:
    """What the autoscaler reads of a replica: its load, health and
    heartbeat; the load comes from one shared level."""
    level = {"load": 0}
    n = 0

    def __init__(self):
        self.name = f"fake{_FakeEngine.n}"
        _FakeEngine.n += 1
        self.heartbeat = time.monotonic()
        self.metrics = {}
        self.queue = None
        self.devices = ()

    def start(self):
        return self

    def stop(self, timeout=None):
        return True

    def healthy(self):
        return True

    def harvest_requests(self):
        return []

    @property
    def load(self):
        return _FakeEngine.level["load"]

    @property
    def running(self):
        return True


# (load per replica, a latency sample for every replica or None)
STEPS = [(6, None), (6, None), (6, None), (6, None), (6, None), (1, None),
         (0, None), (0, None), (0, None), (1, None), (1, 0.9), (1, 0.9)]


@pytest.mark.parametrize("verdict", [None, "deferred", "noop"])
def test_autoscaler_decisions_equal_jaxs(verdict):
    """One load and latency feed: every decision, replica count, event
    counter and the pressure handed to the resize hook equal JAX's."""
    def run(p):
        _FakeEngine.n = 0
        mon = p["Monitor"]()
        rs = p["pool"](2)
        engine = p["slo"].SLOEngine(
            mon, [p["slo"].SLOTarget("latency_p95", "latency_s", 0.5)],
            services=lambda: [e.name for e in rs.engines])
        proposals = []

        def resize(pressure=None):
            proposals.append(pressure)
            if verdict is not None:
                return {"verdict": verdict, "devices": 2}
        scaler = p["autoscaler"].Autoscaler(
            rs, mon, p["autoscaler"].AutoscalerConfig(
                min_replicas=1, max_replicas=3, scale_up_load=3.0,
                scale_down_load=0.5, latency_p95_slo_s=2.0),
            resize_mesh=resize, slo=engine)
        decisions = []
        for load, lat in STEPS:
            _FakeEngine.level["load"] = load
            if lat is not None:
                for e in rs.engines:
                    mon.gauge(e.name, "latency_s", lat)
            decisions.append((scaler.evaluate(), rs.size))
            if len(decisions) == 4:
                scaler.notify_resized()
        return decisions, proposals, scaler.scale_events, \
            sorted(mon.counters().items())
    got = _both(run)
    assert got["port"] == got["jax"]
    actions = {a for a, _ in got["port"][0]}
    # a noop verdict (quota-capped) reports hold: no resize is coming
    assert {"up", "down", "hold"} <= actions and got["port"][1]
    assert ("resize" in actions) == (verdict != "noop")


def test_autoscaler_signature_check_as_jaxs():
    """Only a resize hook that declares ``pressure`` gets the burn rate."""
    def run(p):
        _FakeEngine.level["load"] = 9
        mon = p["Monitor"]()
        rs = p["pool"](2)
        engine = p["slo"].SLOEngine(
            mon, [p["slo"].SLOTarget("latency_p95", "latency_s", 0.05)],
            services=lambda: [e.name for e in rs.engines])
        for _ in range(10):
            mon.gauge(rs.engines[0].name, "latency_s", 1.0)
        hits = []
        scaler = p["autoscaler"].Autoscaler(
            rs, mon, p["autoscaler"].AutoscalerConfig(max_replicas=2),
            resize_mesh=lambda: hits.append("bare"), slo=engine)
        return scaler.evaluate(), hits, scaler._resize_takes_pressure
    got = _both(run)
    assert got["port"] == got["jax"] == ("resize", ["bare"], False)


# -- the HTTP surface ----------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def test_telemetry_routes_answer_as_jaxs():
    """The same registry and targets behind each package's server: every
    route gives the same status, content type and body, through health
    flips, a stale lease and unknown names."""
    state = {"healthy": True, "stale": False}
    servers = {}
    for name, p in PACKAGES.items():
        reg = p["metrics"].MetricsRegistry()
        reg.add_source(lambda p=p: [p["metrics"].MetricSample(
            "queue_depth", 2.0, {"vre": "t0"})], name="fake")

        def info(p=p):
            if state["stale"]:
                raise p["Stale"]("t0 lease expired")
            return {"healthy": state["healthy"], "generation": 3,
                    "address": "vre://t0/lm-server@g3"}

        def resolve(n, info=info):
            if n != "t0":
                raise KeyError(n)
            return info()
        servers[name] = p["telemetry"].TelemetryServer(
            reg, list_targets=lambda info=info: {"t0": info()},
            resolve_target=resolve, port=0).start()
    paths = ["/metrics", "/healthz", "/vres", "/vre/t0/metrics",
             "/vre/t0/health", "/vre/nope/health", "/bogus", "/metrics/"]
    try:
        for flip in ({}, {"healthy": False}, {"stale": True}):
            state.update(flip)
            for path in paths:
                got = {n: _get(s.url + path) for n, s in servers.items()}
                assert got["port"] == got["jax"], path
        assert servers["port"].scrapes == servers["jax"].scrapes == 24
        assert servers["port"].url.startswith("http://127.0.0.1:")
    finally:
        for s in servers.values():
            s.stop()


def test_telemetry_answers_500_on_callback_crash_as_jaxs():
    def boom():
        raise RuntimeError("plane torn down")
    got = {}
    for name, p in PACKAGES.items():
        srv = p["telemetry"].TelemetryServer(
            p["metrics"].MetricsRegistry(), list_targets=boom,
            resolve_target=lambda n: boom(), port=0).start()
        try:
            got[name] = [_get(srv.url + path)[:2]
                         for path in ("/healthz", "/metrics")]
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 500 and got["port"][1][0] == 200


# -- a serving VRE's samples, and scrapes racing a resize --------------------

def _series_shape(samples):
    """(name, kind, label keys) of every sample; monitor gauges also by
    their gauge and stat."""
    out = set()
    for s in samples:
        keys = tuple(sorted(s.labels))
        extra = (s.labels.get("gauge"), s.labels.get("stat")) \
            if s.name == "monitor_gauge" else ()
        out.add((s.name, s.kind, keys, *extra))
    return out


def test_vre_samples_have_jaxs_names_and_labels(tmp_path):
    """A serving VRE of either package, after the same request, exposes the
    same metric names, kinds and label sets, so one dashboard reads
    both."""
    import repro.core.services  # noqa: F401
    import repro_torch.core.services  # noqa: F401
    from repro.core.vre import VREConfig as JVREConfig
    from repro.core.vre import VirtualResearchEnvironment as JVRE
    from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment

    shapes = {}
    for name, config, cls, m in (
            ("jax", JVREConfig, JVRE, jmetrics),
            ("port", VREConfig, VirtualResearchEnvironment, metrics)):
        vre = cls(config(name="t", services=["lm-server"], provider="cpu",
                         arch="yi-9b", workdir=str(tmp_path / name),
                         extra={"replicas": 1, "slots": 2, "max_seq": 32}))
        vre.instantiate()
        try:
            rs = vre.service("lm-server").replicaset
            rs.submit(np.arange(1, 6), max_new_tokens=3).result(timeout=300)
            shapes[name] = _series_shape(m.vre_samples(vre))
        finally:
            vre.destroy()
    assert shapes["port"] == shapes["jax"]
    assert ("engine_tokens_total", "counter", ("vre",)) in shapes["port"]
    assert ("rebalances_total", "counter", ("vre",)) in shapes["port"]


def test_concurrent_scrapes_survive_a_resize_over_shares(tmp_path):
    """A scraper on ``/metrics``, ``/healthz`` and the VRE's routes while
    ``resize_serving`` moves the pool from one share of the host to two:
    every request answers 200 or 503, every exposition validates, and the
    lease moves to the new generation."""
    import repro_torch.core.services  # noqa: F401
    from repro_torch.core import elastic
    from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment
    from repro_torch.device import device_pool
    from repro_torch.observability import validate_exposition, vre_telemetry

    vre = VirtualResearchEnvironment(VREConfig(
        name="rz", mesh_shape=(1, 1), services=["lm-server"],
        provider="cpu", arch="yi-9b", workdir=str(tmp_path),
        extra={"replicas": "auto", "slots": 2, "max_seq": 32}))
    vre.device_pool = device_pool("cpu", 2)
    vre.instantiate()
    srv = vre_telemetry(vre, port=0)
    results = {"codes": [], "errors": [], "bodies": 0}
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            for path in ("/metrics", "/healthz", "/vre/rz/health",
                         "/vre/rz/metrics"):
                try:
                    status, _, body = _get(srv.url + path)
                    results["codes"].append(status)
                    if path == "/metrics":
                        assert validate_exposition(body) == [], body
                        results["bodies"] += 1
                except Exception as exc:
                    results["errors"].append(repr(exc))
            time.sleep(0.002)
    try:
        rs = vre.service("lm-server").replicaset
        reqs = [rs.submit_request(np.arange(1, 6 + i), max_new_tokens=4)
                for i in range(3)]
        rs = None
        t = threading.Thread(target=scrape, daemon=True)
        t.start()
        g0 = vre.generation
        vre.request_resize((2, 1))
        ev = elastic.resize_serving(vre)
        assert ev is not None and ev["report"].new_shape == (2, 1)
        assert all(len(r.future.result(timeout=120)) == 4 for r in reqs)
        time.sleep(0.2)
        stop.set()
        t.join(10)
        assert not results["errors"], results["errors"]
        assert results["bodies"] > 0
        assert set(results["codes"]) <= {200, 503}, results["codes"]
        status, _, body = _get(srv.url + "/vre/rz/health")
        info = json.loads(body)
        assert status == 200 and info["generation"] > g0
        assert info["address"].endswith(f"@g{vre.generation}")
        _, _, body = _get(srv.url + "/metrics")
        assert validate_exposition(body) == []
        assert f'repro_vre_generation{{vre="rz"}} {float(vre.generation)}' \
            in body
        assert 'repro_vre_mesh_devices{vre="rz"} 2.0' in body
    finally:
        stop.set()
        srv.stop()
        vre.destroy()
