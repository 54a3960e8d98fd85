"""HTTP telemetry plane: /metrics, /healthz, /vres over live VREs.

The first real socket-level surface of the microservice plane: a stdlib
``ThreadingHTTPServer`` — no new dependencies — serving

  GET /metrics               Prometheus text exposition of the whole
                             registry (fleet-wide in fleet mode)
  GET /healthz               aggregate health: 200 iff every target's
                             serving pool has all replicas healthy
  GET /vres                  JSON listing of known VREs with their
                             generation-tagged addresses
  GET /vre/<name>/metrics    one VRE's samples
  GET /vre/<name>/health     one VRE's health (200/503) + lease address

Names are resolved through the ``EndpointDirectory`` *per scrape*: the
fleet directory's TTL leases re-resolve against the live VRE (generation
tag and all), so a dashboard polling ``/vre/t0/health`` keeps getting
answers across elastic resizes, failovers, and pool swaps — the address
it sees simply moves to the next generation. Unknown names 404; names
whose lease cannot currently be resolved (mid-teardown) answer 503 with
``address: null`` rather than erroring, because "temporarily unhealthy"
and "not found" are different facts.

A copy of the JAX package's ``repro.observability.telemetry``
(framework-free); it binds ``127.0.0.1`` by default.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from repro_torch.core.registry import StaleEndpoint
from repro_torch.observability.metrics import MetricsRegistry, MetricSample, \
    arbiter_samples, vre_samples

EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# ---------------------------------------------------------------------------
# Health semantics
# ---------------------------------------------------------------------------
def replicaset_healthy(rs) -> bool:
    """Strict pool health for the scrape surface: every replica's decode
    loop alive (a killed replica flips this *immediately*, before the
    health sweep's failover runs — the sweep then repairs the pool and
    health recovers). An empty pool is unhealthy: it can serve nothing."""
    engines = list(getattr(rs, "engines", ()))
    return bool(engines) and all(e.healthy() for e in engines)


def vre_healthy(vre) -> bool:
    """RUNNING + every service healthy; serving pools use the strict
    all-replicas check above."""
    if getattr(vre, "state", None) != "RUNNING":
        return False
    for svc in list(vre.services.values()):
        rs = getattr(getattr(svc, "instance", None), "replicaset", None)
        try:
            if rs is not None:
                if not replicaset_healthy(rs):
                    return False
            elif not svc.health():
                return False
        except Exception:
            return False        # racing a teardown reads as unhealthy
    return True


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------
class TelemetryServer:
    """Threaded HTTP server over a ``MetricsRegistry`` plus target
    resolution callbacks.

    ``list_targets()`` returns ``{name: info}`` for ``/vres`` and the
    aggregate ``/healthz``; ``resolve_target(name)`` returns the same info
    dict for one name (raising ``KeyError`` for unknown names). Info dicts
    carry ``healthy`` (bool), ``generation``, and ``address`` (None while
    a lease cannot be resolved). Use the ``vre_telemetry`` /
    ``fleet_telemetry`` / ``replicaset_telemetry`` builders rather than
    wiring callbacks by hand."""

    def __init__(self, registry: MetricsRegistry, *,
                 list_targets: Callable[[], Dict[str, dict]],
                 resolve_target: Callable[[str], dict],
                 host: str = "127.0.0.1", port: int = 0,
                 monitor=None, name: str = "telemetry"):
        self.registry = registry
        self.list_targets = list_targets
        self.resolve_target = resolve_target
        self.monitor = monitor
        self.name = name
        self.scrapes = 0
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.telemetry = self
        self._thread: Optional[threading.Thread] = None
        registry.add_source(self._self_samples, name=f"{name}:self")

    def _self_samples(self):
        with self._lock:
            n = self.scrapes
        return [MetricSample("telemetry_scrapes_total", float(n),
                             kind="counter",
                             help="HTTP requests served by this telemetry "
                                  "endpoint.")]

    def _count_scrape(self, path: str, status: int):
        with self._lock:
            self.scrapes += 1
        if self.monitor is not None:
            self.monitor.count(self.name, f"scrape:{path.split('/')[1]}")

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        name=f"{self.name}-http",
                                        daemon=True)
        self._thread.start()
        if self.monitor is not None:
            self.monitor.log(self.name, "started", url=self.url)
        return self

    def stop(self, timeout: float = 5.0):
        self._httpd.shutdown()
        self._httpd.server_close()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None

    # -- route handlers (called from handler threads) ----------------------
    def handle(self, path: str):
        """Dispatch one GET; returns (status, content_type, body_bytes)."""
        if path in ("/metrics", "/metrics/"):
            body = self.registry.render()
            return 200, EXPOSITION_CONTENT_TYPE, body.encode()
        if path in ("/healthz", "/healthz/"):
            targets = self.list_targets()
            ok = all(t.get("healthy") for t in targets.values())
            status = 200 if ok else 503
            return status, "application/json", json.dumps(
                {"status": "ok" if ok else "unhealthy",
                 "vres": targets}, indent=2).encode()
        if path in ("/vres", "/vres/"):
            return 200, "application/json", json.dumps(
                self.list_targets(), indent=2).encode()
        if path.startswith("/vre/"):
            parts = [p for p in path.split("/") if p]
            if len(parts) == 3 and parts[2] in ("metrics", "health"):
                name = parts[1]
                try:
                    info = self.resolve_target(name)
                except StaleEndpoint:
                    info = None
                except KeyError:
                    return 404, "application/json", json.dumps(
                        {"error": f"unknown VRE {name!r}"}).encode()
                if parts[2] == "metrics":
                    body = self.registry.render(vre=name)
                    return 200, EXPOSITION_CONTENT_TYPE, body.encode()
                if info is None:     # lease gone mid-move: answer, don't 500
                    info = {"healthy": False, "address": None}
                status = 200 if info.get("healthy") else 503
                return status, "application/json", json.dumps(
                    {"vre": name, **info}, indent=2).encode()
        return 404, "application/json", json.dumps(
            {"error": f"no route {path!r}",
             "routes": ["/metrics", "/healthz", "/vres",
                        "/vre/<name>/metrics", "/vre/<name>/health"]},
            ).encode()


class _Handler(BaseHTTPRequestHandler):
    # scrapes are sub-second request/response pairs; keep-alive would pin
    # handler threads across the scrape interval for nothing
    protocol_version = "HTTP/1.0"

    def do_GET(self):                                   # noqa: N802
        ts: TelemetryServer = self.server.telemetry
        path = self.path.split("?", 1)[0]
        try:
            status, ctype, body = ts.handle(path)
        except Exception as exc:
            # the scrape surface must answer even while the plane it
            # observes is being torn down underneath it
            status, ctype = 500, "application/json"
            body = json.dumps({"error": repr(exc)}).encode()
        ts._count_scrape(path, status)
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):                  # noqa: A003
        pass                        # access logs would drown the Monitor


# ---------------------------------------------------------------------------
# Builders: wire the registry + callbacks for the repo's deployment shapes
# ---------------------------------------------------------------------------
def vre_telemetry(vre, *, port: int = 0, host: str = "127.0.0.1",
                  registry: Optional[MetricsRegistry] = None,
                  slo=None) -> TelemetryServer:
    """Telemetry for a single VRE (``cli serve --telemetry-port``). The
    name resolves through the VRE's own ``EndpointDirectory`` (addresses
    are ``vre://<name>/<svc>@g<N>``), so the lease follows generations."""
    reg = registry or MetricsRegistry()
    reg.register_vre(vre)
    if slo is not None:
        reg.register_slo(slo, vre=vre.config.name)

    def info() -> dict:
        address = None
        try:
            address = vre.endpoints.resolve("lm-server")
        except KeyError:
            pass                    # mid-resize: endpoints withdrawn
        return {"healthy": vre_healthy(vre), "generation": vre.generation,
                "state": vre.state, "address": address}

    def list_targets():
        return {vre.config.name: info()}

    def resolve_target(name: str):
        if name != vre.config.name:
            raise KeyError(name)
        return info()

    return TelemetryServer(reg, list_targets=list_targets,
                           resolve_target=resolve_target, host=host,
                           port=port, monitor=vre.monitor).start()


def fleet_telemetry(arbiter, *, port: int = 0, host: str = "127.0.0.1",
                    registry: Optional[MetricsRegistry] = None
                    ) -> TelemetryServer:
    """Telemetry for a whole fleet (``cli fleet --telemetry-port``): one
    dynamic source walks the arbiter's live VRE table each scrape (tenants
    come and go), and per-VRE routes resolve through the fleet directory's
    TTL leases — ``arbiter.resolve`` refreshes an expired lease against
    the live VRE, so scrapes survive preemption-driven pool swaps."""
    reg = registry or MetricsRegistry()

    def collect():
        out = arbiter_samples(arbiter)
        for vre in arbiter.vres():
            out.extend(vre_samples(vre))
        return out
    reg.add_source(collect, name="fleet")

    def info(vre) -> dict:
        name = vre.config.name
        address = None
        try:
            address = arbiter.resolve(name, "lm-server")
        except KeyError:            # includes StaleEndpoint
            pass
        return {"healthy": vre_healthy(vre), "generation": vre.generation,
                "state": vre.state, "address": address,
                "granted_devices": len(vre.device_pool or ())}

    def list_targets():
        return {v.config.name: info(v) for v in arbiter.vres()}

    def resolve_target(name: str):
        vre = arbiter.vre(name)
        if vre is None:
            raise KeyError(name)
        return info(vre)

    return TelemetryServer(reg, list_targets=list_targets,
                           resolve_target=resolve_target, host=host,
                           port=port, monitor=arbiter.monitor).start()


def replicaset_telemetry(rs_fn, monitor, *, name: str = "lm-server",
                         port: int = 0, host: str = "127.0.0.1",
                         registry: Optional[MetricsRegistry] = None,
                         slo=None) -> TelemetryServer:
    """Telemetry for a bare ReplicaSet (benchmarks / launch scripts with no
    VRE wrapper). ``rs_fn`` may be the pool itself or a callable returning
    the current pool — pass a callable when resizes swap the object."""
    fn = rs_fn if callable(rs_fn) else (lambda: rs_fn)
    reg = registry or MetricsRegistry()
    reg.register_replicaset(fn, vre=name)
    reg.register_monitor(monitor, vre=name)
    if slo is not None:
        reg.register_slo(slo, vre=name)

    def info() -> dict:
        rs = fn()
        return {"healthy": rs is not None and replicaset_healthy(rs),
                "generation": None, "address": None}

    def list_targets():
        return {name: info()}

    def resolve_target(target: str):
        if target != name:
            raise KeyError(target)
        return info()

    return TelemetryServer(reg, list_targets=list_targets,
                           resolve_target=resolve_target, host=host,
                           port=port, monitor=monitor).start()
