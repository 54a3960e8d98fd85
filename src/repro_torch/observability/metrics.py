"""Live metrics plane: typed time-series registry + Prometheus exposition.

The flight recorder (``recorder.py``) answers "what happened to request X
yesterday"; this module answers "what is VRE Y doing *right now*". A
``MetricsRegistry`` holds *sources* — callables that snapshot a live object
(``Monitor`` gauges, engine counters, recorder drop counts, ``FleetArbiter``
grants/queue/preemptions) into typed ``MetricSample``s. Every snapshot also
appends into bounded per-series windows, so the registry doubles as an
in-process TSDB for the SLO engine and tests; ``render()`` emits the
Prometheus text exposition format (v0.0.4) for the HTTP surface in
``telemetry.py``.

Sources are resolved *per scrape* and individually fenced: an elastic
resize or fleet preemption tears live objects down mid-flight, and a scrape
racing that must degrade to fewer samples, never to a 500.

A copy of the JAX package's ``repro.observability.metrics``
(framework-free): the same ``repro_*`` metric names and labels, so one
dashboard reads either package. A VRE's ``vre_mesh_devices`` counts the
shares of its pool (``repro_torch.device``), not cards.
"""
from __future__ import annotations

import dataclasses
import math
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

VALID_KINDS = ("gauge", "counter")

# counters whose scrape-to-scrape rate is itself a headline signal; the
# registry derives a ``<name>`` gauge from consecutive snapshots so a bare
# curl shows tok/s without PromQL
RATE_DERIVED = {
    "engine_tokens_total": "decode_tok_per_s",
    "engine_prefill_tokens_total": "prefill_tok_per_s",
}


@dataclasses.dataclass
class MetricSample:
    """One typed point: ``name`` is namespaced at render time."""
    name: str
    value: float
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    kind: str = "gauge"
    help: str = ""

    def key(self) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        return (self.name, tuple(sorted(self.labels.items())))


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class MetricsRegistry:
    """Snapshot live serving/fleet objects into typed time series.

    ``add_source(fn)`` registers a collector; ``snapshot()`` runs them all
    (each fenced), updates the rolling series windows, and derives
    rate-of-counter gauges; ``render()`` emits Prometheus text. Helper
    ``register_*`` methods wrap the repo's live objects; they take the
    *resolver* (a VRE, an arbiter, a callable) rather than a frozen
    ReplicaSet, because elastic resizes replace those objects wholesale.
    """

    def __init__(self, namespace: str = "repro", series_window: int = 256):
        if not _NAME_RE.fullmatch(namespace):
            raise ValueError(f"bad metric namespace {namespace!r}")
        self.namespace = namespace
        self._lock = threading.Lock()
        self._sources: List[Tuple[str, Callable]] = []
        self._series: Dict[tuple, deque] = {}
        self._series_window = series_window
        self._prev_counters: Dict[tuple, Tuple[float, float]] = {}
        self.snapshots = 0
        self.source_errors = 0

    # -- sources -----------------------------------------------------------
    def add_source(self, collect: Callable[[], Iterable[MetricSample]],
                   name: Optional[str] = None):
        with self._lock:
            self._sources.append((name or f"source{len(self._sources)}",
                                  collect))
        return self

    def remove_source(self, name: str):
        with self._lock:
            self._sources = [(n, f) for n, f in self._sources if n != name]

    def register_monitor(self, monitor, **labels):
        return self.add_source(lambda: monitor_samples(monitor, **labels),
                               name=f"monitor:{labels.get('vre', '')}")

    def register_engine(self, engine, **labels):
        return self.add_source(lambda: engine_samples(engine, **labels),
                               name=f"engine:{engine.name}")

    def register_replicaset(self, rs_fn, **labels):
        """``rs_fn``: zero-arg callable returning the *current* ReplicaSet
        (or None while it is being rebuilt)."""
        fn = rs_fn if callable(rs_fn) else (lambda: rs_fn)

        def collect():
            rs = fn()
            return replicaset_samples(rs, **labels) if rs is not None else ()
        return self.add_source(collect, name=f"replicaset:"
                                             f"{labels.get('vre', '')}")

    def register_vre(self, vre):
        return self.add_source(lambda: vre_samples(vre),
                               name=f"vre:{vre.config.name}")

    def register_arbiter(self, arbiter):
        return self.add_source(lambda: arbiter_samples(arbiter),
                               name="arbiter")

    def register_slo(self, slo, **labels):
        return self.add_source(lambda: slo.samples(**labels),
                               name=f"slo:{labels.get('vre', '')}")

    # -- snapshot / series -------------------------------------------------
    def snapshot(self) -> List[MetricSample]:
        """Collect every source (fenced), fold samples into the series
        windows, and append derived rate gauges."""
        with self._lock:
            sources = list(self._sources)
        out: List[MetricSample] = []
        errors = 0
        for name, collect in sources:
            try:
                out.extend(collect())
            except Exception:
                # a source racing a teardown yields nothing, not a 500
                errors = errors + 1
        now = time.monotonic()
        with self._lock:
            self.snapshots += 1
            self.source_errors += errors
            derived: List[MetricSample] = []
            for s in out:
                key = s.key()
                dq = self._series.get(key)
                if dq is None:
                    dq = self._series[key] = deque(
                        maxlen=self._series_window)
                dq.append((now, s.value))
                if s.kind == "counter" and s.name in RATE_DERIVED:
                    prev = self._prev_counters.get(key)
                    self._prev_counters[key] = (now, s.value)
                    if prev is not None and now > prev[0]:
                        rate = max(0.0, (s.value - prev[1]) /
                                   (now - prev[0]))
                        derived.append(MetricSample(
                            RATE_DERIVED[s.name], rate, dict(s.labels),
                            help=f"Scrape-to-scrape rate of "
                                 f"{self.namespace}_{s.name}."))
            out.extend(derived)
            out.append(MetricSample(
                "telemetry_snapshots_total", float(self.snapshots),
                kind="counter", help="Registry snapshots taken."))
            out.append(MetricSample(
                "telemetry_source_errors_total", float(self.source_errors),
                kind="counter",
                help="Collector failures (scrapes racing teardowns)."))
        return out

    def series(self, name: str, **labels) -> List[Tuple[float, float]]:
        """Retained ``(monotonic_t, value)`` window for one series."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return list(self._series.get(key, ()))

    # -- exposition --------------------------------------------------------
    def render(self, samples: Optional[List[MetricSample]] = None,
               vre: Optional[str] = None) -> str:
        """Prometheus text exposition of a fresh (or given) snapshot,
        optionally filtered to one VRE's samples."""
        if samples is None:
            samples = self.snapshot()
        if vre is not None:
            samples = [s for s in samples if s.labels.get("vre") == vre]
        return render_exposition(samples, namespace=self.namespace)


def render_exposition(samples: Iterable[MetricSample],
                      namespace: str = "repro") -> str:
    """Prometheus text format v0.0.4: per metric name one HELP/TYPE header,
    then its samples. Duplicate (name, labels) keep last — scrapers reject
    duplicated series."""
    by_name: Dict[str, Dict[tuple, MetricSample]] = {}
    order: List[str] = []
    for s in samples:
        if not _NAME_RE.fullmatch(s.name):
            raise ValueError(f"bad metric name {s.name!r}")
        if s.kind not in VALID_KINDS:
            raise ValueError(f"bad metric kind {s.kind!r} for {s.name}")
        if s.name not in by_name:
            by_name[s.name] = {}
            order.append(s.name)
        by_name[s.name][s.key()] = s
    lines: List[str] = []
    for name in order:
        group = list(by_name[name].values())
        full = f"{namespace}_{name}"
        help_text = next((s.help for s in group if s.help), "")
        if help_text:
            lines.append(f"# HELP {full} {_esc(help_text)}")
        lines.append(f"# TYPE {full} {group[0].kind}")
        for s in group:
            if s.labels:
                lbl = ",".join(f'{k}="{_esc(v)}"'
                               for k, v in sorted(s.labels.items()))
                lines.append(f"{full}{{{lbl}}} {_fmt(s.value)}")
            else:
                lines.append(f"{full} {_fmt(s.value)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" (NaN|[+-]?Inf|[+-]?[0-9.eE+-]+)( [0-9]+)?$")


def validate_exposition(text: str) -> List[str]:
    """Well-formedness check for Prometheus text exposition (used by the
    bench lane and CI scrape): returns a list of error strings, empty when
    the payload parses. Checks sample-line syntax, float-parseable values,
    valid TYPE declarations, no duplicate TYPE lines, and that typed
    metrics declare their TYPE before the first sample."""
    errors: List[str] = []
    typed: Dict[str, str] = {}
    sampled = set()
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                errors.append(f"line {i}: malformed TYPE: {line!r}")
                continue
            name = parts[2]
            if name in typed:
                errors.append(f"line {i}: duplicate TYPE for {name}")
            if name in sampled:
                errors.append(f"line {i}: TYPE after samples of {name}")
            typed[name] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {i}: malformed sample: {line!r}")
            continue
        name = m.group(1)
        sampled.add(name)
        val = m.group(4)
        if val not in ("NaN", "+Inf", "-Inf", "Inf"):
            try:
                float(val)
            except ValueError:
                errors.append(f"line {i}: bad value {val!r}")
    return errors


# ---------------------------------------------------------------------------
# Collectors over the repo's live objects
# ---------------------------------------------------------------------------
def monitor_samples(monitor, **labels) -> List[MetricSample]:
    """Every Monitor gauge window as last/mean/p50/p95 samples, plus event
    counters — the whole monitoring plane, one scrape."""
    out: List[MetricSample] = []
    for key, stats in monitor.gauges().items():
        svc, _, gname = key.partition("/")
        for stat in ("last", "mean", "p50", "p95"):
            v = stats.get(stat)
            if v is None:
                continue
            out.append(MetricSample(
                "monitor_gauge", float(v),
                {**labels, "service": svc, "gauge": gname, "stat": stat},
                help="Rolling-window Monitor gauge statistic."))
    for key, v in monitor.counters().items():
        svc, _, ev = key.partition("/")
        out.append(MetricSample(
            "monitor_events_total", float(v),
            {**labels, "service": svc, "event": ev}, kind="counter",
            help="Monitor event counters by (service, event)."))
    return out


def _counter_block(counters: dict, labels: dict) -> List[MetricSample]:
    return [MetricSample(f"engine_{k}_total", float(v), dict(labels),
                         kind="counter",
                         help="Aggregate engine counter (incl. retired "
                              "replicas).")
            for k, v in sorted(counters.items())]


def engine_samples(engine, **labels) -> List[MetricSample]:
    """One bare ServingEngine (no ReplicaSet): counters + live state."""
    lb = {**labels, "replica": engine.name}
    out = _counter_block(dict(engine.metrics), lb)
    out.append(MetricSample("queue_depth", float(engine.load), lb,
                            help="Queued + in-slot requests."))
    out.append(MetricSample("prefill_backlog",
                            float(getattr(engine, "prefill_backlog", 0)), lb,
                            help="Prompt tokens still waiting for KV cache."))
    out.append(MetricSample("replica_healthy",
                            1.0 if engine.healthy() else 0.0, lb,
                            help="1 iff the decode loop can make progress."))
    return out


def replicaset_samples(rs, **labels) -> List[MetricSample]:
    """Pool-level serving metrics: aggregate engine counters (tok/s via the
    registry's derived rates), spec accept, prefix hits, prefill backlog,
    health, and recorder loss."""
    m = rs.metrics()
    out = _counter_block(m.get("total", {}), labels)
    engines = list(getattr(rs, "engines", ()))
    healthy = sum(1 for e in engines if e.healthy())
    out.append(MetricSample("replicas", float(m.get("replicas", 0)), labels,
                            help="Live serving replicas."))
    out.append(MetricSample("replicas_healthy", float(healthy), labels,
                            help="Replicas whose decode loop is alive."))
    for k in ("failovers", "rebalances"):
        out.append(MetricSample(f"{k}_total", float(m.get(k, 0)), labels,
                                kind="counter",
                                help=f"ReplicaSet {k}."))
    out.append(MetricSample("queue_depth", float(rs.load), labels,
                            help="Queued + in-slot requests, all replicas."))
    out.append(MetricSample(
        "prefill_backlog",
        float(sum(getattr(e, "prefill_backlog", 0) for e in engines)),
        labels, help="Prompt tokens still waiting for KV cache."))
    spec = m.get("speculative")
    if spec:
        out.append(MetricSample("spec_accept_rate",
                                float(spec["accept_rate"]), labels,
                                help="Accepted / proposed draft tokens."))
        out.append(MetricSample("spec_tokens_per_step",
                                float(spec["tokens_per_step"]), labels,
                                help="Emitted tokens per verify step."))
    pc = m.get("prefix_cache")
    if isinstance(pc, dict):
        for k, v in pc.items():
            if isinstance(v, (int, float)):
                out.append(MetricSample(f"prefix_cache_{k}", float(v),
                                        labels,
                                        help="Prefix-cache statistic."))
    rec = getattr(rs, "recorder", None)
    if rec is not None:
        out.append(MetricSample("recorder_written_total",
                                float(rec.written), labels, kind="counter",
                                help="Flight-recorder records persisted."))
        out.append(MetricSample("recorder_dropped_total", float(rec.drops),
                                labels, kind="counter",
                                help="Records lost to queue overflow — "
                                     "silent record loss if nonzero."))
    return out


def vre_samples(vre) -> List[MetricSample]:
    """One VRE: state/generation/grant plus its serving pool and monitor.
    Resolves the ReplicaSet through the *live* service table each scrape,
    so the source survives elastic re-instantiation."""
    name = vre.config.name
    lb = {"vre": name}
    out = [
        MetricSample("vre_up", 1.0 if vre.state == "RUNNING" else 0.0, lb,
                     help="1 iff the VRE is RUNNING."),
        MetricSample("vre_generation", float(vre.generation), lb,
                     help="Placement epoch (bumps per re-instantiation)."),
        MetricSample("vre_mesh_devices",
                     float(len(vre.device_pool)) if vre.device_pool
                     else float(_mesh_size(vre)), lb,
                     help="Devices granted / in the mesh."),
    ]
    if vre.state == "RUNNING":
        svc = vre.services.get("lm-server")
        rs = getattr(getattr(svc, "instance", None), "replicaset", None)
        if rs is not None:
            out.extend(replicaset_samples(rs, **lb))
    out.extend(monitor_samples(vre.monitor, **lb))
    return out


def _mesh_size(vre) -> int:
    try:
        import numpy as np
        return int(np.prod(vre.config.mesh_shape))
    except Exception:
        return 0


def arbiter_samples(arbiter) -> List[MetricSample]:
    """Fleet state: pool/free devices, per-VRE grants, admission queue
    depth, admission/preemption counters, queue-wait."""
    st = arbiter.status()
    out = [
        MetricSample("fleet_pool_devices", float(st["pool_devices"]),
                     help="Devices in the shared pool."),
        MetricSample("fleet_free_devices", float(st["free_devices"]),
                     help="Ungranted devices."),
        MetricSample("fleet_queue_depth", float(len(st["queued"])),
                     help="VREs waiting for admission."),
        MetricSample("fleet_deferred_proposals",
                     float(len(st["deferred"])),
                     help="Resize proposals parked until capacity frees."),
        MetricSample("fleet_admissions_total", float(st["admissions"]),
                     kind="counter", help="VREs admitted."),
        MetricSample("fleet_preemptions_total", float(st["preemptions"]),
                     kind="counter",
                     help="Grant shrinks forced on lower-priority VREs."),
    ]
    for name, n in st["grants"].items():
        out.append(MetricSample("fleet_grant_devices", float(n),
                                {"vre": name},
                                help="Devices granted to this VRE."))
    for name, w in st["queue_wait_s"].items():
        out.append(MetricSample("fleet_queue_wait_s", float(w),
                                {"vre": name},
                                help="Admission queue wait."))
    for name, info in st["vres"].items():
        out.append(MetricSample(
            "fleet_vre_pending_resize",
            1.0 if info["pending_resize"] else 0.0, {"vre": name},
            help="1 while a reserved grant awaits apply_pending."))
    return out
