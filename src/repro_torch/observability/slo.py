"""SLO engine: declarative latency objectives + rolling error-budget burn.

Self-Scaling Clusters (arXiv:2006.14784) scales on *live telemetry* rather
than raw saturation; this module is that signal for the serving plane. An
``SLOTarget`` declares an objective over a Monitor gauge (TTFT p95, request
latency p95, queue-wait p95); the ``SLOEngine`` pools the gauge windows of
every engine in a ReplicaSet and computes, per target:

  p95         — over the trailing ``window_s``
  error_rate  — fraction of window samples over the objective
  burn_rate   — error_rate / error_budget: >1 means the budget is being
                spent faster than the SLO allows

``burning`` (any target's burn_rate >= the engine's threshold) feeds
``Autoscaler.evaluate`` as a pressure signal *alongside* raw load — the
classic blind spot of load-driven scaling is long requests at low
concurrency: queue depth says "fine" while every queued user waits a full
generation. The max burn rate also rides the resize proposal into
``FleetArbiter.propose_resize`` so arbitration can see how hard a tenant's
budget is burning, not just that it asked.

A copy of the JAX package's ``repro.observability.slo`` (framework-free),
kept in the port so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Iterable, List, Optional


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One objective: ``p95(gauge over window_s) <= objective_s``, with an
    ``error_budget`` fraction of samples allowed over it before the budget
    is considered burning."""
    name: str                    # "ttft_p95"
    gauge: str                   # Monitor gauge, e.g. "ttft_s"
    objective_s: float
    window_s: float = 10.0
    error_budget: float = 0.1

    def validate(self):
        if self.objective_s <= 0:
            raise ValueError(f"{self.name}: objective_s must be > 0")
        if not 0 < self.error_budget <= 1:
            raise ValueError(f"{self.name}: error_budget must be in (0, 1]")
        if self.window_s <= 0:
            raise ValueError(f"{self.name}: window_s must be > 0")


# gauge names the serving engine emits (see ServingEngine._emit_token and
# _admit): the declarative surface maps 1:1 onto them
GAUGE_FOR = {"ttft_p95": "ttft_s", "latency_p95": "latency_s",
             "queue_wait_p95": "queue_wait_s"}


def targets_from_config(cfg: dict) -> List[SLOTarget]:
    """Build targets from a flat config dict (the ``extra['slo']`` format
    and the CLI/bench surface)::

        {"ttft_p95_s": 0.05, "latency_p95_s": 1.0,
         "queue_wait_p95_s": 0.05, "window_s": 10.0, "error_budget": 0.1}

    Only the ``*_p95_s`` keys present become targets."""
    window_s = float(cfg.get("window_s", 10.0))
    budget = float(cfg.get("error_budget", 0.1))
    out = []
    for name, gauge in GAUGE_FOR.items():
        obj = cfg.get(f"{name}_s")
        if obj is None:
            continue
        t = SLOTarget(name, gauge, float(obj), window_s=window_s,
                      error_budget=budget)
        t.validate()
        out.append(t)
    if not out:
        raise ValueError(f"slo config {cfg!r} declares no targets "
                         f"(expected one of "
                         f"{[k + '_s' for k in GAUGE_FOR]})")
    return out


class SLOEngine:
    """Evaluate declarative targets against the live monitoring plane.

    ``services`` names the Monitor services whose gauges to pool — a
    callable (re-resolved every evaluation, so it survives replica churn)
    or a static list. ``evaluate()`` is a pure read of the gauge windows;
    verdicts are cached for ``samples()``/``burn_rate`` readers."""

    def __init__(self, monitor, targets: Iterable[SLOTarget], *,
                 services: Optional[Callable[[], Iterable[str]]] = None,
                 burn_threshold: float = 1.0, name: str = "slo"):
        self.monitor = monitor
        self.targets = list(targets)
        for t in self.targets:
            t.validate()
        if not self.targets:
            raise ValueError("SLOEngine needs at least one target")
        self._services = services or (lambda: ())
        self.burn_threshold = float(burn_threshold)
        self.name = name
        self._lock = threading.Lock()
        self._last: Dict[str, dict] = {}

    def _service_names(self) -> List[str]:
        svcs = self._services
        names = svcs() if callable(svcs) else svcs
        return [getattr(s, "name", s) for s in names]

    # -- evaluation --------------------------------------------------------
    def evaluate(self) -> Dict[str, dict]:
        """Per-target verdicts over the trailing window. A target with no
        samples is vacuously met (burn 0) — an idle system must not read
        as an outage."""
        names = self._service_names()
        out: Dict[str, dict] = {}
        for t in self.targets:
            vals: List[float] = []
            for svc in names:
                vals.extend(self.monitor.gauge_samples(
                    svc, t.gauge, window_s=t.window_s))
            if vals:
                vals.sort()
                p95 = vals[min(len(vals) - 1, int(0.95 * len(vals)))]
                error_rate = sum(v > t.objective_s for v in vals) / len(vals)
            else:
                p95, error_rate = None, 0.0
            burn = error_rate / t.error_budget
            out[t.name] = {
                "objective_s": t.objective_s, "window_s": t.window_s,
                "n": len(vals), "p95_s": p95, "error_rate": error_rate,
                "burn_rate": burn,
                "breach": p95 is not None and p95 > t.objective_s,
                "burning": burn >= self.burn_threshold,
            }
        with self._lock:
            self._last = out
        return out

    @property
    def burn_rate(self) -> float:
        """Max burn rate across targets from a fresh evaluation — the
        scalar pressure signal the autoscaler and arbiter consume."""
        v = self.evaluate()
        return max((t["burn_rate"] for t in v.values()), default=0.0)

    @property
    def burning(self) -> bool:
        v = self.evaluate()
        return any(t["burning"] for t in v.values())

    def verdicts(self) -> Dict[str, dict]:
        """Last evaluation (no fresh read) — the scrape-time view."""
        with self._lock:
            return dict(self._last)

    # -- exposition --------------------------------------------------------
    def samples(self, **labels):
        """SLO state as metric samples for a MetricsRegistry source. Uses a
        fresh evaluation so /metrics reflects *now*, not the last
        autoscaler tick."""
        from repro_torch.observability.metrics import MetricSample
        out = []
        for tname, v in self.evaluate().items():
            lb = {**labels, "target": tname}
            out.append(MetricSample("slo_objective_s", v["objective_s"], lb,
                                    help="Declared SLO objective."))
            if v["p95_s"] is not None:
                out.append(MetricSample("slo_p95_s", v["p95_s"], lb,
                                        help="Observed p95 over the SLO "
                                             "window."))
            out.append(MetricSample("slo_error_rate", v["error_rate"], lb,
                                    help="Fraction of window samples over "
                                         "the objective."))
            out.append(MetricSample("slo_burn_rate", v["burn_rate"], lb,
                                    help="error_rate / error_budget; >1 "
                                         "burns the budget."))
            out.append(MetricSample("slo_burning",
                                    1.0 if v["burning"] else 0.0, lb,
                                    help="1 iff burn_rate >= threshold."))
        return out
