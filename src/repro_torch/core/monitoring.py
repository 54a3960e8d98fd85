"""Monitoring platform (EFK-stack analogue): structured event log + in-memory
aggregation + timers. Every service and the scheduler emit events here;
``summarize`` is the "Kibana dashboard" — aggregates by (service, event).

A copy of the JAX package's ``repro.core.monitoring`` (framework-free), kept
in the port so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from pathlib import Path
from typing import Optional


class Monitor:
    def __init__(self, log_path: Optional[str] = None, name: str = "vre",
                 gauge_window: int = 256):
        self.name = name
        self.log_path = Path(log_path) if log_path else None
        if self.log_path:
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._events = []
        self._counters = defaultdict(float)
        self._timings = defaultdict(list)
        self._gauge_window = gauge_window
        self._gauges = defaultdict(lambda: deque(maxlen=gauge_window))
        # cached append handle: one open() per Monitor lifetime, not one per
        # event (opened lazily under the lock; close() releases it)
        self._log_file = None

    def log(self, service: str, event: str, **fields):
        rec = {"t": time.time(), "service": service, "event": event, **fields}
        with self._lock:
            self._events.append(rec)
            self._counters[(service, event)] += 1
            if self.log_path:
                if self._log_file is None:
                    self._log_file = self.log_path.open("a")
                self._log_file.write(json.dumps(rec, default=str) + "\n")
                self._log_file.flush()
        return rec

    def close(self):
        """Release the cached log handle (VRE teardown). Idempotent; a
        ``log`` after close simply reopens the file in append mode."""
        with self._lock:
            if self._log_file is not None:
                self._log_file.close()
                self._log_file = None

    def count(self, service: str, event: str, n: float = 1.0):
        with self._lock:
            self._counters[(service, event)] += n

    @contextmanager
    def timer(self, service: str, event: str, **fields):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._timings[(service, event)].append(dt)
            self.log(service, event + ".done", seconds=dt, **fields)

    # -- rolling-window gauges -------------------------------------------
    def gauge(self, service: str, name: str, value: float):
        """Record a point sample (queue depth, latency, ...) into a rolling
        window; cheap enough for per-decode-step use (no event log write)."""
        with self._lock:
            self._gauges[(service, name)].append(
                (time.monotonic(), float(value)))

    def gauge_stats(self, service: str, name: str,
                    window_s: Optional[float] = None) -> dict:
        """last/mean/p50/p95 over the retained window (optionally only the
        trailing ``window_s`` seconds)."""
        with self._lock:
            pts = list(self._gauges.get((service, name), ()))
        if window_s is not None:
            cutoff = time.monotonic() - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        if not pts:
            return {"n": 0, "last": None, "mean": None, "p50": None,
                    "p95": None}
        vals = sorted(v for _, v in pts)
        n = len(vals)
        return {"n": n, "last": pts[-1][1], "mean": sum(vals) / n,
                "p50": vals[n // 2], "p95": vals[min(n - 1,
                                                     int(0.95 * n))]}

    def gauge_samples(self, service: str, name: str,
                      window_s: Optional[float] = None) -> list:
        """Raw gauge values in the retained (optionally trailing) window —
        the SLO engine needs the distribution (fraction over objective),
        not just the percentiles ``gauge_stats`` precomputes."""
        with self._lock:
            pts = list(self._gauges.get((service, name), ()))
        if window_s is not None:
            cutoff = time.monotonic() - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        return [v for _, v in pts]

    def gauge_last(self, service: str, name: str):
        """Newest sample of a gauge, or None if never recorded — the cheap
        read path for monotonic gauges (prefix-cache hit/miss/eviction
        totals) where the full window stats are overkill."""
        with self._lock:
            pts = self._gauges.get((service, name))
            return pts[-1][1] if pts else None

    def gauges(self) -> dict:
        with self._lock:
            keys = list(self._gauges)
        return {f"{s}/{g}": self.gauge_stats(s, g) for s, g in keys}

    # -- dashboards ------------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            return {f"{s}/{e}": v for (s, e), v in self._counters.items()}

    def timing_summary(self) -> dict:
        out = {}
        with self._lock:
            for (s, e), ts in self._timings.items():
                ts_sorted = sorted(ts)
                out[f"{s}/{e}"] = {
                    "count": len(ts),
                    "total_s": sum(ts),
                    "mean_s": sum(ts) / len(ts),
                    "p50_s": ts_sorted[len(ts) // 2],
                    "max_s": ts_sorted[-1],
                }
        return out

    def events(self, service: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self._events)
        if service:
            evs = [e for e in evs if e["service"] == service]
        return evs

    def summarize(self) -> dict:
        return {"counters": self.counters(), "timings": self.timing_summary(),
                "gauges": self.gauges()}
