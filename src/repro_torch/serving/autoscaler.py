"""Load-driven autoscaling: replicas within a VRE, mesh resize beyond it.

Paper mapping: on-demand elasticity (§3.1.2) — a VRE procures what it needs
when it needs it. The ``Autoscaler`` closes the loop between the monitoring
plane (rolling-window gauges: queue depth, p95 latency) and the two
elasticity levers the platform has:

  1. within the VRE   — ``ReplicaSet.scale_to`` (more/fewer serving replicas)
  2. beyond the VRE   — ``resize_mesh`` callback (``elastic.resize`` onto a
                        larger device mesh) once the replica pool is at max
                        and still saturated.

``evaluate()`` is a pure decision step (tests drive it synchronously);
``run()`` wraps it in a background control loop.

A copy of the JAX package's ``repro.serving.autoscaler`` (framework-free),
kept in the port so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
import time
from collections import deque
from typing import Callable, Optional


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    # avg outstanding requests per replica that triggers growth / shrink
    scale_up_load: float = 3.0
    scale_down_load: float = 0.5
    # optional latency SLO: p95 above this also triggers growth
    latency_p95_slo_s: Optional[float] = None
    # chunked prefill admits prompts far longer than one admission batch, so
    # request count alone under-states pressure: prompt tokens still waiting
    # for a KV cache (queued + mid-chunking) above this per-replica level
    # also trigger growth. None disables the signal.
    scale_up_prefill_tokens: Optional[float] = None
    # only latency samples from this trailing window count toward the SLO
    # (an all-time p95 would keep a long-idle system "hot" forever)
    latency_window_s: float = 10.0
    cooldown_s: float = 0.0
    interval_s: float = 0.1


class Autoscaler:
    def __init__(self, replicaset, monitor, cfg: AutoscalerConfig,
                 resize_mesh: Optional[Callable[[], None]] = None,
                 slo=None):
        self.rs = replicaset
        self.monitor = monitor
        self.cfg = cfg
        self.resize_mesh = resize_mesh
        # optional repro_torch.observability.slo.SLOEngine: its error-budget
        # burn rate joins raw saturation as a growth trigger — load counts
        # *requests*, the SLO measures *time*, and long generations at low
        # concurrency only show up in the latter
        self.slo = slo
        # resize_mesh callables predate the pressure signal (tests pass bare
        # lambdas): only forward the burn rate to ones that declare it
        self._resize_takes_pressure = False
        if resize_mesh is not None:
            try:
                self._resize_takes_pressure = "pressure" in \
                    inspect.signature(resize_mesh).parameters
            except (TypeError, ValueError):
                pass
        # bounded: a long-lived control loop appends one entry per tick
        self.decisions = deque(maxlen=1024)
        self._resize_requested = False
        self._last_action_t = -float("inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals -----------------------------------------------------------
    def observe(self) -> dict:
        """Publish the current load picture into the monitoring plane and
        return it. Queue-depth gauges come from the engines themselves; p95
        latency comes from the rolling window."""
        n = max(1, self.rs.size)
        load_per_replica = self.rs.load / n
        self.monitor.gauge(self.rs.name, "load_per_replica",
                           load_per_replica)
        self.monitor.gauge(self.rs.name, "replicas", n)
        lat = {}
        backlog = 0
        for e in list(self.rs.engines):
            s = self.monitor.gauge_stats(e.name, "latency_s",
                                         window_s=self.cfg.latency_window_s)
            if s["n"]:
                lat[e.name] = s
            backlog += getattr(e, "prefill_backlog", 0)
        p95 = max((s["p95"] for s in lat.values()), default=None)
        backlog_per_replica = backlog / n
        self.monitor.gauge(self.rs.name, "prefill_backlog_per_replica",
                           backlog_per_replica)
        burn = None
        if self.slo is not None:
            burn = max((v["burn_rate"]
                        for v in self.slo.evaluate().values()), default=0.0)
            self.monitor.gauge(self.rs.name, "slo_burn_rate", burn)
        return {"load_per_replica": load_per_replica, "replicas": n,
                "latency_p95_s": p95,
                "prefill_backlog_per_replica": backlog_per_replica,
                "slo_burn_rate": burn}

    # -- decision ----------------------------------------------------------
    def evaluate(self) -> str:
        """One control step: returns "up" | "down" | "resize" | "hold"."""
        sig = self.observe()
        now = time.monotonic()
        if now - self._last_action_t < self.cfg.cooldown_s:
            return self._record("hold", sig)
        n = sig["replicas"]
        hot = sig["load_per_replica"] > self.cfg.scale_up_load
        slo = self.cfg.latency_p95_slo_s
        if slo is not None and sig["latency_p95_s"] is not None:
            hot = hot or sig["latency_p95_s"] > slo
        if self.cfg.scale_up_prefill_tokens is not None:
            hot = hot or (sig["prefill_backlog_per_replica"]
                          > self.cfg.scale_up_prefill_tokens)
        burn = sig.get("slo_burn_rate")
        if burn is not None:
            # the SLO engine's verdict: burning the error budget is
            # saturation by the user-facing definition, whatever the queue
            # depth says
            hot = hot or burn >= self.slo.burn_threshold
        if hot:
            if n < self.cfg.max_replicas:
                self.rs.scale_to(n + 1)
                self._last_action_t = now
                return self._record("up", sig)
            if self.resize_mesh is not None and not self._resize_requested:
                # fire once per saturation episode — the resize is applied
                # by the driver at a safe point, so re-firing every tick
                # until then would only spam the event log. Under a
                # FleetArbiter the call is a *proposal* that may come back
                # granted, shrunk, or deferred — a deferred proposal is
                # parked with the arbiter (re-evaluated as capacity frees),
                # so it still counts as this episode's request.
                if self._resize_takes_pressure and burn is not None:
                    # ride the burn rate into the arbiter's proposal
                    # protocol: arbitration sees how hard the tenant's
                    # budget is burning, not just that it asked
                    verdict = self.resize_mesh(pressure=burn)
                else:
                    verdict = self.resize_mesh()
                self._resize_requested = True
                self._last_action_t = now
                if isinstance(verdict, dict) and "verdict" in verdict:
                    self.monitor.log(self.rs.name, "resize_proposal",
                                     verdict=verdict["verdict"],
                                     devices=verdict.get("devices"))
                    if verdict["verdict"] == "noop":
                        # quota/max capped: nothing was reserved and
                        # re-proposing every tick can't change the answer
                        # until the claim does — keep the episode burned
                        # (it resets when load drops or on notify_resized)
                        # and report hold, since no resize is coming
                        return self._record("hold", sig)
                return self._record("resize", sig)
            return self._record("hold", sig)
        self._resize_requested = False       # saturation episode over
        if sig["load_per_replica"] < self.cfg.scale_down_load \
                and n > self.cfg.min_replicas:
            self.rs.scale_to(n - 1)
            self._last_action_t = now
            return self._record("down", sig)
        return self._record("hold", sig)

    def notify_resized(self):
        """Driver hook: the pending mesh resize was applied, so the next
        saturation episode may request another one."""
        self._resize_requested = False

    @property
    def scale_events(self) -> int:
        """Number of non-hold decisions taken — soak tests bound this to
        prove the controller doesn't thrash."""
        return sum(1 for d in self.decisions if d != "hold")

    def _record(self, action: str, sig: dict) -> str:
        self.decisions.append(action)
        if action != "hold":
            self.monitor.log(self.rs.name, f"autoscale.{action}", **{
                k: v for k, v in sig.items() if v is not None})
        return action

    # -- control loop ------------------------------------------------------
    def run(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.rs.name}-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.cfg.interval_s):
            self.evaluate()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None
