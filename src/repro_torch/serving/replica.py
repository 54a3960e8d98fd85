"""Lifecycle-managed serving replicas with health-based rescheduling, ported
from the JAX package's ``repro.serving.replica``.

Paper mapping (§3.1.2): the orchestrator keeps a declared number of service
replicas alive, watches container health, and reschedules work off failed
containers. ``ReplicaSet`` does exactly that for ``ServingEngine`` replicas:
each engine runs its decode loop on a background thread and publishes a
heartbeat; a monitor thread detects dead/stale replicas, strips their
incomplete requests, re-queues them onto healthy replicas, and (optionally)
spawns a replacement — greedy decode is deterministic, so rescheduled
requests produce identical tokens.

The device pool is a list of ``DeviceShare``s (``repro_torch.device``): one
per visible card, or several shares of one card. The pool holds the shared
prefix cache and the flight recorder (its engines get both through the
factory); ``stop()`` stops the recorder, which flushes its queue. The
elastic half (``rebalance``, ``detach_requests``, ``adopt``,
``adopt_prefix_cache``) carries incomplete requests, whose futures stay
attached, and the prefix cache to a re-placed or successor pool.
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Callable, List, Optional, Sequence

from repro_torch.serving.engine import Request, ServingEngine


def partition_devices(devices: Sequence, n: int) -> List[tuple]:
    """Split a device list into ``n`` per-replica slices. When the pool has
    at least ``n`` devices the slices are disjoint contiguous blocks (the
    remainder devices go to the first slices); when replicas oversubscribe
    the pool, devices are reused round-robin."""
    devices = list(devices)
    d = len(devices)
    if d == 0:
        return [tuple()] * n
    if n <= d:
        base, rem = divmod(d, n)
        out, i = [], 0
        for j in range(n):
            k = base + (1 if j < rem else 0)
            out.append(tuple(devices[i:i + k]))
            i += k
        return out
    return [(devices[j % d],) for j in range(n)]


class ReplicaSet:
    """A self-healing, scalable pool of ServingEngine replicas.

    ``factory(i, devices)`` builds replica ``i`` on a slice of the device
    pool; the pool is partitioned so replicas occupy disjoint devices while
    there are enough."""

    heartbeat_timeout = 30.0    # s without a heartbeat, with work: dead
    check_interval = 0.05       # s between health sweeps

    def __init__(self, factory: Callable[[int, tuple], ServingEngine],
                 replicas: int = 2, *, name: str = "lm-server",
                 monitor=None, respawn: bool = False,
                 devices: Sequence = (), prefix_cache=None,
                 recorder=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.factory = factory
        self.name = name
        self.monitor = monitor
        # the cross-replica prefix cache the engines share (they get it
        # through the factory); held here for its stats
        self.prefix_cache = prefix_cache
        # the flight recorder every engine writes to; held here so stop()
        # flushes it and serve_report can reach it through the pool
        self.recorder = recorder
        self.respawn = respawn
        self._device_pool = list(devices)
        self._lock = threading.RLock()
        slices = partition_devices(self._device_pool, replicas)
        self.engines: List[ServingEngine] = [
            self.factory(i, slices[i]) for i in range(replicas)]
        self._next_id = replicas
        self._failovers = 0
        self._rebalances = 0
        self._rebalancing = False
        self._retired_metrics: dict = {}   # name -> final counters of
                                           # replicas removed from the pool
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._started = False

    # -- placement ---------------------------------------------------------
    def _next_devices(self) -> tuple:
        """Slice for an incrementally added replica (scale-up / respawn):
        the pool device with the fewest replicas already assigned to it."""
        if not self._device_pool:
            return ()
        counts = {d: 0 for d in self._device_pool}
        with self._lock:
            for e in self.engines:
                for d in e.devices:
                    if d in counts:
                        counts[d] += 1
        return (min(self._device_pool, key=lambda d: counts[d]),)

    def placements(self) -> dict:
        """name -> tuple of devices each replica occupies."""
        with self._lock:
            return {e.name: tuple(e.devices) for e in self.engines}

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._lock:
            if self._started:
                return self
            self._started = True
            for e in self.engines:
                e.start()
        self._health_stop.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, name=f"{self.name}-health", daemon=True)
        self._health_thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        self._health_stop.set()
        t = self._health_thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._health_thread = None
        with self._lock:
            engines = list(self.engines)
            self._started = False
        for e in engines:
            stopped = e.stop(timeout)
            # a stopped pool runs no decode loops: fail still-pending
            # futures instead of leaving their waiters blocked forever
            if stopped:
                for r in e.harvest_requests():
                    if not r.future.done():
                        r.future.set_exception(
                            RuntimeError(f"{self.name} stopped with the "
                                         f"request still pending"))
            else:
                # decode thread stuck: active slots may still complete, but
                # queued requests never will — fail those now
                while True:
                    try:
                        r = e.queue.get_nowait()
                    except queue_mod.Empty:
                        break
                    if not r.future.done():
                        r.future.set_exception(
                            RuntimeError(f"{self.name} stopped with the "
                                         f"request still queued"))
        if self.recorder is not None:
            self.recorder.stop()        # idempotent; flushes queued records

    # -- dispatch ----------------------------------------------------------
    def healthy_engines(self) -> List[ServingEngine]:
        with self._lock:
            return [e for e in self.engines if e.healthy()]

    def submit_request(self, tokens, **kw) -> Request:
        # choose AND enqueue under the lock: failover harvests a dead
        # engine's queue under the same lock, so a request can never land on
        # an engine after its final harvest (it would be lost forever)
        with self._lock:
            pool = [e for e in self.engines if e.healthy()]
            if not pool:
                raise RuntimeError(f"{self.name}: no healthy replicas")
            eng = min(pool, key=lambda e: e.load)
            return eng.submit_request(tokens, **kw)

    def submit(self, tokens, **kw):
        return self.submit_request(tokens, **kw).future

    # -- health / rescheduling --------------------------------------------
    def _health_loop(self):
        while not self._health_stop.wait(self.check_interval):
            try:
                self.check_once()
            except Exception as exc:     # the sweep must outlive any replica
                if self.monitor is not None:
                    self.monitor.log(self.name, "health_sweep_error",
                                     error=repr(exc))

    def check_once(self) -> int:
        """One health sweep; returns the number of failovers performed."""
        now = time.monotonic()
        dead = []
        with self._lock:
            if not self._started or self._rebalancing:
                return 0
            for e in self.engines:
                stale = e.load > 0 and \
                    (now - e.heartbeat) > self.heartbeat_timeout
                if not e.healthy() or (not e.running and e.load > 0) or stale:
                    dead.append(e)
        for e in dead:
            self.failover(e)
        return len(dead)

    def failover(self, engine: ServingEngine, max_retries: int = 3):
        """Reschedule everything off a failed replica (paper: container
        rescheduling). The dead engine is removed from the pool; its
        incomplete requests restart from the prompt on healthy replicas."""
        if not engine.stop():
            return          # decode thread still running: harvesting now
                            # would race it; retry next sweep
        with self._lock:
            if engine not in self.engines:
                return
            self.engines.remove(engine)
            self._retired_metrics[engine.name] = dict(engine.metrics)
            self._failovers += 1
            if self.respawn or not self.engines:
                fresh = self.factory(self._next_id, self._next_devices())
                self._next_id += 1
                if self._started:
                    fresh.start()
                self.engines.append(fresh)
            requeued = engine.harvest_requests()
        kept = []
        for r in requeued:
            r.trace.event("failover", replica=engine.name)
            if r.retries > max_retries:     # poisoned request: stop bouncing
                r.future.set_exception(RuntimeError(
                    f"request failed over {r.retries} times"))
            else:
                kept.append(r)
        self._requeue(kept, "failover")
        if self.monitor is not None:
            self.monitor.log(self.name, "failover", replica=engine.name,
                             requeued=len(requeued))

    def _requeue(self, requests, why: str):
        for r in requests:
            with self._lock:
                pool = [e for e in self.engines if e.healthy()]
                if not pool:
                    r.future.set_exception(RuntimeError(
                        f"no healthy replicas for {why}"))
                    continue
                eng = min(pool, key=lambda e: e.load)
                r.trace.event("requeued", why=why, to=eng.name)
                eng.queue.put(r)
                eng.metrics["requests"] += 1
                eng._wake.set()

    # -- elasticity --------------------------------------------------------
    def scale_to(self, n: int) -> int:
        """Grow/shrink the pool to ``n`` replicas. Shrinking picks the
        least-loaded replicas, drains their work back onto the pool."""
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        removed: List[ServingEngine] = []
        added = 0
        with self._lock:
            while len(self.engines) < n:
                e = self.factory(self._next_id, self._next_devices())
                self._next_id += 1
                if self._started:
                    e.start()
                self.engines.append(e)
                added += 1
            if len(self.engines) > n:
                by_load = sorted(self.engines, key=lambda e: e.load)
                removed = by_load[:len(self.engines) - n]
                self.engines = [e for e in self.engines
                                if e not in removed]
        for e in removed:
            # harvest only once the loop has exited; on a stop timeout put
            # the engine back — its _stop flag is set, so the health sweep
            # retries the removal via failover
            if e.stop(timeout=60.0):
                with self._lock:
                    self._retired_metrics[e.name] = dict(e.metrics)
                self._requeue(e.harvest_requests(), "scale-down")
            else:
                with self._lock:
                    self.engines.append(e)
        if self.monitor is not None and (removed or added):
            self.monitor.log(self.name, "scaled", replicas=len(self.engines))
        return len(self.engines)

    def rebalance(self, mesh=None, *, replicas: Optional[int] = None,
                  timeout: float = 60.0) -> dict:
        """Re-place the whole pool onto (a possibly new) mesh: drain the
        engines, harvest their incomplete requests, partition the device
        pool into fresh per-replica slices, respawn, resume, and re-queue
        the harvested work. Greedy decode is deterministic, so requests
        carried across the rebalance produce identical tokens. Returns
        ``{"downtime_s", "requeued", "replicas"}``."""
        t0 = time.monotonic()
        with self._lock:
            self._rebalancing = True       # health sweep must not failover
            if mesh is not None:           # engines we are mid-harvesting
                self._device_pool = list(mesh.devices.flat)
            n = replicas if replicas is not None else len(self.engines)
            old = list(self.engines)
        requeued: List[Request] = []
        stuck: List[ServingEngine] = []
        try:
            for e in old:
                if e.stop(timeout):
                    requeued.extend(e.harvest_requests())
                    with self._lock:
                        self._retired_metrics[e.name] = dict(e.metrics)
                else:
                    # decode thread still running: keep the engine in the
                    # pool; its _stop flag is set, so the health sweep
                    # retires it via failover once it exits
                    stuck.append(e)
            # drop the retired engines, and with them their KV caches,
            # before the fresh ones allocate theirs on the same devices
            old = e = None
            with self._lock:
                self.engines = list(stuck)
                slices = partition_devices(self._device_pool, n)
                fresh = []
                for j in range(n):
                    eng = self.factory(self._next_id, slices[j])
                    self._next_id += 1
                    if self._started:
                        eng.start()
                    fresh.append(eng)
                self.engines = fresh + stuck
                self._rebalances += 1
        finally:
            with self._lock:
                self._rebalancing = False
        self._requeue(requeued, "rebalance")
        downtime = time.monotonic() - t0
        if self.monitor is not None:
            self.monitor.log(self.name, "rebalanced", replicas=n,
                             devices=len(self._device_pool),
                             requeued=len(requeued), downtime_s=downtime)
        return {"downtime_s": downtime, "requeued": len(requeued),
                "replicas": n}

    def detach_requests(self, timeout: float = 60.0) -> List[Request]:
        """Stop the pool *without* failing pending futures and return every
        incomplete request (elastic mesh resize: the successor pool adopts
        them, so waiters span the resize transparently)."""
        self._health_stop.set()
        t = self._health_thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._health_thread = None
        with self._lock:
            engines = list(self.engines)
            self._started = False
        out: List[Request] = []
        for e in engines:
            if e.stop(timeout):
                out.extend(e.harvest_requests())
                continue
            # decode thread stuck and the engine is about to be discarded:
            # the thread-safe queue can still be carried; active-slot
            # requests can't be harvested safely, so fail their futures now
            # (future.set_* is thread-safe, and the dying loop guards
            # against already-done futures)
            while True:
                try:
                    r = e.queue.get_nowait()
                except queue_mod.Empty:
                    break
                r.reset_for_retry()
                out.append(r)
            for r in list(e.active):
                if r is not None and not r.future.done():
                    r.future.set_exception(RuntimeError(
                        f"{e.name} unresponsive during detach with the "
                        f"request in flight"))
        for r in out:
            r.trace.event("detached", pool=self.name)
        return out

    def adopt(self, requests: List[Request], why: str = "resize"):
        """Accept requests harvested off a predecessor pool (their futures
        stay attached, so original waiters see the results)."""
        requests = list(requests)
        for r in requests:
            r.trace.event("adopted", pool=self.name)
        self._requeue(requests, why)

    def adopt_prefix_cache(self, predecessor) -> int:
        """Carry a predecessor pool's prefix-cache entries into this pool's
        cache (elastic resize: the successor adopts). Entries are host CPU
        tensors, so they stay valid across the placement change;
        incompatible chunking (or a successor without a cache) drops them
        coherently. Returns the number of entries carried."""
        if self.prefix_cache is None or predecessor is None:
            return 0
        n = self.prefix_cache.adopt_entries(predecessor)
        if self.monitor is not None and n:
            self.monitor.log(self.name, "prefix_cache_adopted", entries=n)
        return n

    # -- introspection -----------------------------------------------------
    @property
    def load(self) -> int:
        with self._lock:
            return sum(e.load for e in self.engines)

    @property
    def size(self) -> int:
        with self._lock:
            return len(self.engines)

    def wait_all(self, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.load == 0:
                return True
            time.sleep(0.005)
        return False

    def metrics(self) -> dict:
        with self._lock:
            per = {e.name: dict(e.metrics) for e in self.engines}
            retired = {n: dict(m) for n, m in self._retired_metrics.items()}
        agg = {}
        # totals include retired replicas' final counters — work done before
        # a failover must not vanish from the aggregate
        for m in list(per.values()) + list(retired.values()):
            for k, v in m.items():
                agg[k] = agg.get(k, 0) + v
        out = {"replicas": len(per), "failovers": self._failovers,
               "rebalances": self._rebalances,
               "per_replica": per, "retired": retired, "total": agg}
        if agg.get("spec_steps"):
            # pool-level speculative summary (counters already aggregate
            # retired replicas, so failover mid-speculation keeps its work)
            out["speculative"] = {
                "steps": agg["spec_steps"],
                "accept_rate": (agg["spec_accepted"] / agg["spec_proposed"]
                                if agg.get("spec_proposed") else 0.0),
                "tokens_per_step": agg["spec_emitted"] / agg["spec_steps"],
            }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out
