"""Fleet arbiter: multi-VRE scheduling over one shared device pool.

The paper's orchestrator serves *many* communities of practice at once
(§3.1.2, §4.1): VREs come and go on demand, and something has to arbitrate
who holds which slice of the shared cloud when. ``FleetArbiter`` is that
something for this repo's device substrate:

  admission   — a VRE registers a ``ResourceClaim`` (min/max devices,
                priority, quota); it is instantiated immediately when its
                mesh fits in the free pool, queued (priority-ordered FIFO)
                otherwise, and admitted as capacity frees up.
  grants      — every admitted VRE owns a *disjoint* slice of the pool
                (``vre.device_pool``); its mesh is procured from the grant,
                never from the raw provider list.
  proposals   — ``Autoscaler``/VRE resize requests route here instead of
                being recorded unilaterally: the arbiter can grant them in
                full, grant a *shrunken* shape against competing claims,
                grant by *preempting* lower-priority VREs down toward their
                claim minimum, or defer them until capacity frees.
  application — decided grants are applied at a safe point by
                ``apply_pending`` through ``elastic.resize_serving`` —
                shrinks first (freeing devices), then growths — so
                in-flight requests survive preemption (drain/adopt).
  directory   — a fleet-level ``EndpointDirectory`` with TTL leases maps
                ``"<vre>/<service>"`` to generation-tagged addresses; an
                expired lease re-resolves against the live VRE, so clients
                see replica moves within one TTL.
  prefix reuse— VREs serving the same (arch, chunk) share one
                ``PrefixCache``: one community's prefill warms another's
                (scientific pipelines share prompt heads across tenants).

A port of the JAX package's ``repro.fleet.arbiter``. The default pool is
``device_pool("h100")``: one ``DeviceShare`` per visible card, or more
shares of each when asked (``repro_torch.device``); grants are keyed on the
shares, so two tenants on one card hold disjoint grants.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.monitoring import Monitor
from repro_torch.core.registry import EndpointDirectory
from repro_torch.device import device_pool


@dataclasses.dataclass
class ResourceClaim:
    """What a VRE asks of the shared pool. ``min_devices`` is the floor the
    arbiter never preempts below; ``max_devices`` caps growth proposals;
    ``quota_devices`` is the tenant's hard entitlement (defaults to
    ``max_devices``) — a community's burst headroom can exceed its steady
    max only by raising the quota, never silently."""
    min_devices: int = 1
    max_devices: int = 8
    priority: int = 0                       # higher preempts lower
    quota_devices: Optional[int] = None

    @property
    def cap(self) -> int:
        q = self.quota_devices if self.quota_devices is not None \
            else self.max_devices
        return min(self.max_devices, q)

    def validate(self):
        if self.min_devices < 1:
            raise ValueError("claim.min_devices must be >= 1")
        if self.max_devices < self.min_devices:
            raise ValueError("claim.max_devices < claim.min_devices")
        if self.quota_devices is not None \
                and self.quota_devices < self.min_devices:
            raise ValueError("claim.quota_devices < claim.min_devices")


@dataclasses.dataclass
class _Queued:
    config: object
    claim: ResourceClaim
    submit_t: float
    order: int


class FleetArbiter:
    """Admission, grants, and arbitrated elasticity for a fleet of VREs
    sharing one device pool.

    ``devices`` may be ``DeviceShare``s (production) or any hashable tokens
    (scheduling-logic tests) — the arbiter never touches them beyond
    identity. ``vre_factory(config)`` builds the VRE object on admission
    (overridable for stubs); the default builds a real
    ``VirtualResearchEnvironment`` with the builtin service registry.
    """

    def __init__(self, devices: Optional[Sequence] = None, monitor=None,
                 endpoint_ttl_s: Optional[float] = None, vre_factory=None,
                 share_prefix_caches: bool = True):
        if devices is None:
            devices = device_pool("h100")
        self.pool = list(devices)
        self.monitor = monitor or Monitor(name="fleet")
        self.directory = EndpointDirectory(default_ttl_s=endpoint_ttl_s)
        self.directory.set_refresher(self._refresh_endpoint)
        self.share_prefix_caches = share_prefix_caches
        self._vre_factory = vre_factory or self._default_factory
        self._lock = threading.RLock()
        self._vres: Dict[str, object] = {}
        self._claims: Dict[str, ResourceClaim] = {}
        self._grants: Dict[str, List] = {}      # name -> disjoint device slice
        # devices a VRE's *live mesh* currently sits on: a reserved shrink
        # moves devices out of the grant immediately (so proposals can't
        # double-book them) but they stay occupied until apply_pending
        # physically moves the victim — admission must respect occupancy,
        # not just grants, or a new tenant would instantiate on hardware a
        # draining tenant still runs on
        self._occupied: Dict[str, List] = {}
        self._queue: List[_Queued] = []
        self._deferred: Dict[str, tuple] = {}   # name -> wanted mesh shape
        self._queue_wait_s: Dict[str, float] = {}
        # last SLO burn-rate each tenant reported with a proposal: deferred
        # re-evaluation tiebreaker + telemetry surface
        self._pressure: Dict[str, float] = {}
        self._prefix_caches: Dict[tuple, object] = {}
        self._order = 0
        self.admissions = 0
        self.preemptions = 0
        self._ticker_stop = threading.Event()
        self._ticker: Optional[threading.Thread] = None

    # -- plumbing ----------------------------------------------------------
    @staticmethod
    def _default_factory(config):
        import repro_torch.core.services  # noqa: F401  (registers builtins)
        from repro_torch.core.vre import VirtualResearchEnvironment
        return VirtualResearchEnvironment(config)

    def _free(self) -> List:
        used = set()
        for g in self._grants.values():
            used.update(g)
        return [d for d in self.pool if d not in used]

    def _physically_free(self) -> List:
        used = set()
        for g in self._grants.values():
            used.update(g)
        for g in self._occupied.values():
            used.update(g)
        return [d for d in self.pool if d not in used]

    @staticmethod
    def _unit(shape: tuple) -> int:
        """Devices per step of the resizable (leading) mesh axis."""
        return int(np.prod(shape[1:])) if len(shape) > 1 else 1

    @staticmethod
    def _shape_for(n: int, like: tuple) -> tuple:
        unit = FleetArbiter._unit(like)
        assert n % unit == 0, (n, like)
        return (n // unit, *like[1:])

    def vre(self, name: str):
        with self._lock:
            return self._vres.get(name)

    def vres(self) -> List:
        """Live admitted VREs (snapshot) — the telemetry plane walks this
        per scrape, so tenants appear/disappear from /metrics with
        admission and release."""
        with self._lock:
            return list(self._vres.values())

    def cap_shape(self, name: str) -> tuple:
        """The largest mesh shape ``name``'s claim allows — the natural
        growth-proposal target for a saturated VRE."""
        with self._lock:
            claim = self._claims[name]
            shape = self._vres[name].config.mesh_shape
        unit = self._unit(shape)
        return self._shape_for(max(unit, (claim.cap // unit) * unit), shape)

    # -- admission ---------------------------------------------------------
    def submit(self, config, claim: ResourceClaim) -> dict:
        """Register a claim and instantiate the VRE when its mesh fits the
        free pool; queue it otherwise. Admission is FIFO within priority —
        a fitting low-priority VRE does not jump a queued high-priority one.
        Returns ``{"status": "admitted", "vre": ...}`` or
        ``{"status": "queued", "position": ...}``."""
        claim.validate()
        n0 = int(np.prod(config.mesh_shape))
        if not claim.min_devices <= n0 <= claim.cap:
            raise ValueError(
                f"mesh {tuple(config.mesh_shape)} wants {n0} devices, "
                f"outside claim [{claim.min_devices}, {claim.cap}]")
        if n0 > len(self.pool):
            raise ValueError(f"mesh wants {n0} devices; pool has "
                             f"{len(self.pool)} — unsatisfiable claim")
        with self._lock:
            if config.name in self._vres or any(
                    q.config.name == config.name for q in self._queue):
                raise ValueError(f"VRE {config.name!r} already in the fleet")
            blocked = any(q.claim.priority >= claim.priority
                          for q in self._queue)
            if not blocked and n0 <= len(self._physically_free()):
                vre = self._admit_locked(config, claim, queue_wait_s=0.0)
                return {"status": "admitted", "vre": vre}
            ent = _Queued(config, claim, time.monotonic(), self._order)
            self._order += 1
            self._queue.append(ent)
            self._queue.sort(key=lambda q: (-q.claim.priority, q.order))
            pos = self._queue.index(ent)
            self.monitor.log("fleet", "queued", vre=config.name,
                             devices=n0, position=pos)
            return {"status": "queued", "position": pos}

    def _admit_locked(self, config, claim, queue_wait_s: float):
        n0 = int(np.prod(config.mesh_shape))
        grant = self._physically_free()[:n0]
        assert len(grant) == n0, (config.name, n0, len(grant))
        if self.share_prefix_caches:
            self._inject_shared_prefix_cache(config)
        vre = self._vre_factory(config)
        vre.arbiter = self
        vre.claim = claim
        vre.device_pool = list(grant)
        self._vres[config.name] = vre
        self._claims[config.name] = claim
        self._grants[config.name] = list(grant)
        self._occupied[config.name] = list(grant)
        self._queue_wait_s[config.name] = queue_wait_s
        vre.instantiate()
        self._publish_endpoints(vre)
        self.admissions += 1
        self.monitor.log("fleet", "admitted", vre=config.name, devices=n0,
                         queue_wait_s=queue_wait_s,
                         free=len(self._free()))
        return vre

    def _inject_shared_prefix_cache(self, config):
        """VREs serving the same (arch, chunk_tokens) share one PrefixCache:
        one community's prefill warms every tenant running the same
        pipeline. The largest requested budget wins (the cache is fleet
        memory, not per-tenant)."""
        extra = getattr(config, "extra", None)
        if not isinstance(extra, dict):
            return
        chunk = int(extra.get("chunk_tokens", 0) or 0)
        mb = float(extra.get("prefix_cache_mb", 0) or 0)
        arch = getattr(config, "arch", None)
        if not (chunk and mb > 0 and arch):
            return
        extra["shared_prefix_cache"] = self.shared_prefix_cache(
            arch, chunk, mb)

    def shared_prefix_cache(self, arch: str, chunk_tokens: int,
                            budget_mb: float):
        from repro_torch.serving.prefix_cache import PrefixCache
        key = (arch, int(chunk_tokens))
        with self._lock:
            pc = self._prefix_caches.get(key)
            if pc is None:
                pc = PrefixCache(chunk_tokens,
                                 budget_bytes=int(budget_mb * 2**20),
                                 monitor=self.monitor,
                                 name=f"fleet-prefix-{arch}")
                self._prefix_caches[key] = pc
            elif pc.budget < int(budget_mb * 2**20):
                pc.budget = int(budget_mb * 2**20)
            return pc

    # -- proposals ---------------------------------------------------------
    def propose_resize(self, name: str,
                       new_mesh_shape: Optional[tuple] = None,
                       pressure: Optional[float] = None) -> dict:
        """The resize-proposal protocol. Verdicts:

        granted  — full target reserved (possibly via preemption: lower-
                   priority VREs' grants shrink toward their claim minimum;
                   ``preempted`` lists them); ``pending_resize`` set.
        shrunk   — only part of the target was free; a smaller growth is
                   reserved instead.
        deferred — nothing can move now; the proposal is parked and
                   re-evaluated whenever capacity frees (``tick``).
        noop     — the (possibly quota-capped) target is not larger than
                   the current grant.

        Shrink proposals (target below the current grant) are voluntary
        releases: granted immediately, never below the claim minimum.
        Reservation is bookkeeping-only; the destructive mesh changes happen
        at ``apply_pending``.

        ``pressure`` is the proposer's SLO error-budget burn rate (None
        when the tenant scales on raw saturation alone): it is recorded on
        the verdict, remembered per tenant, and breaks ties among
        same-priority deferred proposals when ``tick`` re-evaluates them —
        the tenant burning its budget hardest goes first."""
        with self._lock:
            if pressure is not None:
                self._pressure[name] = float(pressure)
            verdict = self._propose_locked(name, new_mesh_shape)
        if pressure is not None:
            verdict["pressure"] = float(pressure)
        self.monitor.log("fleet", "proposal", vre=name, **{
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in verdict.items()})
        return verdict

    def _propose_locked(self, name: str,
                        new_mesh_shape: Optional[tuple]) -> dict:
        vre = self._vres.get(name)
        if vre is None:
            raise KeyError(f"unknown VRE {name!r}")
        claim = self._claims[name]
        cur_shape = tuple(vre.config.mesh_shape)
        unit = self._unit(cur_shape)
        have = len(self._grants[name])
        if new_mesh_shape is None:
            new_mesh_shape = (cur_shape[0] * 2, *cur_shape[1:])
        want = int(np.prod(new_mesh_shape))
        want = -(-want // unit) * unit                      # whole units
        floor = -(-claim.min_devices // unit) * unit
        capped = want > claim.cap
        want = max(floor, min(want, (claim.cap // unit) * unit))
        if want < have:                                    # voluntary shrink
            self._reserve(name, want)
            return {"verdict": "granted", "shape": self._shape_for(
                want, cur_shape), "devices": want, "quota_capped": capped}
        if want == have:
            return {"verdict": "noop", "devices": have,
                    "quota_capped": capped}
        delta = want - have
        free = len(self._free())
        if free >= delta:
            self._reserve(name, want)
            return {"verdict": "granted", "shape": self._shape_for(
                want, cur_shape), "devices": want, "quota_capped": capped}
        # not enough free: can lower-priority tenants be squeezed?
        preempted = self._plan_preemption(name, claim, delta - free)
        if preempted is not None:
            self._reserve(name, want)
            self.preemptions += len(preempted)
            self.monitor.log("fleet", "preempted", for_vre=name,
                             victims=preempted)
            return {"verdict": "granted", "shape": self._shape_for(
                want, cur_shape), "devices": want, "quota_capped": capped,
                "preempted": preempted}
        if free >= unit:                                   # partial grant
            got = have + (free // unit) * unit
            self._reserve(name, got)
            return {"verdict": "shrunk", "shape": self._shape_for(
                got, cur_shape), "devices": got, "wanted": want,
                "quota_capped": capped}
        self._deferred[name] = new_mesh_shape
        return {"verdict": "deferred", "wanted": want,
                "quota_capped": capped}

    def _plan_preemption(self, name: str, claim: ResourceClaim,
                         needed: int) -> Optional[list]:
        """Shrink strictly-lower-priority VREs (lowest first, never below
        their claim minimum, in whole mesh units) until ``needed`` devices
        come free. Mutates grants and victims' ``pending_resize`` on
        success; returns None (no mutation) when the fleet cannot yield
        enough."""
        victims = sorted(
            (n for n in self._vres
             if n != name and self._claims[n].priority < claim.priority),
            key=lambda n: self._claims[n].priority)
        plan = []
        remaining = needed
        for vname in victims:
            if remaining <= 0:
                break
            v_unit = self._unit(tuple(self._vres[vname].config.mesh_shape))
            v_have = len(self._grants[vname])
            v_floor = -(-self._claims[vname].min_devices // v_unit) * v_unit
            spare = v_have - v_floor
            if spare <= 0:
                continue
            take = min(spare, -(-remaining // v_unit) * v_unit)
            plan.append((vname, v_have - take))
            remaining -= take
        if remaining > 0:
            return None
        for vname, target in plan:
            self._reserve(vname, target)
        return [vname for vname, _ in plan]

    def _reserve(self, name: str, n_devices: int):
        """Re-point ``name``'s grant at ``n_devices`` (keeping its leading
        devices on shrink, appending free ones on growth) and record the
        matching ``pending_resize`` for ``apply_pending``. Lock held."""
        vre = self._vres[name]
        grant = self._grants[name]
        if n_devices <= len(grant):
            new_grant = grant[:n_devices]
        else:
            new_grant = grant + self._free()[:n_devices - len(grant)]
        assert len(new_grant) == n_devices, (name, n_devices, len(new_grant))
        self._grants[name] = new_grant
        vre.device_pool = list(new_grant)
        shape = self._shape_for(n_devices, tuple(vre.config.mesh_shape))
        vre.pending_resize = shape if shape != tuple(vre.config.mesh_shape) \
            else None
        self._deferred.pop(name, None)

    # -- application -------------------------------------------------------
    def apply_pending(self, service: str = "lm-server") -> List[dict]:
        """Apply every reserved grant under live serving at a safe point:
        shrinks first (their devices fund the growths), each through
        ``elastic.resize_serving`` so in-flight requests are detached,
        carried, and adopted by the successor pool. Re-publishes the moved
        VREs' endpoints into the fleet directory (new generation)."""
        from repro_torch.core import elastic

        with self._lock:
            pending = [(n, v) for n, v in self._vres.items()
                       if v.pending_resize is not None]
            pending.sort(key=lambda nv: int(np.prod(nv[1].pending_resize))
                         - int(np.prod(nv[1].config.mesh_shape)))
        events = []
        for name, vre in pending:
            old_shape = tuple(vre.config.mesh_shape)
            ev = elastic.resize_serving(vre, service=service)
            if ev is None:
                continue
            with self._lock:
                # the live mesh now matches the grant: released devices are
                # physically free for admission
                self._occupied[name] = list(self._grants.get(name, ()))
                self._publish_endpoints(vre)
            if service in getattr(vre, "services", {}):
                # re-arm the rebuilt autoscaler: the next saturation
                # episode may propose again
                scaler = getattr(vre.service(service), "autoscaler", None)
                if scaler is not None:
                    scaler.notify_resized()
            events.append({
                "vre": name, "old_shape": list(old_shape),
                "new_shape": list(vre.config.mesh_shape),
                "downtime_s": ev["downtime_s"],
                "carried_requests": ev["carried_requests"],
            })
            self.monitor.log("fleet", "grant_applied", vre=name,
                             new_shape=list(vre.config.mesh_shape),
                             carried=ev["carried_requests"])
        return events

    # -- release / queue drain --------------------------------------------
    def release(self, name: str) -> None:
        """Destroy a VRE, return its grant to the pool, and let waiting
        work in (queued admissions, deferred proposals)."""
        with self._lock:
            vre = self._vres.pop(name, None)
            if vre is None:
                raise KeyError(f"unknown VRE {name!r}")
            claim = self._claims.pop(name)
            freed = self._grants.pop(name, [])
            self._occupied.pop(name, None)
            self._deferred.pop(name, None)
            self._queue_wait_s.pop(name, None)
            self._pressure.pop(name, None)
            for key in [k for k in self.directory.entries()
                        if k.startswith(name + "/")]:
                self.directory.withdraw(key)
        vre.destroy()
        vre.arbiter = None
        self.monitor.log("fleet", "released", vre=name, devices=len(freed),
                         priority=claim.priority)
        self.tick()

    def tick(self) -> dict:
        """Admit queued VREs that now fit (priority order, against devices
        both ungranted *and* unoccupied), apply admission pressure —
        a queued higher-priority claim reserves preemptive shrinks of
        running lower-priority VREs toward their minima (the shrinks free
        devices once ``apply_pending`` runs, after which the next tick
        admits) — and re-evaluate deferred proposals."""
        admitted, regranted, reserved = [], [], []
        with self._lock:
            while self._queue:
                # strict head-of-line within the priority order: a smaller,
                # lower-priority entry further back must NOT backfill past a
                # blocked head — it could pin devices at its claim minimum
                # and starve the head forever (preemption never evicts
                # below minima)
                ent = self._queue[0]
                n0 = int(np.prod(ent.config.mesh_shape))
                if n0 > len(self._physically_free()):
                    break
                self._queue.pop(0)
                wait = time.monotonic() - ent.submit_t
                self._admit_locked(ent.config, ent.claim, queue_wait_s=wait)
                admitted.append(ent.config.name)
            if self._queue:
                head = self._queue[0]
                need = int(np.prod(head.config.mesh_shape)) \
                    - len(self._free())
                if need > 0:
                    victims = self._plan_preemption(head.config.name,
                                                    head.claim, need)
                    if victims:
                        self.preemptions += len(victims)
                        reserved = victims
                        self.monitor.log("fleet", "preempted",
                                         for_vre=head.config.name,
                                         victims=victims,
                                         reason="admission_pressure")
            for name in sorted(self._deferred,
                               key=lambda n: (-self._claims[n].priority,
                                              -self._pressure.get(n, 0.0))):
                shape = self._deferred.pop(name)
                verdict = self._propose_locked(name, shape)
                if verdict["verdict"] != "deferred":
                    regranted.append({"vre": name, **verdict})
        return {"admitted": admitted, "regranted": regranted,
                "preempt_reserved": reserved}

    # -- background control loop ------------------------------------------
    def start_ticker(self, interval_s: float = 0.05,
                     service: str = "lm-server"):
        """Run ``tick()`` + ``apply_pending()`` on a background interval, so
        queued admissions, deferred proposals, and reserved preemption
        shrinks land without the driver invoking them by hand — the arbiter
        becomes a control loop, not a library the driver must remember to
        pump. ``apply_pending`` routes every move through the drain/adopt
        resize path, so in-flight requests ride the automatic applications
        exactly as they do the manual ones."""
        if self._ticker is not None and self._ticker.is_alive():
            return self
        self._ticker_stop.clear()

        def loop():
            while not self._ticker_stop.wait(interval_s):
                try:
                    self.tick()
                    self.apply_pending(service)
                    # applied shrinks freed devices: admit/regrant now
                    # rather than one full interval later
                    self.tick()
                except Exception as exc:    # the loop must outlive any VRE
                    self.monitor.log("fleet", "ticker_error",
                                     error=repr(exc))

        self._ticker = threading.Thread(target=loop, name="fleet-ticker",
                                        daemon=True)
        self._ticker.start()
        self.monitor.log("fleet", "ticker_started", interval_s=interval_s)
        return self

    def stop_ticker(self, timeout: float = 10.0) -> bool:
        """Signal the control loop and join it. Returns False when the
        thread is still running after ``timeout`` (e.g. blocked inside a
        long ``apply_pending`` drain) — the handle is kept so a retry can
        join it and so ``start_ticker`` can't spawn a second loop (or
        un-stop this one by clearing the event) while it drains."""
        self._ticker_stop.set()
        t = self._ticker
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                return False
        self._ticker = None
        return True

    # -- endpoint directory ------------------------------------------------
    def _publish_endpoints(self, vre):
        for svc, ent in vre.endpoints.entries().items():
            self.directory.publish(f"{vre.config.name}/{svc}",
                                   ent["address"],
                                   {**ent.get("meta", {}),
                                    "generation": vre.generation})

    def _refresh_endpoint(self, key: str):
        """Directory refresher: an expired lease re-resolves against the
        live VRE's own directory (source of truth across re-instantiation);
        a released VRE resolves to nothing (stale miss)."""
        vre_name, _, svc = key.partition("/")
        with self._lock:
            vre = self._vres.get(vre_name)
        if vre is None:
            return None
        try:
            addr = vre.endpoints.resolve(svc)
        except KeyError:
            return None
        return addr, {"vre": vre_name, "generation": vre.generation}

    def resolve(self, vre_name: str, service: str) -> str:
        return self.directory.resolve(f"{vre_name}/{service}")

    # -- introspection -----------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "pool_devices": len(self.pool),
                "free_devices": len(self._free()),
                "grants": {n: len(g) for n, g in self._grants.items()},
                "queued": [q.config.name for q in self._queue],
                "deferred": {n: list(s) for n, s in self._deferred.items()},
                "queue_wait_s": dict(self._queue_wait_s),
                "pressure": dict(self._pressure),
                "admissions": self.admissions,
                "preemptions": self.preemptions,
                "vres": {n: {"state": v.state,
                             "mesh": list(v.config.mesh_shape),
                             "generation": getattr(v, "generation", None),
                             "pending_resize":
                                 list(v.pending_resize)
                                 if v.pending_resize else None}
                         for n, v in self._vres.items()},
            }

    def placements(self) -> Dict[str, list]:
        """name -> granted devices; grants are pairwise disjoint by
        construction (asserted here for tests and post-mortems)."""
        with self._lock:
            grants = {n: list(g) for n, g in self._grants.items()}
        seen = set()
        for n, g in grants.items():
            overlap = seen.intersection(g)
            assert not overlap, f"grant overlap at {n}: {overlap}"
            seen.update(g)
        return grants
