"""Microservice registry + endpoint directory.

Paper mapping (§3.1.3): a community of practice composes a VRE from a set of
independently deployable services. Here a ``ServiceSpec`` declares a named,
independently *compilable* unit (builder returns a Service given the VRE
context); the ``EndpointDirectory`` is the DynDNS/CDN analogue — stable names
that re-resolve to fresh addresses every time an on-demand VRE is
re-instantiated.

A copy of the JAX package's ``repro.core.registry`` (framework-free).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class ServiceHandle:
    """Uniform microservice lifecycle (paper §3.1.2): every deployed service
    exposes the same ``start / stop / health / scale / metrics`` surface, so
    the orchestrator (VRE) can manage heterogeneous services — trainers,
    serving replica sets, volumes — without per-service special cases.

    Domain methods of the wrapped ``instance`` remain reachable through
    attribute delegation, so ``vre.service("volumes").save(...)`` keeps
    working; subclasses override lifecycle hooks as needed."""

    def __init__(self, name: str, kind: str, instance: Any = None):
        self.name = name
        self.kind = kind
        self.instance = instance

    # -- lifecycle hooks (override in subclasses) -------------------------
    def start(self):
        inner = getattr(self.instance, "start", None)
        if callable(inner):
            inner()
        return self

    def stop(self):
        inner = getattr(self.instance, "stop", None)
        if callable(inner):
            inner()

    def health(self) -> bool:
        h = getattr(self.instance, "healthy", True)
        return h() if callable(h) else bool(h)

    def scale(self, n: int) -> int:
        """Resize to ``n`` replicas/workers; returns the resulting size.
        Services with nothing to scale report size 1."""
        inner = getattr(self.instance, "scale_to", None)
        if callable(inner):
            return inner(n)
        return 1

    def rebalance(self, mesh) -> dict:
        """Re-place the service onto a (resized) device mesh. Services with
        no placement state report an empty dict."""
        inner = getattr(self.instance, "rebalance", None)
        if callable(inner):
            return inner(mesh)
        return {}

    def metrics(self) -> dict:
        inner = getattr(self.instance, "metrics", None)
        if callable(inner):
            return inner()
        return dict(inner) if isinstance(inner, dict) else {}

    # -- delegation -------------------------------------------------------
    def __getattr__(self, item):
        if item.startswith("_") or self.__dict__.get("instance") is None:
            raise AttributeError(item)
        return getattr(self.instance, item)

    def __iter__(self):
        return iter(self.instance)

    def __repr__(self):
        return (f"<ServiceHandle {self.name} kind={self.kind} "
                f"instance={type(self.instance).__name__}>")


@dataclasses.dataclass
class Service:
    name: str
    kind: str
    instance: Any                     # ServiceHandle (or bare live object)
    endpoint: str
    long_running: bool = True
    started_at: float = dataclasses.field(default_factory=time.time)

    def health(self) -> bool:
        if isinstance(self.instance, ServiceHandle):
            return self.instance.health()
        h = getattr(self.instance, "healthy", True)
        return h() if callable(h) else bool(h)


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """A deployable microservice: name + builder(ctx) -> instance."""
    name: str
    kind: str                         # data|train|serve|storage|monitor|workflow|tool
    builder: Callable[["Any"], Any]
    long_running: bool = True
    description: str = ""


class ServiceRegistry:
    """Helm-repository analogue: named, versioned service packages."""

    def __init__(self):
        self._specs: Dict[str, ServiceSpec] = {}
        self._lock = threading.Lock()

    def register(self, spec: ServiceSpec, overwrite: bool = False):
        with self._lock:
            if spec.name in self._specs and not overwrite:
                raise KeyError(f"service {spec.name!r} already registered")
            self._specs[spec.name] = spec
        return spec

    def get(self, name: str) -> ServiceSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(f"unknown service {name!r}; "
                           f"known: {sorted(self._specs)}") from None

    def names(self) -> List[str]:
        return sorted(self._specs)


class StaleEndpoint(KeyError):
    """A TTL'd directory entry expired and no refresher could re-resolve it
    (e.g. the VRE moved or was destroyed between leases)."""


class EndpointDirectory:
    """DynDNS analogue: stable names -> dynamically re-resolved addresses.

    With a ``default_ttl_s`` (or a per-entry ``ttl_s``) an entry is a *lease*:
    once it expires, ``resolve`` consults the registered refresher — a
    callback that fetches the current address from the source of truth (the
    live VRE) — instead of handing out a possibly-stale address. Replicas
    moving under failover or an elastic resize therefore surface to clients
    within one TTL, not never. Entries without a TTL behave as before."""

    def __init__(self, default_ttl_s: Optional[float] = None):
        self._entries: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.default_ttl_s = default_ttl_s
        self._refresher = None       # fn(name) -> (address, meta) | None
        self.refreshes = 0
        self.stale_misses = 0

    def set_refresher(self, fn):
        """``fn(name) -> (address, meta) | None`` re-resolves an expired
        lease from the source of truth; None means the name is gone."""
        with self._lock:
            self._refresher = fn

    def publish(self, name: str, address: str, meta: Optional[dict] = None,
                ttl_s: Optional[float] = None):
        ttl = ttl_s if ttl_s is not None else self.default_ttl_s
        with self._lock:
            self._entries[name] = {"address": address,
                                   "updated": time.time(),
                                   "expires": (time.monotonic() + ttl)
                                              if ttl is not None else None,
                                   "ttl_s": ttl,
                                   "meta": meta or {}}

    def resolve(self, name: str) -> str:
        with self._lock:
            ent = self._entries.get(name)
            refresher = self._refresher
            if ent is not None and (ent["expires"] is None
                                    or time.monotonic() < ent["expires"]):
                return ent["address"]
        # expired (or never published): re-resolve outside the lock — the
        # refresher may call back into services that publish here
        if refresher is not None:
            fresh = refresher(name)
            if fresh is not None:
                address, meta = fresh
                ttl = ent["ttl_s"] if ent is not None else None
                self.publish(name, address, meta, ttl_s=ttl)
                with self._lock:
                    self.refreshes += 1
                return address
        with self._lock:
            self.stale_misses += 1
        if ent is not None:
            raise StaleEndpoint(f"endpoint {name!r} lease expired and could "
                                f"not be re-resolved")
        raise KeyError(f"unresolved endpoint {name!r}")

    def withdraw(self, name: str):
        with self._lock:
            self._entries.pop(name, None)

    def entries(self) -> dict:
        with self._lock:
            return dict(self._entries)


GLOBAL_REGISTRY = ServiceRegistry()


def register_service(name: str, kind: str, *, long_running: bool = True,
                     description: str = ""):
    """Decorator: @register_service("lm-trainer", "train")."""
    def deco(fn):
        GLOBAL_REGISTRY.register(ServiceSpec(
            name=name, kind=kind, builder=fn, long_running=long_running,
            description=description), overwrite=True)
        return fn
    return deco
