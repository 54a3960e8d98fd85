"""On-demand Virtual Research Environments over a pool of CUDA devices.

The paper's three layers, instantiated:

  Cloud Provider  -> device substrate: a ``DeviceMesh`` over the procured
                     devices ("VMs"): shares of every visible card for
                     provider ``"h100"``, of the host for ``"cpu"``
                     (``repro_torch.device.device_pool``); releasing the
                     VRE releases the mesh.
  Orchestrator    -> this module + scheduler/monitoring/checkpoint: service
                     lifecycle, discovery, volumes (checkpoint store),
                     rescheduling.
  Microservices   -> ServiceSpecs composed per community of practice
                     (data pipeline, server, workflow, monitor).

A VRE is short-lived by design: ``instantiate()`` procures + deploys,
``destroy()`` releases everything; the deployment image cache makes repeat
instantiation fast (paper §4.1.1). ``resize()`` re-instantiates on a larger/
smaller mesh and restores state from the volume service (elastic scaling).

A port of the JAX package's ``repro.core.vre``. The mesh is procured from
``device_pool`` when one is set (a fleet grant, or shares of the card),
else from the provider's pool of one share per device.
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.deployment import (DecentralizedDeployer,
                                         DeploymentReport, ImageCache)
from repro_torch.core.monitoring import Monitor
from repro_torch.core.registry import (EndpointDirectory, Service,
                                       ServiceHandle, ServiceRegistry,
                                       GLOBAL_REGISTRY)
from repro_torch.device import device_pool


@dataclasses.dataclass
class VREConfig:
    name: str
    mesh_shape: tuple = (1, 1)
    mesh_axes: tuple = ("data", "model")
    services: List[str] = dataclasses.field(default_factory=list)
    arch: Optional[str] = None
    provider: str = "h100"                # h100 (every visible card) | cpu
    workdir: str = dataclasses.field(
        default_factory=lambda: str(Path(tempfile.gettempdir()) / "vre"))
    storage_servers: int = 4
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class DeviceMesh:
    """The VRE's device substrate: a numpy array of ``DeviceShare``s shaped
    like the mesh, with its axis names (the counterpart of a JAX ``Mesh``;
    it holds no process group)."""

    def __init__(self, devices: np.ndarray, axis_names):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {devices.ndim} with axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


class VREContext:
    """What service builders see (the 'cluster' from inside a container)."""

    def __init__(self, vre: "VirtualResearchEnvironment"):
        self.vre = vre
        self.config = vre.config
        self.mesh = vre.mesh
        self.monitor = vre.monitor
        self.endpoints = vre.endpoints
        self.workdir = Path(vre.config.workdir)

    def service(self, name: str):
        return self.vre.service(name)


class VirtualResearchEnvironment:
    def __init__(self, config: VREConfig,
                 registry: ServiceRegistry = GLOBAL_REGISTRY,
                 monitor: Optional[Monitor] = None):
        self.config = config
        self.registry = registry
        self.monitor = monitor or Monitor(
            log_path=str(Path(config.workdir) / config.name / "events.jsonl"),
            name=config.name)
        self.endpoints = EndpointDirectory()
        self.mesh: Optional[DeviceMesh] = None
        self.services: Dict[str, Service] = {}
        self.state = "DEFINED"
        self.image_cache = ImageCache(
            str(Path(config.workdir) / "image_cache"))
        self.last_report: Optional[DeploymentReport] = None
        self.pending_resize: Optional[tuple] = None
        # fleet arbitration: when a FleetArbiter admits this VRE it grants a
        # disjoint slice of the shared pool (device_pool) and routes resize
        # requests through its proposal protocol (arbiter); a device_pool
        # set by hand (shares of one card) bounds the mesh the same way
        self.device_pool: Optional[list] = None
        self.arbiter = None
        self.claim = None
        # bumped every (re-)instantiation; endpoint addresses carry it so a
        # TTL'd directory can tell a fresh placement from a stale lease
        self.generation = 0

    # -- infrastructure layer ---------------------------------------------
    def _procure_mesh(self) -> DeviceMesh:
        n = int(np.prod(self.config.mesh_shape))
        devices = (self.device_pool if self.device_pool is not None
                   else device_pool(self.config.provider))
        if len(devices) < n:
            hint = ("; no CUDA device is visible (provider 'cpu' runs on the "
                    "host)" if self.config.provider == "h100" and not devices
                    else "")
            raise RuntimeError(
                f"provider has {len(devices)} devices, VRE wants {n}{hint}")
        grid = np.empty(n, dtype=object)
        grid[:] = devices[:n]
        return DeviceMesh(grid.reshape(self.config.mesh_shape),
                          self.config.mesh_axes)

    # -- lifecycle -----------------------------------------------------------
    def instantiate(self, deployer: Optional[object] = None,
                    simulate_network: bool = False
                    ) -> DeploymentReport:
        if self.state == "RUNNING":
            return self.last_report
        t0 = time.perf_counter()
        self.mesh = self._procure_mesh()
        self.generation += 1
        ctx = VREContext(self)
        deployer = deployer or DecentralizedDeployer(self.image_cache)

        specs = [self.registry.get(s) for s in self.config.services]

        def contextualize(node_id: int, role: str) -> dict:
            # every node derives its config locally (cloud-init style);
            # node 0 additionally builds the service instances
            hits = misses = 0
            _ = json.dumps({"node": node_id, "role": role,
                            "mesh": list(self.config.mesh_shape)})
            if node_id == 0:
                for spec in specs:
                    h0, m0 = self.image_cache.hits, self.image_cache.misses
                    instance = spec.builder(ctx)
                    hits += self.image_cache.hits - h0
                    misses += self.image_cache.misses - m0
                    ep = (f"vre://{self.config.name}/{spec.name}"
                          f"@g{self.generation}")
                    self.services[spec.name] = Service(
                        spec.name, spec.kind, instance, ep,
                        spec.long_running)
                    self.endpoints.publish(spec.name, ep,
                                           {"kind": spec.kind})
            return {"cache_hits": hits, "cache_misses": misses}

        n_nodes = max(1, int(np.prod(self.config.mesh_shape)) // 8)
        try:
            report = deployer.deploy(n_nodes, contextualize,
                                     simulate_network=simulate_network)
        except BaseException:
            # a builder failed (e.g. out of device memory while a model was
            # built): release what was built before it, then raise
            self._release()
            raise
        report.phases["total_instantiate"] = time.perf_counter() - t0
        self.state = "RUNNING"
        self.last_report = report
        for svc in self.services.values():       # uniform lifecycle: start
            if isinstance(svc.instance, ServiceHandle):
                svc.instance.start()
        self.monitor.log("vre", "instantiated", nodes=n_nodes,
                         wall_s=report.wall_s, mode=report.mode)
        return report

    def service(self, name: str) -> Any:
        if self.state != "RUNNING":
            raise RuntimeError(f"VRE {self.config.name} is {self.state}")
        return self.services[name].instance

    def status(self) -> dict:
        return {
            "name": self.config.name,
            "state": self.state,
            "generation": self.generation,
            "granted_devices": len(self.device_pool)
                               if self.device_pool is not None else None,
            "mesh": list(self.config.mesh_shape) if self.mesh is not None
                    else None,
            "pending_resize": list(self.pending_resize)
                              if self.pending_resize else None,
            "services": {n: {"kind": s.kind, "endpoint": s.endpoint,
                             "healthy": s.health()}
                         for n, s in self.services.items()},
            "endpoints": self.endpoints.entries(),
        }

    def scale_service(self, name: str, n: int) -> int:
        """Resize a service through the uniform lifecycle protocol."""
        inst = self.service(name)
        if isinstance(inst, ServiceHandle):
            size = inst.scale(n)
            self.monitor.log("vre", "service_scaled", service=name, size=size)
            return size
        raise TypeError(f"service {name!r} has no lifecycle handle")

    def request_resize(self, new_mesh_shape: Optional[tuple] = None,
                       pressure: Optional[float] = None):
        """Mark the mesh as saturated (autoscaler hook). ``resize`` is
        destructive, so the request is recorded for a driver to apply at a
        safe point rather than ripping services out from under in-flight
        work.

        Under a FleetArbiter the request becomes a *proposal*: the arbiter
        may grant it fully, grant a shrunken shape against competing claims,
        or defer it until capacity frees up — it sets ``pending_resize`` (and
        the device grant) itself. Returns the proposal verdict dict in that
        case, the recorded pending shape (default: the data axis doubled)
        otherwise."""
        if new_mesh_shape is None:
            d, *rest = self.config.mesh_shape
            new_mesh_shape = (d * 2, *rest)
        if self.arbiter is not None:
            return self.arbiter.propose_resize(self.config.name,
                                               tuple(new_mesh_shape),
                                               pressure=pressure)
        self.pending_resize = tuple(new_mesh_shape)
        self.monitor.log("vre", "resize_requested",
                         old=list(self.config.mesh_shape),
                         new=list(new_mesh_shape))
        return self.pending_resize

    def _release(self):
        """Withdraw and stop every service (best-effort) and drop the
        mesh."""
        for name in list(self.services):
            self.endpoints.withdraw(name)
        for svc in self.services.values():       # uniform lifecycle: stop
            if isinstance(svc.instance, ServiceHandle):
                try:
                    svc.instance.stop()
                except Exception:
                    pass                         # teardown is best-effort
        self.services.clear()
        self.mesh = None

    def destroy(self):
        """Release everything — on-demand VREs are short-lived by design."""
        self._release()
        self.state = "DESTROYED"
        self.monitor.log("vre", "destroyed")
        # release the cached log handle; a later instantiate transparently
        # reopens it on the next event
        self.monitor.close()

    # -- elastic scaling -----------------------------------------------------
    def resize(self, new_mesh_shape: tuple, state: Any = None,
               state_reshard: Optional[object] = None):
        """Re-instantiate on a different mesh; optionally carry ``state``
        through the volume service (see ``repro_torch.core.elastic``).
        Returns ``(ResizeReport, restored_state_or_None)``."""
        from repro_torch.core import elastic
        out = elastic.resize(self, new_mesh_shape, state=state,
                             reshard=state_reshard)
        self.pending_resize = None
        return out
