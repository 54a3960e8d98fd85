"""Deployment automation: decentralized (KubeNow-style) vs centralized
(Kubespray-style baseline) — the paper's §4.1.1 / §5.2 contribution.

The two ideas under test (paper §4.1.1):

1. **Pre-provisioned images** -> a *deployment image cache*: a pickled
   artifact store keyed by (service, arch, mesh, shape). A warm
   instantiation skips every build — the analogue of booting nodes from an
   image with dependencies installed.

2. **Decentralized contextualization (cloud-init)** -> every node derives
   its entire local configuration from (cluster_config, node_id) and
   configures itself; nodes work concurrently. The centralized baseline
   drives each node from a single controller, sequentially, paying a
   controller->node round trip per configuration push (the paper runs the
   controller on a laptop *outside* the cloud network).

Node contextualization here is real work (config materialization + service
program compilation); the controller<->node network round-trip is the one
simulated quantity (``rtt_s``, default 80 ms — a laptop in Uppsala driving a
remote cloud, as in the paper's §5.2 setup) and is reported separately so
measured vs modeled time cannot be conflated.

A copy of the JAX package's ``repro.core.deployment`` (framework-free),
kept in the port so that the port imports nothing of the JAX package. The
service builders run on the deployer's thread pool; an exception in one
(a CUDA out-of-memory error while a model is built) is raised again by
``deploy``.
"""
from __future__ import annotations

import dataclasses
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List


@dataclasses.dataclass
class NodeReport:
    node_id: int
    role: str
    work_s: float = 0.0
    rtt_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0


@dataclasses.dataclass
class DeploymentReport:
    mode: str
    nodes: int
    wall_s: float = 0.0
    measured_work_s: float = 0.0      # sum of real node work
    modeled_network_s: float = 0.0    # simulated RTT component (documented)
    node_reports: List[NodeReport] = dataclasses.field(default_factory=list)
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self):
        return {
            "mode": self.mode, "nodes": self.nodes, "wall_s": self.wall_s,
            "measured_work_s": self.measured_work_s,
            "modeled_network_s": self.modeled_network_s,
            "phases": self.phases,
        }


class ImageCache:
    """Pre-provisioned image analogue: pickled service artifacts keyed by a
    config fingerprint."""

    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> Path:
        return self.root / (key.replace("/", "_") + ".pkl")

    def get_or_build(self, key: str, build: Callable[[], object]):
        p = self._path(key)
        with self._lock:
            if p.exists():
                self.hits += 1
                try:
                    return pickle.loads(p.read_bytes()), True
                except Exception:
                    p.unlink()
        value = build()
        with self._lock:
            self.misses += 1
            try:
                p.write_bytes(pickle.dumps(value))
            except Exception:
                pass   # unpicklable artifacts simply aren't cached
        return value, False


def node_roles(n_nodes: int, service_ratio: int = 5, storage_ratio: int = 3):
    """Paper's 5:3 service:storage topology + 1 master/edge (§5.2)."""
    roles = ["master+edge"]
    cycle = ["service"] * service_ratio + ["storage"] * storage_ratio
    for i in range(n_nodes - 1):
        roles.append(cycle[i % len(cycle)])
    return roles


class DecentralizedDeployer:
    """KubeNow-style: image-cached boot + per-node self-contextualization."""

    mode = "decentralized"

    def __init__(self, image_cache: ImageCache, rtt_s: float = 0.08,
                 max_node_parallelism: int = 64):
        self.image_cache = image_cache
        self.rtt_s = rtt_s
        self.max_node_parallelism = max_node_parallelism

    def deploy(self, n_nodes: int, contextualize: Callable[[int, str], dict],
               simulate_network: bool = True) -> DeploymentReport:
        """contextualize(node_id, role) does the node's real setup work and
        returns {'cache_hits': int, 'cache_misses': int}."""
        roles = node_roles(n_nodes)
        rep = DeploymentReport(self.mode, n_nodes)
        t0 = time.perf_counter()
        # one broadcast: the IaC document reaches every node (cloud-init
        # user-data is attached at boot -> a single provider API call)
        if simulate_network:
            time.sleep(self.rtt_s)
        rep.modeled_network_s += self.rtt_s

        def boot(node_id: int) -> NodeReport:
            nr = NodeReport(node_id, roles[node_id])
            w0 = time.perf_counter()
            stats = contextualize(node_id, roles[node_id])
            nr.work_s = time.perf_counter() - w0
            nr.cache_hits = stats.get("cache_hits", 0)
            nr.cache_misses = stats.get("cache_misses", 0)
            return nr

        with ThreadPoolExecutor(max_workers=min(n_nodes,
                                                self.max_node_parallelism)) as ex:
            rep.node_reports = list(ex.map(boot, range(n_nodes)))
        rep.measured_work_s = sum(n.work_s for n in rep.node_reports)
        rep.wall_s = time.perf_counter() - t0
        rep.phases = {"broadcast": self.rtt_s,
                      "selfconfig_wall": rep.wall_s - self.rtt_s}
        return rep


class CentralizedDeployer:
    """Kubespray-style baseline: a single controller (outside the cloud
    network) pushes configuration to every node. Ansible-style forks let
    node WORK overlap, but each push round serializes on the controller
    uplink (divided by a pipelining factor); vanilla images, no cache."""

    mode = "centralized"

    def __init__(self, rtt_s: float = 0.08, pushes_per_node: int = 3,
                 pipeline_factor: int = 4, max_forks: int = 64):
        self.rtt_s = rtt_s
        self.pushes_per_node = pushes_per_node
        self.pipeline_factor = pipeline_factor
        self.max_forks = max_forks

    def deploy(self, n_nodes: int, contextualize: Callable[[int, str], dict],
               simulate_network: bool = True) -> DeploymentReport:
        roles = node_roles(n_nodes)
        rep = DeploymentReport(self.mode, n_nodes)
        t0 = time.perf_counter()
        push_wall = (self.rtt_s * self.pushes_per_node * n_nodes
                     / self.pipeline_factor)
        if simulate_network:
            time.sleep(push_wall)
        rep.modeled_network_s += push_wall

        def provision(node_id: int) -> NodeReport:
            nr = NodeReport(node_id, roles[node_id])
            w0 = time.perf_counter()
            stats = contextualize(node_id, roles[node_id])
            nr.work_s = time.perf_counter() - w0
            nr.cache_hits = stats.get("cache_hits", 0)
            nr.cache_misses = stats.get("cache_misses", 0)
            return nr

        with ThreadPoolExecutor(max_workers=min(n_nodes,
                                                self.max_forks)) as ex:
            rep.node_reports = list(ex.map(provision, range(n_nodes)))
        rep.measured_work_s = sum(n.work_s for n in rep.node_reports)
        rep.wall_s = time.perf_counter() - t0
        rep.phases = {"push_total": rep.modeled_network_s,
                      "parallel_work": rep.wall_s - push_wall}
        return rep
