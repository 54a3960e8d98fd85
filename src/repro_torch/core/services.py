"""Built-in microservices (the PhenoMeNal-style 'community of practice'
package set): data pipeline, serving engines + edge router, workflow system,
volumes (checkpoint store), monitoring dashboard.

Each builder returns a ``ServiceHandle`` — the uniform lifecycle protocol
(``start/stop/health/scale/metrics``) the VRE orchestrator manages — wrapping
the live instance.

A port of the JAX package's ``repro.core.services``. Provider ``"cpu"``
serves the reduced config of the VRE's arch, the card (``"h100"``) its full
widths. Not ported yet: the ``lm-trainer`` service (ROADMAP A.7; its builder
raises), and the autoscaler and ``rebalance`` of ``lm-server`` (A.6; they
raise).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.registry import ServiceHandle, register_service
from repro_torch.core.scheduler import ClusterScheduler
from repro_torch.core.workflow import Workflow
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.launch.serve import model_config, record_meta, replicaset_for
from repro_torch.serving.engine import EdgeRouter
from repro_torch.serving.replica import ReplicaSet


def _model_cfg(ctx):
    return model_config(ctx.config.arch or "yi-9b", ctx.config.provider)


_SERVED_MODEL_CACHE: dict = {}
_SERVED_MODEL_LOCK = threading.Lock()


def _served_model(ctx):
    """(cfg, model, params) for the serving plane, cached across VREs and
    re-instantiations per (arch, provider), so a re-applied VRE does not
    rebuild the model (17.6 GB of bf16 params for the full yi-9b). The
    model lives on the first device of the VRE's mesh; params are drawn
    from a ``torch.Generator`` there seeded with 0, so sharing them across
    VREs of the same arch is observationally identical to rebuilding."""
    from repro_torch.models.model import build_model

    key = (ctx.config.arch or "yi-9b", ctx.config.provider)
    with _SERVED_MODEL_LOCK:
        ent = _SERVED_MODEL_CACHE.get(key)
        if ent is None:
            cfg = _model_cfg(ctx)
            home = ctx.mesh.devices.flat[0]
            model = build_model(cfg, device=home)
            params = model.init(torch.Generator(device=home).manual_seed(0))
            ent = (cfg, model, params)
            _SERVED_MODEL_CACHE[key] = ent
    return ent


@register_service("volumes", "storage",
                  description="GlusterFS analogue: sharded checkpoint store")
def build_volumes(ctx):
    store = CheckpointStore(str(ctx.workdir / ctx.config.name / "volumes"),
                            num_servers=ctx.config.storage_servers)
    return ServiceHandle("volumes", "storage", store)


@register_service("data", "data",
                  description="host-sharded synthetic token pipeline")
def build_data(ctx):
    cfg = _model_cfg(ctx)
    batch = int(ctx.config.extra.get("global_batch", 8))
    seq = int(ctx.config.extra.get("seq_len", 64))
    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        embeddings_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0))
    return ServiceHandle("data", "data", data)


@register_service("lm-trainer", "train",
                  description="LM training service (train_step + state)")
def build_trainer(ctx):
    raise NotImplementedError(
        "lm-trainer: training is not ported yet (ROADMAP A.7)")


class ServingService(ServiceHandle):
    """Serving plane: ReplicaSet of async engines behind an edge router."""

    def __init__(self, replicaset: ReplicaSet, router: EdgeRouter):
        super().__init__("lm-server", "serve", replicaset)
        self.replicaset = replicaset
        self.router = router

    def start(self):
        self.replicaset.start()
        return self

    def stop(self):
        self.replicaset.stop()

    def health(self) -> bool:
        return bool(self.replicaset.healthy_engines())

    def scale(self, n: int) -> int:
        return self.replicaset.scale_to(n)

    def rebalance(self, mesh) -> dict:
        raise NotImplementedError(
            "lm-server: rebalancing onto a resized mesh is not ported yet "
            "(ROADMAP A.6)")

    def metrics(self) -> dict:
        return self.replicaset.metrics()

    def drain(self, timeout: float = 120.0):
        self.router.drain(timeout)


@register_service("lm-server", "serve",
                  description="async serving replicas + edge router")
def build_server(ctx):
    extra = ctx.config.extra
    if extra.get("autoscale"):
        raise NotImplementedError(
            "lm-server: the autoscaler is not ported yet (ROADMAP A.6)")
    cfg, model, params = _served_model(ctx)
    replicas = int(extra.get("replicas", 2))
    slots = int(extra.get("slots", 2))
    max_seq = int(extra.get("max_seq", 128))
    chunk_tokens = int(extra.get("chunk_tokens", 0))
    prefix_cache_mb = float(extra.get("prefix_cache_mb", 0))
    speculate = int(extra.get("speculate", 0) or 0)
    draft = str(extra.get("draft", "ngram"))

    recorder = None
    record_path = extra.get("record_path")
    if record_path:
        from repro_torch.observability import Recorder
        # append mode: every re-instantiation re-stamps a meta header and
        # keeps writing to the same file
        generation = int(getattr(ctx.vre, "generation", 0) or 0)
        meta = record_meta(cfg, {
            "replicas": replicas, "slots": slots, "max_seq": max_seq,
            "chunk_tokens": chunk_tokens, "prefix_cache_mb": prefix_cache_mb,
            "speculate": speculate, "draft": draft})
        meta.update(generation=generation,
                    mesh_shape=list(ctx.config.mesh_shape))
        recorder = Recorder(record_path, tenant=ctx.config.name,
                            monitor=ctx.monitor, meta=meta,
                            context={"generation": generation})
    # the ReplicaSet partitions the VRE mesh into per-replica slices
    rs = replicaset_for(model, params, replicas=replicas, slots=slots,
                        max_seq=max_seq, devices=list(ctx.mesh.devices.flat),
                        monitor=ctx.monitor, chunk_tokens=chunk_tokens,
                        prefix_cache_mb=prefix_cache_mb, speculate=speculate,
                        draft=draft, recorder=recorder,
                        slots_per_device=extra.get("slots_per_device"))
    return ServingService(rs, EdgeRouter(rs))


class WorkflowService(ServiceHandle):
    def __init__(self, scheduler: ClusterScheduler):
        super().__init__("workflows", "workflow", scheduler)
        self.scheduler = scheduler

    def new(self, name: str) -> Workflow:
        return Workflow(name)

    def run(self, wf: Workflow):
        return self.scheduler.run(wf)

    def scale(self, n: int) -> int:
        return getattr(self.scheduler, "num_workers", 1)


@register_service("workflows", "workflow",
                  description="Luigi/Pachyderm analogue: DAG tool scheduler")
def build_workflows(ctx):
    sched = ClusterScheduler(
        num_workers=int(ctx.config.extra.get("workers", 4)),
        monitor=ctx.monitor)
    return WorkflowService(sched)


class DashboardService(ServiceHandle):
    def __init__(self, monitor):
        super().__init__("dashboard", "monitor", monitor)
        self.summary = monitor.summarize
        self.events = monitor.events
        self.gauges = monitor.gauges

    def metrics(self) -> dict:
        return self.instance.summarize()


@register_service("dashboard", "monitor",
                  description="EFK analogue: metrics aggregation")
def build_dashboard(ctx):
    return DashboardService(ctx.monitor)
