"""Built-in microservices (the PhenoMeNal-style 'community of practice'
package set): data pipeline, serving engines + edge router, workflow system,
volumes (checkpoint store), monitoring dashboard.

Each builder returns a ``ServiceHandle`` — the uniform lifecycle protocol
(``start/stop/health/scale/metrics``) the VRE orchestrator manages — wrapping
the live instance.

A port of the JAX package's ``repro.core.services``. Provider ``"cpu"``
serves and trains the reduced config of the VRE's arch, the card
(``"h100"``) its full widths. ``lm-server`` has the JAX service's
autoscaler (with SLO targets), ``rebalance``, ``replicas: "auto"`` and a
fleet's shared prefix cache. ``lm-trainer`` trains every arch (dense,
MoE, the SSM ``mamba2-370m``, the hybrid ``zamba2-1.2b`` and the
``embeddings`` input archs ``musicgen-medium`` and ``internvl2-26b``, on
the ``data`` service's (B, S, d) embedding batches) with its state on the
card of the VRE's first share. ``lm-server`` builds for an ``embeddings``
arch, but its engines refuse every request (token prompts only, as in
JAX, whose engine fails at the first prefill).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.registry import ServiceHandle, register_service
from repro_torch.core.scheduler import ClusterScheduler
from repro_torch.core.workflow import Workflow
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, device_batch
from repro_torch.device import resolve_device
from repro_torch.launch.serve import model_config, record_meta, replicaset_for
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serving.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.serving.engine import EdgeRouter
from repro_torch.serving.replica import ReplicaSet


def _model_cfg(ctx):
    return model_config(ctx.config.arch or "yi-9b", ctx.config.provider)


_SERVED_MODEL_CACHE: dict = {}
_SERVED_MODEL_LOCK = threading.Lock()


def _served_model(ctx):
    """(cfg, model, params) for the serving plane, cached across VREs and
    re-instantiations per (arch, provider), so a re-applied VRE does not
    rebuild the model (17.6 GB of bf16 params for the full yi-9b): an
    elastic resize or a fleet re-admission reuses them. The model lives on
    the card of the first share of the VRE's mesh; params are drawn
    from a ``torch.Generator`` there seeded with 0, so sharing them across
    VREs of the same arch is observationally identical to rebuilding."""
    from repro_torch.models.model import build_model

    key = (ctx.config.arch or "yi-9b", ctx.config.provider)
    with _SERVED_MODEL_LOCK:
        ent = _SERVED_MODEL_CACHE.get(key)
        if ent is None:
            cfg = _model_cfg(ctx)
            home = resolve_device(ctx.mesh.devices.flat[0])
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


class TrainerService(ServiceHandle):
    """LM training service: the train step over a mutable train state on
    the model's device."""

    def __init__(self, ctx, cfg, model, state, step_fn):
        super().__init__("lm-trainer", "train", model)
        self.ctx = ctx
        self.cfg = cfg
        self.model = model
        self.state = state
        self.step = 0
        self.history = []
        self._step_fn = step_fn

    def train_steps(self, data, n: int):
        """``n`` steps on ``data``'s batches from its first (as the JAX
        service iterates it anew each call); returns their losses."""
        it = iter(data)
        for _ in range(n):
            batch = device_batch(next(it), self.model.device)
            self.state, metrics = self._step_fn(self.state, batch)
            self.step += 1
            loss = float(metrics["loss"])
            self.history.append(loss)
            self.ctx.monitor.log("lm-trainer", "step", step=self.step,
                                 loss=loss)
        return self.history[-n:]

    def health(self) -> bool:
        return not self.history or bool(np.isfinite(self.history[-1]))

    def metrics(self) -> dict:
        return {"step": self.step,
                "loss": self.history[-1] if self.history else None}


@register_service("lm-trainer", "train",
                  description="LM training service (train_step + state)")
def build_trainer(ctx):
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                                 make_train_step)
    cfg = _model_cfg(ctx)
    home = resolve_device(ctx.mesh.devices.flat[0])
    model = build_model(cfg, device=home)
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    mb = int(ctx.config.extra.get("microbatches", 1))
    step_fn = make_train_step(model, cfg, opt_cfg,
                              TrainStepConfig(microbatches=mb))
    state = init_state(model, opt_cfg,
                       torch.Generator(device=home).manual_seed(0))
    return TrainerService(ctx, cfg, model, state, step_fn)


class ServingService(ServiceHandle):
    """Serving plane: ReplicaSet of async engines behind an edge router,
    with an optional load-driven autoscaler."""

    def __init__(self, replicaset: ReplicaSet, router: EdgeRouter,
                 autoscaler: Autoscaler = None):
        super().__init__("lm-server", "serve", replicaset)
        self.replicaset = replicaset
        self.router = router
        self.autoscaler = autoscaler

    def start(self):
        self.replicaset.start()
        if self.autoscaler is not None:
            self.autoscaler.run()
        return self

    def stop(self):
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.replicaset.stop()

    def health(self) -> bool:
        return bool(self.replicaset.healthy_engines())

    def scale(self, n: int) -> int:
        return self.replicaset.scale_to(n)

    def rebalance(self, mesh) -> dict:
        return self.replicaset.rebalance(mesh)

    def metrics(self) -> dict:
        return self.replicaset.metrics()

    def drain(self, timeout: float = 120.0):
        self.router.drain(timeout)


@register_service("lm-server", "serve",
                  description="async serving replicas + edge router + "
                              "autoscaler")
def build_server(ctx):
    extra = ctx.config.extra
    cfg, model, params = _served_model(ctx)
    replicas_cfg = extra.get("replicas", 2)
    if replicas_cfg == "auto":
        # one replica per granted mesh device: a fleet-arbitrated grant
        # change then changes serving capacity on re-instantiation
        replicas = max(1, int(ctx.mesh.devices.size)
                       if ctx.mesh is not None else 1)
    else:
        replicas = int(replicas_cfg)
    slots = int(extra.get("slots", 2))
    max_seq = int(extra.get("max_seq", 128))
    chunk_tokens = int(extra.get("chunk_tokens", 0))
    prefix_cache_mb = float(extra.get("prefix_cache_mb", 0))
    speculate = int(extra.get("speculate", 0) or 0)
    draft = str(extra.get("draft", "ngram"))
    prefix_cache = None
    shared = extra.get("shared_prefix_cache")
    if shared is not None and chunk_tokens \
            and getattr(shared, "chunk", None) == chunk_tokens:
        # fleet-shared cache (FleetArbiter): VREs serving the same arch
        # warm each other's prompt heads; entries are host-side, so the
        # cache outlives any one VRE's placement
        prefix_cache = shared

    recorder = None
    record_path = extra.get("record_path")
    if record_path:
        from repro_torch.observability import Recorder
        # append mode: every re-instantiation (elastic resize, fleet
        # preemption) re-stamps a meta header and keeps writing to the same
        # file, so one store holds the request's whole multi-generation story
        generation = int(getattr(ctx.vre, "generation", 0) or 0)
        context = {"generation": generation}
        arbiter = getattr(ctx.vre, "arbiter", None)
        wait = getattr(arbiter, "_queue_wait_s", {}).get(ctx.config.name) \
            if arbiter is not None else None
        if wait is not None:
            context["admission_wait_s"] = round(float(wait), 6)
        meta = record_meta(cfg, {
            "replicas": replicas, "slots": slots, "max_seq": max_seq,
            "chunk_tokens": chunk_tokens, "prefix_cache_mb": prefix_cache_mb,
            "speculate": speculate, "draft": draft})
        meta.update(generation=generation,
                    mesh_shape=list(ctx.config.mesh_shape))
        recorder = Recorder(record_path, tenant=ctx.config.name,
                            monitor=ctx.monitor, meta=meta, context=context)
    # the ReplicaSet partitions the VRE mesh into per-replica slices, so
    # "scale the mesh" changes the devices replicas occupy
    rs = replicaset_for(model, params, replicas=replicas, slots=slots,
                        max_seq=max_seq, devices=list(ctx.mesh.devices.flat),
                        monitor=ctx.monitor, chunk_tokens=chunk_tokens,
                        prefix_cache_mb=prefix_cache_mb, speculate=speculate,
                        draft=draft, recorder=recorder,
                        slots_per_device=extra.get("slots_per_device"),
                        prefix_cache=prefix_cache)
    router = EdgeRouter(rs)
    autoscaler = None
    if extra.get("autoscale"):
        as_cfg = AutoscalerConfig(
            min_replicas=int(extra.get("min_replicas", 1)),
            max_replicas=int(extra.get("max_replicas", max(replicas, 4))),
            scale_up_prefill_tokens=(
                float(extra["scale_up_prefill_tokens"])
                if extra.get("scale_up_prefill_tokens") is not None
                else None))
        slo_engine = None
        slo_cfg = extra.get("slo")
        if isinstance(slo_cfg, dict) and slo_cfg:
            # declarative SLO targets ride the autoscaler: error-budget burn
            # becomes a growth trigger alongside raw load, and the burn rate
            # travels with resize proposals into the arbiter
            from repro_torch.observability.slo import (SLOEngine,
                                                       targets_from_config)
            slo_engine = SLOEngine(
                ctx.monitor, targets_from_config(slo_cfg),
                services=lambda: [e.name for e in rs.engines],
                burn_threshold=float(slo_cfg.get("burn_threshold", 1.0)),
                name=f"{ctx.config.name}-slo")
        autoscaler = Autoscaler(rs, ctx.monitor, as_cfg,
                                resize_mesh=getattr(ctx.vre, "request_resize",
                                                    None),
                                slo=slo_engine)
    return ServingService(rs, router, autoscaler)


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
