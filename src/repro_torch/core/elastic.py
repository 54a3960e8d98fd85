"""Elastic scaling: resize a VRE's mesh and carry live state through the
volume (checkpoint) service. On-demand VREs procure what they need, when
they need it (the paper's core thesis) — growing from 1 device to 2 mid-run
is just: checkpoint -> destroy -> instantiate(new mesh) -> restore (the
served-model cache makes the re-instantiation cheap).

``resize_serving`` is the serving-plane entry point: it applies a pending
resize *without losing in-flight requests* — incomplete requests are
detached from the old replica pool before the destroy and adopted by the
successor pool on the grown mesh, so their futures resolve transparently
across the resize (greedy decode is deterministic, so the tokens are
identical to a no-resize run).

A port of the JAX package's ``repro.core.elastic``. The devices a resize
can reach are the VRE's ``device_pool`` (a fleet grant, or a pool of shares
of the card) or else the provider's ``device_pool``; the old pool's engines
are dropped before the successor allocates its KV caches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np

from repro_torch.device import device_pool


@dataclasses.dataclass
class ResizeReport:
    old_shape: tuple
    new_shape: tuple
    checkpoint_s: float
    reinstantiate_s: float
    restore_s: float
    deployment: Optional[dict] = None


def resize_if_requested(vre, state: Any = None,
                        reshard: Optional[Callable] = None
                        ) -> Tuple[Optional[ResizeReport], Any]:
    """Apply an autoscaler-requested mesh resize at a safe point. Returns
    ``(report, restored_state)``; when nothing is pending it is a no-op
    returning ``(None, state)`` so callers can unpack uniformly."""
    if vre.pending_resize is None:
        return None, state
    return vre.resize(vre.pending_resize, state=state,
                      state_reshard=reshard)


def resize(vre, new_mesh_shape: tuple, state: Any = None,
           reshard: Optional[Callable] = None
           ) -> Tuple[ResizeReport, Any]:
    """reshard(store, new_mesh, state_like) -> restored state.

    When ``state`` is given, it round-trips through the VRE's checkpoint
    store; otherwise only the services move. Returns
    ``(ResizeReport, restored_state_or_None)``.
    """
    old_shape = vre.config.mesh_shape
    store = None
    t0 = time.perf_counter()
    if state is not None:
        store = vre.service("volumes") if "volumes" in vre.services else None
        if store is None:
            from repro_torch.checkpoint.store import CheckpointStore
            store = CheckpointStore(
                str(vre.image_cache.root.parent / "elastic_ckpt"),
                num_servers=vre.config.storage_servers)
        store.save(state, step=0, blocking=True)
    t1 = time.perf_counter()

    vre.destroy()
    vre.config = dataclasses.replace(vre.config, mesh_shape=new_mesh_shape) \
        if dataclasses.is_dataclass(vre.config) else vre.config
    report = vre.instantiate()
    t2 = time.perf_counter()

    restored = None
    if state is not None:
        if reshard is not None:
            restored = reshard(store, vre.mesh, state)
        else:
            restored = store.restore(state, step=0)
    t3 = time.perf_counter()
    return ResizeReport(old_shape, new_mesh_shape,
                        checkpoint_s=t1 - t0,
                        reinstantiate_s=t2 - t1,
                        restore_s=t3 - t2,
                        deployment=report.to_json()), restored


def resize_serving(vre, service: str = "lm-server") -> Optional[dict]:
    """Apply a pending mesh resize under a live serving plane.

    Sequence: stop the old autoscaler, detach every incomplete request off
    the old replica pool (futures stay attached to their waiters), run the
    destructive resize (destroy -> re-instantiate on the grown mesh; the
    rebuilt ``lm-server`` partitions the new mesh into per-replica slices),
    then have the successor pool adopt the carried requests.

    No-op (returns None) when nothing is pending. A pending shape the
    device pool cannot satisfy is cleared and logged rather than raised —
    the autoscaler may re-request once more capacity exists.
    """
    if vre.pending_resize is None:
        return None
    need = int(np.prod(vre.pending_resize))
    # a fleet-arbitrated VRE (or one given shares of a card) resizes within
    # its own pool, not against the whole provider
    have = (len(vre.device_pool) if vre.device_pool is not None
            else len(device_pool(vre.config.provider)))
    if have < need:
        vre.monitor.log("vre", "resize_infeasible",
                        want=need, have=have,
                        shape=list(vre.pending_resize))
        vre.pending_resize = None
        if service in vre.services:
            # re-arm the autoscaler: still-saturated load may request again
            scaler = getattr(vre.service(service), "autoscaler", None)
            if scaler is not None:
                scaler.notify_resized()
        return None

    # classify the disruption before the config mutates: a device-count
    # shrink is a preemption (the arbiter clawing capacity back), anything
    # else is a plain resize — carried requests' records name which one
    # they rode through
    old_shape = tuple(vre.config.mesh_shape)
    new_shape = tuple(vre.pending_resize)
    kind = "preemption" if int(np.prod(new_shape)) < int(np.prod(old_shape)) \
        else "resize"
    t0 = time.perf_counter()
    carried = []
    old_prefix_cache = None
    recorder = None
    if service in vre.services:
        handle = vre.service(service)
        scaler = getattr(handle, "autoscaler", None)
        if scaler is not None:
            scaler.stop()
        rs = getattr(handle, "replicaset", None)
        if rs is not None:
            carried = rs.detach_requests()
            old_prefix_cache = getattr(rs, "prefix_cache", None)
        # the old pool's engines (and their KV caches) must be free before
        # the successor allocates its own
        handle = scaler = rs = None
    for r in carried:
        r.trace.event(kind, old_shape=list(old_shape),
                      new_shape=list(new_shape))
    try:
        report, _ = resize_if_requested(vre)
        new_rs = getattr(vre.service(service), "replicaset", None) \
            if service in vre.services else None
        # the old pool's recorder was stopped with its service during the
        # destroy; the successor appends to the same record file
        recorder = getattr(new_rs, "recorder", None)
        if new_rs is not None and carried:
            new_rs.adopt(carried)
        if new_rs is not None and old_prefix_cache is not None:
            # prefix-cache entries are host-side and device-agnostic: carry
            # them so shared prompt heads stay warm across the resize
            new_rs.adopt_prefix_cache(old_prefix_cache)
    except BaseException as exc:
        # the re-instantiation failed with the requests already detached:
        # fail their futures rather than leave waiters blocked forever
        for r in carried:
            if not r.future.done():
                r.future.set_exception(RuntimeError(
                    f"mesh resize failed with the request detached: "
                    f"{exc!r}"))
        raise
    downtime = time.perf_counter() - t0
    vre.monitor.log("vre", "resize_applied",
                    old=list(report.old_shape), new=list(report.new_shape),
                    carried_requests=len(carried), downtime_s=downtime)
    if recorder is not None:
        # control-plane record in the same JSONL stream the per-request
        # records land in
        recorder.control(kind, old_shape=list(old_shape),
                         new_shape=list(new_shape),
                         carried_requests=len(carried),
                         downtime_s=round(downtime, 6))
    return {"report": report, "downtime_s": downtime,
            "carried_requests": len(carried)}
