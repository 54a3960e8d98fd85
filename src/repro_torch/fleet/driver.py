"""Fleet driver: several VREs over one shared pool, phase-shifted load.

The workload is the paper's usage pattern: communities of practice arrive
*on demand* — each phase a new tenant shows up, runs its hot Poisson wave
(earlier tenants keep a cold trickle), and stays resident. Under the
arbiter a tenant that does not fit queues, admission pressure preemptively
shrinks lower-priority residents toward their claim minima (their in-flight
requests ride the drain/adopt resize), and — because every tenant runs the
same pipeline over different payloads — the *fleet-shared* prefix cache
means a freshly admitted tenant's prompts land on an already-warm head.

The static equal-split baseline pre-partitions the pool: every tenant owns
a fixed slice and its own private cache from the start, so a hot tenant is
forever capped at ``pool/n`` of the capacity while its neighbours idle,
and nobody can be preempted, queued — or helped. Aggregate tokens per wall
second over the same phase schedule is the number the arbiter has to beat;
the gated margin comes from capacity following the load, with the shared
cache equalizing each freshly admitted tenant against static's
long-resident (self-warmed) ones.

A port of the JAX package's ``repro.fleet.driver``. Tenants serve on
``provider`` (the card by default, ``"cpu"`` for the reduced model on the
host) over a pool of ``DeviceShare``s (``repro_torch.device``): with
``slots_per_device`` a tenant's granted shares set its decode-slot budget
and its one replica computes on the card of its first share. The report
adds ``pool_cards``, the distinct cards behind the pool's shares.
"""
from __future__ import annotations

import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from repro_torch.device import device_pool
from repro_torch.launch.serve import (make_prompts, merged_poisson_load,
                                      serve_report)

DEFAULT_WORKDIR = str(Path(tempfile.gettempdir()) / "fleet")


def fleet_vre_config(name: str, *, arch: str = "yi-9b",
                     workdir: str = DEFAULT_WORKDIR, provider: str = "h100",
                     mesh_shape: tuple = (1, 1),
                     replicas="auto", slots: int = 3, max_seq: int = 96,
                     slots_per_device: Optional[int] = None,
                     chunk_tokens: int = 0, prefix_cache_mb: float = 0.0,
                     speculate: int = 0, record_path: Optional[str] = None,
                     extra: Optional[dict] = None):
    """A serving-plane VREConfig for fleet runs. ``replicas="auto"`` ties
    the replica count to the granted mesh (real accelerators: more devices,
    more replicas). ``slots_per_device`` instead ties *decode-slot
    capacity* to the grant (KV memory scales with devices) with a single
    replica — the right mapping where shares of one card (or of the host)
    stand for devices: extra decode threads would only contend."""
    from repro_torch.core.vre import VREConfig
    cfg_extra = {"replicas": replicas, "slots": slots, "max_seq": max_seq}
    if slots_per_device:
        cfg_extra["replicas"] = 1
        cfg_extra["slots_per_device"] = int(slots_per_device)
    if chunk_tokens:
        cfg_extra["chunk_tokens"] = chunk_tokens
    if prefix_cache_mb:
        cfg_extra["prefix_cache_mb"] = prefix_cache_mb
    if speculate:
        cfg_extra["speculate"] = int(speculate)
    if record_path:
        cfg_extra["record_path"] = str(record_path)
    if extra:
        cfg_extra.update(extra)
    return VREConfig(name=name, mesh_shape=tuple(mesh_shape),
                     services=["lm-server"], arch=arch, workdir=workdir,
                     provider=provider, extra=cfg_extra)


def _replicaset(vre):
    return vre.service("lm-server").replicaset


def run_fleet(arbiter, specs: List[tuple], *, requests_per_phase: int = 12,
              rate_rps: float = 30.0, cold_rate_fraction: float = 0.1,
              max_new_tokens: int = 4, shared_prefix_len: int = 0,
              carry_requests: int = 2, wave_repeats: int = 2, rng=None,
              timeout_s: float = 300.0, static: bool = False,
              auto_tick: bool = False) -> dict:
    """Drive ``specs`` — a list of ``(config, claim)`` — through one hot
    phase each. Arbitrated mode admits tenant ``i`` at the start of phase
    ``i`` (later tenants queue, admission pressure preempts, grants are
    applied with ``carry_requests`` already in flight per resident); static
    mode admits everyone up front on their pre-split meshes and never moves
    a device. Phase walls measure steady state (per-replica warmup after
    every admission/grant shuffle); each phase's wave runs ``wave_repeats``
    times and the best wall is reported — a transient CPU-contention spike
    on a shared runner must not decide the gated arbitrated/static ratio —
    while completion counts cover every repeat; carried requests are gated
    on completion, not throughput."""
    rng = rng if rng is not None else np.random.default_rng(0)
    names = [cfg.name for cfg, _ in specs]
    vres = {}

    def admit(i):
        out = arbiter.submit(*specs[i])
        if out["status"] == "admitted":
            vres[names[i]] = out["vre"]
        return out

    def refresh():
        for n in list(vres):
            vres[n] = arbiter.vre(n)

    def vocab():
        return _replicaset(next(iter(vres.values()))) \
            .engines[0].cfg.vocab_size

    heads = {}

    def _head(which):
        """Fixed prompt heads: "load" is the pipeline head every tenant's
        real traffic shares (seed-pinned so both benchmark modes face the
        identical workload); "warm" is a *distinct* same-length head used
        only by warmup and carried traffic, so that what seeds the
        measured head into a cache is the measured workload itself, never
        the harness."""
        if which not in heads:
            seed = {"load": 12345, "warm": 54321}[which]
            heads[which] = np.random.default_rng(seed).integers(
                1, vocab(), size=shared_prefix_len)
        return heads[which]

    def _prompts(n, which):
        if not shared_prefix_len:
            return make_prompts(n, vocab(), rng)
        # payload tails come from the run rng (--seed varies traffic);
        # only the shared head is pinned
        return [np.concatenate([_head(which), rng.integers(
            1, vocab(), size=int(rng.integers(4, 13)))]) for _ in range(n)]

    def phase_prompts(n):
        return _prompts(n, "load")

    def warm_prompts(n):
        return _prompts(n, "warm")

    def warm_all():
        """Two tiny concurrent requests per replica of every resident,
        awaited: jit caches are per committed device (and per slot count),
        so first-call compiles — including the batched multi-slot chunk
        path (needs >= 2 slots prefilling at once) and the prefix-cache
        restore of a full head chain (the second request hits the head the
        first just seeded) — land outside the measured windows. Phases
        then compare steady-state serving, not compiler throughput. The
        warm head is disjoint from the load head, so warmup never
        pre-seeds what the measured waves are measuring."""
        warm = []
        for v in vres.values():
            for e in list(_replicaset(v).engines):
                warm += [e.submit_request(warm_prompts(1)[0],
                                          max_new_tokens=2)
                         for _ in range(2)]
        for w in warm:
            w.future.result(timeout=timeout_s)
        if shared_prefix_len:
            # a second, sequential round: the warm head is now seeded, so
            # these hit and compile the restore path — at *every* chain
            # depth (a mid-wave lookup can catch a partially inserted
            # chain, and each covered length is its own compile)
            chunk = int(specs[0][0].extra.get("chunk_tokens", 0)) \
                or max(1, shared_prefix_len // 3)
            late = []
            for v in vres.values():
                for e in list(_replicaset(v).engines):
                    for depth in range(chunk, shared_prefix_len + 1, chunk):
                        p = np.concatenate([
                            _head("warm")[:depth],
                            rng.integers(1, vocab(), size=5)])
                        late.append(e.submit_request(p, max_new_tokens=2))
            for w in late:
                w.future.result(timeout=timeout_s)

    if static:
        for i in range(len(specs)):
            out = admit(i)
            assert out["status"] == "admitted", (names[i], out)
    else:
        out = admit(0)
        assert out["status"] == "admitted", (names[0], out)

    phase_reports, admission_events = [], []
    total_requests = total_completed = total_tokens = 0
    carried_submitted = carried_completed = 0
    measured_wall = 0.0
    warm_all()
    for pi in range(len(specs)):
        # requests in flight across the upcoming admission/grant shuffle —
        # they ride the drain/adopt path through any preemption and are
        # accounted separately from the measured Poisson load (warm-head
        # prompts: survival is what's tested, not cache seeding)
        carried = []
        for n in vres:
            carried += [_replicaset(vres[n]).submit_request(
                p, max_new_tokens=max_new_tokens)
                for p in warm_prompts(carry_requests)]
        if not static and pi > 0:
            t_arrive = time.monotonic()
            out = admit(pi)
            if out["status"] == "queued":
                if auto_tick:
                    # the arbiter's background ticker owns the control loop
                    # (tick -> apply_pending -> tick): wait for it to admit
                    # rather than pumping by hand
                    deadline = time.monotonic() + timeout_s
                    while arbiter.vre(names[pi]) is None:
                        assert time.monotonic() < deadline, (
                            names[pi], "ticker did not admit",
                            arbiter.status())
                        time.sleep(0.01)
                else:
                    # admission pressure: reserve preemptive shrinks, apply
                    # them (in-flight work carried), then admit off the
                    # queue
                    arbiter.tick()
                    arbiter.apply_pending()
                    ticked = arbiter.tick()
                    assert names[pi] in ticked["admitted"], (
                        names[pi], ticked, arbiter.status())
                vres[names[pi]] = arbiter.vre(names[pi])
            refresh()
            admission_events.append({
                "phase": pi, "vre": names[pi],
                "queued": out["status"] == "queued",
                "admission_wall_s": time.monotonic() - t_arrive,
            })
        for r in carried:
            r.future.result(timeout=timeout_s)      # zero-drop criterion
            carried_completed += 1
        carried_submitted += len(carried)
        warm_all()
        best = None
        for _ in range(max(1, wave_repeats)):
            baselines = {n: dict(_replicaset(vres[n]).metrics()["total"])
                         for n in vres}
            streams = []
            for n in vres:
                share = 1.0 if n == names[pi] else cold_rate_fraction
                n_req = max(1, int(round(requests_per_phase * share)))
                streams.append((n, _replicaset(vres[n]).submit_request,
                                phase_prompts(n_req), rate_rps * share))
            t0 = time.perf_counter()
            reqs_by_vre = merged_poisson_load(streams, rng,
                                              max_new_tokens=max_new_tokens)
            for reqs in reqs_by_vre.values():
                for r in reqs:
                    r.future.result(timeout=timeout_s)
            wall = time.perf_counter() - t0
            prep = {}
            for n in vres:
                rep = serve_report(reqs_by_vre[n], wall,
                                   _replicaset(vres[n]), baselines[n])
                rep["mesh"] = list(vres[n].config.mesh_shape)
                rep["hot"] = n == names[pi]
                prep[n] = rep
                total_requests += rep["requests"]   # completion counts every
                total_completed += rep["completed"]  # repeat
            if best is None or wall < best[0]:
                best = (wall, prep)
        wall, prep = best
        measured_wall += wall
        total_tokens += sum(r["tokens"] for r in prep.values())
        phase_reports.append(prep)
    per_vre = {}
    for n in names:
        reps = [p[n] for p in phase_reports if n in p]
        toks = sum(r["tokens"] for r in reps)
        ttfts = [r["ttft_p50_s"] for r in reps
                 if r["ttft_p50_s"] is not None]
        per_vre[n] = {
            "tokens": toks,
            "tok_per_s": toks / measured_wall if measured_wall else 0.0,
            "queue_wait_p50_s": (sorted(ttfts)[len(ttfts) // 2]
                                 if ttfts else None),
            "final_mesh": list(vres[n].config.mesh_shape),
        }
    status = arbiter.status()
    return {
        "phases": phase_reports,
        "admissions": admission_events,
        "per_vre": per_vre,
        "arbiter": {"preemptions": status["preemptions"],
                    "admissions": status["admissions"],
                    "grants": status["grants"],
                    "queue_wait_s": status["queue_wait_s"]},
        "carried": {"requests": carried_submitted,
                    "completed": carried_completed},
        "requests": total_requests,
        "completed": total_completed,
        "completion_rate": (total_completed / total_requests
                            if total_requests else 1.0),
        "tokens": total_tokens,
        "wall_s": measured_wall,
        "tok_per_s": total_tokens / measured_wall if measured_wall else 0.0,
    }


def run_fleet_scenario(n_vres: int = 2, *, devices=None, arch: str = "yi-9b",
                       provider: str = "h100", workdir: str = DEFAULT_WORKDIR,
                       requests_per_phase: int = 32, rate_rps: float = 400.0,
                       max_new_tokens: int = 24, slots_per_device: int = 2,
                       wave_repeats: int = 3,
                       max_seq: int = 96, chunk_tokens: int = 16,
                       prefix_cache_mb: float = 32.0,
                       shared_prefix_len: int = 48,
                       static: bool = False, endpoint_ttl_s: float = 30.0,
                       tick_interval_s: Optional[float] = None,
                       speculate: int = 0,
                       record_dir: Optional[str] = None,
                       telemetry_port: Optional[int] = None,
                       rng=None) -> dict:
    """The benchmark scenario: ``n_vres`` same-pipeline tenants arrive one
    per phase over one shared pool and burst (a saturating Poisson wave) on
    arrival. Capacity is ``slots_per_device``: a tenant's granted devices
    set its concurrent decode-slot budget (KV memory scales with devices;
    compute commits to one device per replica — see ``replicaset_for``).
    Arbitrated mode gives each arriving tenant most of the pool, admission
    pressure preempting colder, lower-priority residents to their claim
    minimum; static mode splits the pool equally up front, so a hot tenant
    is forever capped at ``pool/n`` devices of slot budget while its
    neighbours idle. Under phase-shifted saturation that capacity movement
    is the aggregate-throughput win the benchmark gates on."""
    from repro_torch.fleet.arbiter import FleetArbiter, ResourceClaim

    if devices is None:
        devices = device_pool(provider)
    devices = list(devices)
    pool = len(devices)
    assert pool >= max(n_vres, 2), \
        f"{n_vres} tenants need a pool of >= {max(n_vres, 2)} devices"
    arbiter = FleetArbiter(devices=devices,
                           endpoint_ttl_s=endpoint_ttl_s,
                           share_prefix_caches=not static)
    auto_tick = bool(tick_interval_s) and not static
    if auto_tick:
        arbiter.start_ticker(tick_interval_s)
    telemetry = None
    if telemetry_port is not None:
        # fleet-wide live scrape surface for the duration of the scenario:
        # tenants appear in /vres as they are admitted and leave on release
        from repro_torch.observability import fleet_telemetry
        telemetry = fleet_telemetry(arbiter, port=telemetry_port)
    burst = pool - (n_vres - 1)      # hot grant: rest stay at their minima
    specs = []
    for i in range(n_vres):
        if static:
            # equal split with the remainder spread over the first tenants:
            # the static baseline must use the whole pool, or the gated
            # speedup would partly measure permanently idle devices
            mesh = (pool // n_vres + (1 if i < pool % n_vres else 0), 1)
        else:
            mesh = (burst, 1)
        cfg = fleet_vre_config(
            f"vre{i}", arch=arch, workdir=workdir, provider=provider,
            mesh_shape=mesh,
            slots_per_device=slots_per_device, max_seq=max_seq,
            chunk_tokens=chunk_tokens, prefix_cache_mb=prefix_cache_mb,
            speculate=speculate,
            record_path=(f"{record_dir}/{f'vre{i}'}.jsonl"
                         if record_dir else None))
        claim = ResourceClaim(min_devices=1, max_devices=pool,
                              priority=i)
        specs.append((cfg, claim))
    try:
        report = run_fleet(
            arbiter, specs, requests_per_phase=requests_per_phase,
            rate_rps=rate_rps, max_new_tokens=max_new_tokens,
            shared_prefix_len=shared_prefix_len,
            wave_repeats=wave_repeats,
            rng=rng if rng is not None else np.random.default_rng(0),
            static=static, auto_tick=auto_tick)
    finally:
        arbiter.stop_ticker()
        for cfg, _ in specs:
            try:
                arbiter.release(cfg.name)
            except KeyError:
                pass
        if telemetry is not None:
            telemetry.stop()
    if telemetry is not None:
        report["telemetry"] = {"url": telemetry.url,
                               "scrapes": telemetry.scrapes}
    report["mode"] = "static" if static else "arbitrated"
    report["pool_devices"] = pool
    # a pool of shares is not a pool of cards: name the cards behind it
    report["pool_cards"] = sorted({str(getattr(d, "device", d))
                                   for d in devices})
    if record_dir:
        # releases above stopped every recorder, so the on-disk store is
        # complete; fold its summary into the fleet report
        from repro_torch.observability import RecordStore
        report["records"] = RecordStore.load(record_dir).summary()
    return report
