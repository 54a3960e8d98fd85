"""``kn``-style CLI (paper Fig. 4): init -> apply -> install -> destroy.

  python -m repro_torch.cli init <provider> <dir>   # directory + template
  python -m repro_torch.cli apply --dir <dir>       # instantiate the VRE
  python -m repro_torch.cli install <package> --dir <dir>  # add a package
  python -m repro_torch.cli status --dir <dir>
  python -m repro_torch.cli serve --dir <dir> [--record R.jsonl]
  python -m repro_torch.cli serve --dir <dir> --waves 2 --autoscale \
      --force-resize --telemetry-port 0    # elastic serving, live /metrics
  python -m repro_torch.cli fleet --vres 2   # VREs over one shared pool
  python -m repro_torch.cli trace --records R.jsonl [--json]
  python -m repro_torch.cli destroy --dir <dir>

``apply`` performs the full deployment (device procurement + service
builds), persists the manifest, and leaves the image cache warm so the next
``apply`` is fast — the on-demand usage pattern from the paper. The
provider is ``h100`` (every visible card; the default) or ``cpu`` (the
reduced model on the host).

``REPRO_TORCH_DEVICE_SHARES=N`` gives ``serve`` and ``fleet`` a pool of N
shares of each device (``repro_torch.device.device_pool``), so one card can
host a mesh resize from (1, 1) to (2, 1) or a fleet of N tenants: the
counterpart of the JAX CLI's forced host device count.

A port of the JAX package's ``repro.cli`` with its arguments, messages and
JSON output; ``fleet`` also takes ``--provider``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

TEMPLATE = {
    "name": "my-vre",
    "provider": "h100",
    "mesh_shape": [1, 1],
    "mesh_axes": ["data", "model"],
    "arch": "yi-9b",
    "services": ["volumes", "data", "dashboard", "workflows"],
    "extra": {"global_batch": 8, "seq_len": 64, "workers": 4},
}


def _load_vre(dirpath: Path):
    import repro_torch.core.services  # noqa: F401  (registers builtin packages)
    from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment
    cfg_raw = json.loads((dirpath / "vre.json").read_text())
    cfg = VREConfig(
        name=cfg_raw["name"],
        mesh_shape=tuple(cfg_raw["mesh_shape"]),
        mesh_axes=tuple(cfg_raw["mesh_axes"]),
        services=list(cfg_raw.get("services", [])),
        arch=cfg_raw.get("arch"),
        provider=cfg_raw.get("provider", "h100"),
        workdir=str(dirpath / ".vre"),
        extra=cfg_raw.get("extra", {}),
    )
    return VirtualResearchEnvironment(cfg), cfg_raw


def cmd_init(args):
    d = Path(args.directory)
    d.mkdir(parents=True, exist_ok=True)
    cfg = dict(TEMPLATE)
    cfg["provider"] = args.provider
    (d / "vre.json").write_text(json.dumps(cfg, indent=2))
    print(f"initialized deployment directory {d} (edit vre.json, then "
          f"`python -m repro_torch.cli apply --dir {d}`)")


def cmd_apply(args):
    d = Path(args.dir)
    vre, raw = _load_vre(d)
    t0 = time.perf_counter()
    report = vre.instantiate()
    dt = time.perf_counter() - t0
    manifest = {"applied_at": time.time(), "status": vre.status(),
                "deployment": report.to_json(), "wall_s": dt}
    (d / "manifest.json").write_text(json.dumps(manifest, indent=2,
                                                default=str))
    print(json.dumps(report.to_json(), indent=2))
    print(f"VRE {vre.config.name!r} RUNNING "
          f"({len(vre.services)} services, {dt:.2f}s; warm cache makes the "
          f"next apply faster)")
    vre.destroy()


def cmd_install(args):
    d = Path(args.dir)
    cfg = json.loads((d / "vre.json").read_text())
    if args.package not in cfg["services"]:
        cfg["services"].append(args.package)
    (d / "vre.json").write_text(json.dumps(cfg, indent=2))
    print(f"installed package {args.package!r}; re-apply to deploy")


def cmd_status(args):
    d = Path(args.dir)
    m = d / "manifest.json"
    if not m.exists():
        print("no manifest — VRE was never applied")
        return
    print(m.read_text())


def _shares(cmd: str):
    """The share count of ``REPRO_TORCH_DEVICE_SHARES`` (None when unset);
    a malformed value exits naming the command."""
    from repro_torch.device import shares_from_env
    try:
        return shares_from_env()
    except ValueError as exc:
        sys.exit(f"{cmd}: {exc}")


def cmd_serve(args):
    """Instantiate the VRE's serving plane and drive it with an open-loop
    Poisson load; prints the serving-contract report JSON (and returns
    it).

    With ``--waves N`` (N > 1) the load arrives in waves and any
    autoscaler-requested mesh resize is applied between waves — the elastic
    end-to-end path: drain, re-instantiate on the grown mesh, re-place
    replicas on disjoint slices, resume."""
    import numpy as np
    from repro_torch.device import device_pool
    from repro_torch.launch.serve import (make_prompts, run_elastic_serve,
                                          run_load, validate_serving_args)

    validate_serving_args(args, lambda msg: sys.exit(f"serve: {msg}"))
    shares = _shares("serve")
    args.chunk_tokens = args.chunk_tokens or 0
    args.prefix_cache_mb = args.prefix_cache_mb or 0.0
    args.speculate = args.speculate or 0
    d = Path(args.dir)
    vre, _ = _load_vre(d)
    if "lm-server" not in vre.config.services:
        vre.config.services.append("lm-server")
    if shares is not None:
        # the pool a resize can reach: shares of each device
        vre.device_pool = device_pool(vre.config.provider, shares)
    if args.autoscale:
        vre.config.extra["autoscale"] = True
    if args.chunk_tokens:
        vre.config.extra["chunk_tokens"] = args.chunk_tokens
    if args.prefix_cache_mb:
        vre.config.extra["prefix_cache_mb"] = args.prefix_cache_mb
    if args.speculate:
        vre.config.extra["speculate"] = args.speculate
        vre.config.extra["draft"] = args.draft or "ngram"
    if args.record:
        vre.config.extra["record_path"] = args.record
    vre.instantiate()
    telemetry = None
    try:
        if args.telemetry_port is not None:
            from repro_torch.observability import vre_telemetry
            telemetry = vre_telemetry(
                vre, port=args.telemetry_port,
                slo=getattr(vre.service("lm-server").autoscaler, "slo",
                            None))
            print(f"telemetry: {telemetry.url}/metrics "
                  f"{telemetry.url}/healthz", file=sys.stderr)
        rng = np.random.default_rng(args.seed)
        if args.waves > 1:
            report = run_elastic_serve(
                vre, waves=args.waves, requests_per_wave=args.requests,
                rate_rps=args.rate, max_new_tokens=args.max_new, rng=rng,
                force_resize=args.force_resize)
        else:
            rs = vre.service("lm-server").replicaset
            prompts = make_prompts(args.requests,
                                   rs.engines[0].cfg.vocab_size, rng)
            report = run_load(rs, prompts, rate_rps=args.rate,
                              max_new_tokens=args.max_new, rng=rng)
        if telemetry is not None:
            report["telemetry"] = {"url": telemetry.url,
                                   "scrapes": telemetry.scrapes}
        print(json.dumps(report, indent=2))
    finally:
        if telemetry is not None:
            telemetry.stop()
        vre.destroy()
    return report


def cmd_fleet(args):
    """Run 2-3 VREs over one shared device pool under the FleetArbiter,
    with phase-shifted Poisson load (each VRE gets one hot phase); prints
    the fleet report JSON (and returns it). Needs at least ``--vres``
    devices in the pool — REPRO_TORCH_DEVICE_SHARES=N gives N shares of
    each device, so one card (or the host) can hold the fleet."""
    import numpy as np
    from repro_torch.device import device_pool
    from repro_torch.fleet.driver import DEFAULT_WORKDIR, run_fleet_scenario
    from repro_torch.launch.serve import validate_serving_args

    validate_serving_args(args, lambda msg: sys.exit(f"fleet: {msg}"),
                          zero_disables=True)
    if args.tick_interval is not None and args.tick_interval < 0:
        sys.exit(f"fleet: --tick-interval must be >= 0 (0 disables the "
                 f"background ticker), got {args.tick_interval}")
    # fleet knobs are enabled by default (None -> scenario defaults);
    # an explicit 0 disables — chunking off forces the cache off too,
    # since prefix entries live at chunk boundaries
    chunk_tokens = 16 if args.chunk_tokens is None else args.chunk_tokens
    prefix_cache_mb = 32.0 if args.prefix_cache_mb is None \
        else args.prefix_cache_mb
    if not chunk_tokens:
        prefix_cache_mb = 0.0
    pool = device_pool(args.provider, _shares("fleet"))
    if len(pool) < args.vres:
        sys.exit(f"fleet: {args.vres} VREs need >= {args.vres} devices, "
                 f"provider has {len(pool)}; set REPRO_TORCH_DEVICE_SHARES="
                 f"N for N shares of each device")
    tick_interval = 0.05 if args.tick_interval is None else args.tick_interval
    report = run_fleet_scenario(
        args.vres, devices=pool, arch=args.arch, provider=args.provider,
        workdir=args.workdir or DEFAULT_WORKDIR,
        requests_per_phase=args.requests, rate_rps=args.rate,
        max_new_tokens=args.max_new, chunk_tokens=chunk_tokens,
        prefix_cache_mb=prefix_cache_mb,
        shared_prefix_len=args.shared_prefix, static=args.static,
        tick_interval_s=tick_interval or None,
        speculate=args.speculate or 0,
        record_dir=args.record_dir,
        telemetry_port=args.telemetry_port,
        rng=np.random.default_rng(args.seed))
    print(json.dumps(report, indent=2))
    return report


def cmd_trace(args):
    """Query a flight-recorder record store: summary + per-request span
    trees. ``--records`` takes files or directories of ``*.jsonl``."""
    from repro_torch.observability import RecordStore, format_span_tree

    store = RecordStore.load(*args.records)
    if not len(store) and not store.controls:
        sys.exit(f"trace: no records found under {args.records}")
    matches = store.query(tenant=args.tenant, rid=args.rid,
                          since_s=args.since, until_s=args.until,
                          disrupted=True if args.disrupted else None)
    if args.rid is None and not args.disrupted and args.tenant is None:
        # no filter: default to the most disrupted / slowest requests
        matches = sorted(matches,
                         key=lambda r: (len(r.get("disruptions", ())),
                                        r.get("timings", {}).get("latency_s")
                                        or 0.0),
                         reverse=True)
    if args.json:
        # machine-readable mode: one JSON document — summary + the raw
        # matched records (span trees and all) — so dashboards and tests
        # consume structure instead of scraping the ASCII renderer
        print(json.dumps({"summary": store.summary(),
                          "matched": len(matches),
                          "records": matches[:args.limit]},
                         indent=2, default=str))
        return store
    print(json.dumps(store.summary(), indent=2))
    for rec in matches[:args.limit]:
        print()
        print(format_span_tree(rec))
    shown = min(len(matches), args.limit)
    if len(matches) > shown:
        print(f"\n({len(matches) - shown} more matching records; raise "
              f"--limit or filter with --tenant/--rid)")
    return store


def cmd_destroy(args):
    d = Path(args.dir)
    m = d / "manifest.json"
    if m.exists():
        m.unlink()
    print("VRE destroyed (manifest removed; caches kept for fast re-apply)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("init")
    p.add_argument("provider", choices=["cpu", "h100"])
    p.add_argument("directory")
    p.set_defaults(fn=cmd_init)
    p = sub.add_parser("apply")
    p.add_argument("--dir", required=True)
    p.set_defaults(fn=cmd_apply)
    p = sub.add_parser("install")
    p.add_argument("package")
    p.add_argument("--dir", required=True)
    p.set_defaults(fn=cmd_install)
    p = sub.add_parser("status")
    p.add_argument("--dir", required=True)
    p.set_defaults(fn=cmd_status)
    p = sub.add_parser("serve")
    p.add_argument("--dir", required=True)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--rate", type=float, default=4.0)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--waves", type=int, default=1,
                   help="load waves; >1 applies pending mesh resizes "
                        "between waves (elastic serving)")
    p.add_argument("--autoscale", action="store_true",
                   help="run the load-driven autoscaler (replica scaling + "
                        "mesh-resize requests at saturation)")
    p.add_argument("--force-resize", action="store_true",
                   help="request a mesh resize before the inter-wave safe "
                        "point even if the autoscaler didn't")
    p.add_argument("--chunk-tokens", type=int, default=None,
                   help="chunk-wise prefill in pieces of this many tokens "
                        "(admits long prompts without stalling decode; "
                        "omit to disable)")
    p.add_argument("--prefix-cache-mb", type=float, default=None,
                   help="cross-request prefix-cache LRU budget in MiB "
                        "(requires --chunk-tokens; omit to disable)")
    p.add_argument("--speculate", type=int, default=None,
                   help="speculative decoding: draft tokens verified per "
                        "decode step (omit to disable; MoE/SSM archs "
                        "fall back to plain decode)")
    p.add_argument("--draft", choices=("model", "ngram"), default=None,
                   help="draft engine for --speculate: 'ngram' prompt "
                        "lookup (default) or a small 'model' transformer "
                        "on each replica's device")
    p.add_argument("--record", default=None, metavar="PATH",
                   help="flight recorder: one JSONL record per request "
                        "(inspect with `python -m repro_torch.cli trace`)")
    p.add_argument("--telemetry-port", type=int, default=None, metavar="N",
                   help="serve live /metrics + /healthz + /vre/<name>/* on "
                        "127.0.0.1 at this port for the duration of the run "
                        "(0 picks an ephemeral port, printed to stderr)")
    p.set_defaults(fn=cmd_serve)
    p = sub.add_parser(
        "fleet",
        help="run several VREs over one shared device pool with "
             "phase-shifted Poisson load, arbitrated by the FleetArbiter")
    p.add_argument("--vres", type=int, default=2,
                   help="number of concurrently admitted VREs (each gets "
                        "one hot load phase)")
    p.add_argument("--arch", default="yi-9b")
    p.add_argument("--provider", choices=["h100", "cpu"], default="h100",
                   help="the card's full widths (default) or the reduced "
                        "model on the host")
    p.add_argument("--requests", type=int, default=24,
                   help="requests per phase for the hot VRE")
    p.add_argument("--rate", type=float, default=400.0,
                   help="hot-phase Poisson rate; the default saturates the "
                        "tenant's slot budget so capacity movement shows")
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-tokens", type=int, default=None,
                   help="chunk-wise prefill size per tenant (default 16; "
                        "0 disables)")
    p.add_argument("--prefix-cache-mb", type=float, default=None,
                   help="fleet-shared prefix-cache budget in MiB "
                        "(default 32; 0 disables)")
    p.add_argument("--shared-prefix", type=int, default=48,
                   help="tokens of shared prompt head across all tenants "
                        "(the fleet prefix cache's cross-VRE payoff)")
    p.add_argument("--static", action="store_true",
                   help="baseline: split the pool equally, disable "
                        "proposals/preemption and cross-VRE prefix sharing")
    p.add_argument("--tick-interval", type=float, default=None,
                   help="background arbiter control-loop interval in "
                        "seconds: tick + apply_pending run automatically so "
                        "deferred admissions/proposals land without manual "
                        "pumping (default 0.05; 0 disables — the driver "
                        "then pumps by hand)")
    p.add_argument("--speculate", type=int, default=None,
                   help="speculative decoding per tenant: draft tokens "
                        "verified per decode step (0 disables)")
    p.add_argument("--record-dir", default=None, metavar="DIR",
                   help="flight recorder: one JSONL record file per VRE "
                        "under DIR (inspect with `python -m repro_torch.cli "
                        "trace --records DIR`)")
    p.add_argument("--telemetry-port", type=int, default=None, metavar="N",
                   help="serve fleet-wide /metrics + /healthz + /vres on "
                        "127.0.0.1 at this port for the duration of the run "
                        "(0 picks an ephemeral port)")
    p.add_argument("--workdir", default=None,
                   help="VRE working directory (default: fleet/ under the "
                        "system temporary directory)")
    p.set_defaults(fn=cmd_fleet)
    p = sub.add_parser(
        "trace",
        help="query a flight-recorder store: percentile summary and "
             "per-request span trees")
    p.add_argument("--records", nargs="+", required=True, metavar="PATH",
                   help="record JSONL file(s) or directories of *.jsonl")
    p.add_argument("--tenant", default=None,
                   help="only this tenant/VRE's requests")
    p.add_argument("--rid", type=int, default=None,
                   help="one request id")
    p.add_argument("--since", type=float, default=None, metavar="S",
                   help="arrival window start (seconds from recorder epoch)")
    p.add_argument("--until", type=float, default=None, metavar="S",
                   help="arrival window end (seconds from recorder epoch)")
    p.add_argument("--disrupted", action="store_true",
                   help="only requests that rode through a control-plane "
                        "event (failover/preemption/resize)")
    p.add_argument("--limit", type=int, default=5,
                   help="span trees to print (default 5)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output: one JSON document with "
                        "the summary and the matched raw records instead "
                        "of ASCII span trees")
    p.set_defaults(fn=cmd_trace)
    p = sub.add_parser("destroy")
    p.add_argument("--dir", required=True)
    p.set_defaults(fn=cmd_destroy)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
