"""``kn``-style CLI (paper Fig. 4): init -> apply -> install -> destroy.

  python -m repro_torch.cli init <provider> <dir>   # directory + template
  python -m repro_torch.cli apply --dir <dir>       # instantiate the VRE
  python -m repro_torch.cli install <package> --dir <dir>  # add a package
  python -m repro_torch.cli status --dir <dir>
  python -m repro_torch.cli serve --dir <dir> [--record R.jsonl]
  python -m repro_torch.cli trace --records R.jsonl [--json]
  python -m repro_torch.cli destroy --dir <dir>

``apply`` performs the full deployment (device procurement + service
builds), persists the manifest, and leaves the image cache warm so the next
``apply`` is fast — the on-demand usage pattern from the paper. The
provider is ``h100`` (every visible card; the default) or ``cpu`` (the
reduced model on the host).

A port of the JAX package's ``repro.cli`` with its arguments, messages and
JSON output. Not ported yet (ROADMAP A.6): ``fleet``, and ``serve``'s
``--waves``, ``--autoscale``, ``--force-resize`` and ``--telemetry-port``.
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


def cmd_serve(args):
    """Instantiate the VRE's serving plane and drive it with an open-loop
    Poisson load; prints the serving-contract report JSON (and returns
    it)."""
    import numpy as np
    from repro_torch.launch.serve import (make_prompts, run_load,
                                          validate_serving_args)

    validate_serving_args(args, lambda msg: sys.exit(f"serve: {msg}"))
    args.chunk_tokens = args.chunk_tokens or 0
    args.prefix_cache_mb = args.prefix_cache_mb or 0.0
    args.speculate = args.speculate or 0
    d = Path(args.dir)
    vre, _ = _load_vre(d)
    if "lm-server" not in vre.config.services:
        vre.config.services.append("lm-server")
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
    try:
        rng = np.random.default_rng(args.seed)
        rs = vre.service("lm-server").replicaset
        prompts = make_prompts(args.requests, rs.engines[0].cfg.vocab_size,
                               rng)
        report = run_load(rs, prompts, rate_rps=args.rate,
                          max_new_tokens=args.max_new, rng=rng)
        print(json.dumps(report, indent=2))
    finally:
        vre.destroy()
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
    p.set_defaults(fn=cmd_serve)
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
