"""Serving driver: open-loop Poisson load over the async serving plane,
ported from the JAX package's ``repro.launch.serve``.

Requests arrive on a Poisson process (exponential inter-arrival gaps) while
the replica decode loops run on background threads — the arrival rate does
not adapt to the system, so queueing and latency under load are measured.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 24 --rate 4.0            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m         # MoE: grouped-matmul kernel
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mamba2-370m                  # SSM: SSD kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu ...
    PYTHONPATH=src python -m repro_torch.launch.serve --chunk-tokens 16 \
        --prefix-cache-mb 8 --speculate 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --shared-prefix 48 \
        --record $TMPDIR/rec.jsonl --device cpu

An arch name serves its reduced config; ``build_replicaset(get_config(...))``
serves the full widths. ``--chunk-tokens`` prefills long prompts chunk by
chunk, ``--prefix-cache-mb`` shares their chunk boundaries across requests,
and ``--speculate``/``--draft`` verify draft tokens in one batched step.
``--shared-prefix`` gives every prompt one shared head; ``--record`` writes
one flight-recorder record per request, whose ``meta`` header names the
served model and knobs, so ``replay_file`` re-serves the file.

Not ported yet: the elastic serve loop (ROADMAP A.6).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.core.monitoring import Monitor
from repro_torch.device import resolve_device
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.replica import ReplicaSet


def make_prompts(n: int, vocab_size: int, rng, lo: int = 4, hi: int = 17):
    return [rng.integers(1, vocab_size, size=int(rng.integers(lo, hi)))
            for _ in range(n)]


def make_shared_prefix_prompts(n: int, vocab_size: int, rng, *,
                               prefix_len: int = 48, lo: int = 4,
                               hi: int = 13) -> List[np.ndarray]:
    """The scientific-pipeline traffic shape: every request shares a long
    system/context head and differs only in a short payload."""
    head = rng.integers(1, vocab_size, size=prefix_len)
    return [np.concatenate([head, rng.integers(
        1, vocab_size, size=int(rng.integers(lo, hi)))]) for _ in range(n)]


def poisson_load(submit, prompts: List[np.ndarray], rate_rps: float, rng,
                 max_new_tokens: int = 12) -> List[Request]:
    """Open-loop generator: submit each prompt at its Poisson arrival time
    regardless of how the system is keeping up. Returns the Requests."""
    gaps = rng.exponential(1.0 / rate_rps, size=len(prompts)) \
        if rate_rps > 0 else np.zeros(len(prompts))
    t0 = time.perf_counter()
    arrivals = np.cumsum(gaps)
    out: List[Request] = []
    for prompt, at in zip(prompts, arrivals):
        delay = t0 + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        out.append(submit(prompt, max_new_tokens=max_new_tokens))
    return out


def merged_poisson_load(streams, rng, max_new_tokens: int = 12) -> dict:
    """Multi-tenant open-loop load: each stream is ``(name, submit, prompts,
    rate_rps)``; arrivals are sampled per stream and merged into one
    time-ordered schedule, so tenants' requests interleave the way
    concurrent communities' traffic actually would (a hot tenant does not
    get to finish before a cold one starts). Returns name -> [Request].

    Pacing is coarse-grained: gaps below ~20ms are submitted back-to-back
    instead of slept. With busy decode threads holding the GIL, every
    ``time.sleep`` overshoots by tens of milliseconds, and at saturating
    rates that per-submission tax (not the load) would dominate measured
    walls."""
    schedule = []
    for name, submit, prompts, rate in streams:
        gaps = rng.exponential(1.0 / rate, size=len(prompts)) \
            if rate > 0 else np.zeros(len(prompts))
        arrivals = np.cumsum(gaps)
        for p, at in zip(prompts, arrivals):
            schedule.append((float(at), name, submit, p))
    schedule.sort(key=lambda s: s[0])
    out = {name: [] for name, *_ in streams}
    t0 = time.perf_counter()
    for at, name, submit, p in schedule:
        delay = t0 + at - time.perf_counter()
        if delay > 0.02:
            time.sleep(delay)
        out[name].append(submit(p, max_new_tokens=max_new_tokens))
    return out


def _percentile(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def serve_report(reqs: List[Request], wall_s: float, rs: ReplicaSet,
                 baseline: Optional[dict] = None) -> dict:
    """The serving benchmark contract: tok/s, TTFT p50, latency p95.
    ``baseline`` is a totals snapshot taken before the measured window
    (warmup / earlier traffic), subtracted so the engine counters describe
    only this load wave."""
    done = [r for r in reqs if r.done_t is not None]
    toks = sum(len(r.generated) for r in done)
    ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
    lats = [r.latency_s for r in done if r.latency_s is not None]
    m = rs.metrics()
    base = baseline or {}

    def counter(k):
        return m["total"].get(k, 0) - base.get(k, 0)

    prompt_toks = sum(len(r.tokens) for r in done)
    out = {
        "requests": len(reqs),
        "completed": len(done),
        "tokens": toks,
        "prompt_tokens": prompt_toks,
        "wall_s": wall_s,
        "tok_per_s": toks / wall_s if wall_s > 0 else 0.0,
        "prefill_tok_per_s": prompt_toks / wall_s if wall_s > 0 else 0.0,
        "ttft_p50_s": _percentile(ttfts, 0.50),
        "ttft_p95_s": _percentile(ttfts, 0.95),
        "latency_p50_s": _percentile(lats, 0.50),
        "latency_p95_s": _percentile(lats, 0.95),
        "replicas": m["replicas"],
        "failovers": m["failovers"],
        "prefills": counter("prefills"),
        "prefill_requests": counter("prefill_requests"),
        "prefill_chunks": counter("prefill_chunks"),
        "prefill_chunk_batches": counter("prefill_chunk_batches"),
        "prefill_tokens": counter("prefill_tokens"),
        "prefix_hit_tokens": counter("prefix_hit_tokens"),
        "decode_steps": counter("decode_steps"),
    }
    spec_steps = counter("spec_steps")
    if spec_steps:
        proposed = counter("spec_proposed")
        out["spec_steps"] = spec_steps
        out["spec_accept_rate"] = (counter("spec_accepted") / proposed
                                   if proposed else 0.0)
        out["spec_tokens_per_step"] = counter("spec_emitted") / spec_steps
    if "prefix_cache" in m:
        out["prefix_cache"] = m["prefix_cache"]
    if rs.recorder is not None:
        # flush so the on-disk store already covers this wave, then fold a
        # record-store summary into the serving contract
        from repro_torch.observability import RecordStore
        rs.recorder.flush()
        out["records"] = {**rs.recorder.summary(),
                          **RecordStore.load(rs.recorder.path).summary()}
    return out


def run_load(rs: ReplicaSet, prompts: List[np.ndarray], *, rate_rps: float,
             max_new_tokens: int, rng, timeout_s: float = 300.0) -> dict:
    """Drive a started ReplicaSet with Poisson arrivals and report. Every
    request's future is read, so a failed request raises here."""
    if prompts:
        # one throwaway request warms the device (library handles, caching
        # allocator) outside the measured window
        w = rs.submit_request(prompts[0], max_new_tokens=2)
        w.future.result(timeout=timeout_s)
        if rs.prefix_cache is not None:
            # the first request seeded the prefix cache; a second identical
            # one exercises the hit/restore path
            w = rs.submit_request(prompts[0], max_new_tokens=2)
            w.future.result(timeout=timeout_s)
    baseline = dict(rs.metrics()["total"])   # exclude warmup/prior traffic
    t0 = time.perf_counter()
    reqs = poisson_load(rs.submit_request, prompts, rate_rps, rng,
                        max_new_tokens)
    for r in reqs:
        r.future.result(timeout=timeout_s)
    wall = time.perf_counter() - t0
    return serve_report(reqs, wall, rs, baseline)


def model_config(arch: str, provider: str = "h100",
                 overrides: Optional[dict] = None) -> ModelConfig:
    """The config a provider serves for ``arch``: the reduced widths on
    ``"cpu"``, the full widths on the card (``"h100"``), as a VRE's
    ``_model_cfg`` maps them; ``overrides`` (depth, dtype) replace fields."""
    cfg = get_config(arch)
    if provider == "cpu":
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, **(overrides or {}))


def record_meta(cfg: ModelConfig, serving: dict) -> dict:
    """A record file's ``meta`` header for a pool serving ``cfg``: the JAX
    driver's keys (``arch``, ``provider``: ``"cpu"`` for the reduced widths,
    ``"h100"`` for the full ones, ``serving``), and ``model``, the scalar
    fields where ``cfg`` departs from that provider's config (depth,
    dtype), where there are any, so a replay rebuilds the same model.
    Raises where a nested config (MoE, SSM) departs: a header cannot
    describe that."""
    arch = cfg.name.removesuffix("-reduced")
    provider = "cpu" if arch != cfg.name else "h100"
    base = model_config(arch, provider)
    overrides = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if v == getattr(base, f.name):
            continue
        if not isinstance(v, (bool, int, float, str, type(None))):
            raise ValueError(f"{cfg.name}: field {f.name!r} departs from "
                             f"{base.name}'s and cannot go in a record header")
        overrides[f.name] = v
    meta = {"arch": arch, "provider": provider, "serving": dict(serving)}
    if overrides:
        meta["model"] = overrides
    return meta


def replicaset_for(model, params, *, replicas: int, slots: int, max_seq: int,
                   devices: Sequence, monitor=None, chunk_tokens: int = 0,
                   prefix_cache_mb: float = 0.0, speculate: int = 0,
                   draft: str = "ngram", recorder=None,
                   slots_per_device: Optional[int] = None) -> ReplicaSet:
    """A ReplicaSet of ``model`` with ``params`` over the device pool
    ``devices``, one slice of it per replica. ``chunk_tokens``,
    ``prefix_cache_mb`` (one cache shared by every replica), ``speculate``,
    ``draft`` and ``recorder`` are the engine's knobs; a draft is built per
    replica only where the engine would speculate. With ``slots_per_device``
    a replica's decode slots scale with its slice, and it computes on the
    slice's first device."""
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.speculative import (build_draft,
                                                 supports_speculation)

    cfg = model.cfg
    prefix_cache = None
    if chunk_tokens and prefix_cache_mb > 0:
        prefix_cache = PrefixCache(chunk_tokens,
                                   budget_bytes=int(prefix_cache_mb * 2**20),
                                   monitor=monitor)
    # no draft where the engine would gate speculation off (SSM/MoE): it
    # would only allocate unused per-replica state; the engine still logs
    # the fallback
    spec_supported = bool(speculate) and supports_speculation(model, max_seq)

    def factory(i: int, devs: tuple) -> ServingEngine:
        eng_slots = slots
        if slots_per_device and devs:
            eng_slots = int(slots_per_device) * len(devs)
        dev = devs[0] if devs else devices[0]
        d = build_draft(draft, cfg, slots=eng_slots, max_seq=max_seq,
                        device=dev, name=f"replica{i}-draft") \
            if spec_supported else None
        return ServingEngine(model, params, slots=eng_slots, max_seq=max_seq,
                             name=f"replica{i}", monitor=monitor, device=dev,
                             chunk_tokens=chunk_tokens,
                             prefix_cache=prefix_cache, speculate=speculate,
                             draft=d, recorder=recorder)

    return ReplicaSet(factory, replicas=replicas, monitor=monitor,
                      devices=devices, prefix_cache=prefix_cache,
                      recorder=recorder)


def build_replicaset(arch: Union[str, ModelConfig], *, replicas: int,
                     slots: int, max_seq: int, monitor=None, device=None,
                     chunk_tokens: int = 0, prefix_cache_mb: float = 0.0,
                     speculate: int = 0, draft: str = "ngram",
                     params=None, record_path: Optional[str] = None
                     ) -> ReplicaSet:
    """A ReplicaSet serving ``arch``: an arch name serves its ``reduced()``
    config (the JAX package's default, so the two stay comparable); a
    ``ModelConfig`` is served as given (the full widths on the card). Params
    are drawn once from a ``torch.Generator`` seeded with 0, unless
    ``params`` (of ``arch``'s model) are given. With ``device`` unset the
    replicas spread over every visible card; with no card it raises (pass
    ``device="cpu"``). With ``record_path`` every request is traced and
    recorded there (see ``record_meta`` for the header). The other knobs
    are ``replicaset_for``'s."""
    from repro_torch.models.model import build_model
    from repro_torch.observability import Recorder

    cfg = reduced(get_config(arch)) if isinstance(arch, str) else arch
    home = resolve_device(device)
    if device is None:
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        pool = [home]
    model = build_model(cfg, device=home)
    if params is None:
        params = model.init(torch.Generator(device=home).manual_seed(0))
    recorder = None
    if record_path:
        meta = record_meta(cfg, {
            "replicas": replicas, "slots": slots, "max_seq": max_seq,
            "chunk_tokens": chunk_tokens, "prefix_cache_mb": prefix_cache_mb,
            "speculate": speculate, "draft": draft})
        recorder = Recorder(record_path, tenant=meta["arch"],
                            monitor=monitor, meta=meta)
    return replicaset_for(model, params, replicas=replicas, slots=slots,
                          max_seq=max_seq, devices=pool, monitor=monitor,
                          chunk_tokens=chunk_tokens,
                          prefix_cache_mb=prefix_cache_mb,
                          speculate=speculate, draft=draft,
                          recorder=recorder)


def replicaset_from_meta(meta: dict, **kw) -> ReplicaSet:
    """A pool serving what a record file's ``meta`` header names: the model
    (``arch``, ``provider``, ``model``) at its serving knobs. ``kw``
    (``device``, ``params``, ``monitor``, ``record_path``) go to
    ``build_replicaset``."""
    if not meta.get("arch"):
        raise ValueError("the record file has no meta header naming the "
                         "served model")
    cfg = model_config(meta["arch"], meta.get("provider", "h100"),
                       meta.get("model"))
    serving = meta["serving"]
    return build_replicaset(
        cfg, replicas=int(serving["replicas"]), slots=int(serving["slots"]),
        max_seq=int(serving["max_seq"]),
        chunk_tokens=int(serving["chunk_tokens"]),
        prefix_cache_mb=float(serving["prefix_cache_mb"]),
        speculate=int(serving["speculate"]), draft=str(serving["draft"]),
        **kw)


def replay_file(*paths, speed: float = 1.0, timeout_s: float = 300.0,
                **kw) -> dict:
    """Re-serve record file(s) on a fresh pool built from their ``meta``
    header and report the replay against the recording (``token_parity``,
    ``mismatches``, latencies). ``kw`` go to ``replicaset_from_meta``."""
    from repro_torch.observability import load_replay, replay_records

    meta, records = load_replay(*paths)
    rs = replicaset_from_meta(meta, **kw)
    rs.start()
    try:
        return replay_records(records, rs.submit_request, speed=speed,
                              timeout_s=timeout_s)
    finally:
        rs.stop()


def validate_serving_args(args, error) -> None:
    """Reject malformed serving knobs with a one-line error instead of a
    deep engine traceback. A knob a command does not offer (``cli serve``
    has no ``--slots``) is not checked."""
    for flag, least in (("--requests", 1), ("--replicas", 1), ("--slots", 1),
                        ("--max-new", 1), ("--max-seq", 2),
                        ("--shared-prefix", 0)):
        value = getattr(args, flag[2:].replace("-", "_"), None)
        if value is not None and value < least:
            error(f"{flag} must be >= {least}, got {value}")
    if args.rate < 0:
        error(f"--rate must be >= 0 (0 submits every request at once), "
              f"got {args.rate}")
    # the JAX driver's checks and messages: a zero or negative chunk size
    # would reach the engine as a truthy chunk config; a negative cache
    # budget would quietly evict everything
    off = "omit the flag"
    if args.chunk_tokens is not None and args.chunk_tokens <= 0:
        error(f"--chunk-tokens must be a positive integer, got "
              f"{args.chunk_tokens} ({off} to disable chunked prefill)")
    if args.prefix_cache_mb is not None and args.prefix_cache_mb <= 0:
        error(f"--prefix-cache-mb must be positive, got "
              f"{args.prefix_cache_mb} ({off} to disable the prefix cache)")
    if args.prefix_cache_mb and args.chunk_tokens is None:
        error("--prefix-cache-mb requires --chunk-tokens "
              "(prefix entries live at chunk boundaries)")
    if args.speculate is not None and args.speculate <= 0:
        error(f"--speculate must be a positive number of draft tokens, got "
              f"{args.speculate} ({off} to disable speculative decoding)")
    if args.draft is not None and not args.speculate:
        error("--draft requires --speculate "
              "(a draft only exists to propose speculative tokens)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="open-loop Poisson arrival rate (req/s)")
    ap.add_argument("--device", default=None,
                    help="torch device for every replica (default: spread "
                         "over the visible cards; 'cpu' to run on the CPU)")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunk-wise prefill in pieces of this many tokens "
                         "(omit to disable; required for prefix caching)")
    ap.add_argument("--prefix-cache-mb", type=float, default=None,
                    help="cross-request prefix-cache LRU budget in MiB "
                         "(omit to disable)")
    ap.add_argument("--speculate", type=int, default=None,
                    help="speculative decoding: draft tokens verified per "
                         "decode step (omit to disable)")
    ap.add_argument("--draft", choices=("model", "ngram"), default=None,
                    help="draft engine for --speculate: 'ngram' prompt "
                         "lookup (default) or a small 'model' transformer")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prompts share a prefix head of this many tokens "
                         "(0: independent prompts)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="flight recorder: write one JSONL record per "
                         "request (enables per-request tracing)")
    args = ap.parse_args(argv)
    validate_serving_args(args, ap.error)

    monitor = Monitor()
    rs = build_replicaset(args.arch, replicas=args.replicas,
                          slots=args.slots, max_seq=args.max_seq,
                          monitor=monitor, device=args.device,
                          chunk_tokens=args.chunk_tokens or 0,
                          prefix_cache_mb=args.prefix_cache_mb or 0.0,
                          speculate=args.speculate or 0,
                          draft=args.draft or "ngram",
                          record_path=args.record)
    vocab = rs.engines[0].cfg.vocab_size      # the (reduced) serving config
    rs.start()
    rng = np.random.default_rng(0)
    if args.shared_prefix:
        prompts = make_shared_prefix_prompts(args.requests, vocab, rng,
                                             prefix_len=args.shared_prefix)
    else:
        prompts = make_prompts(args.requests, vocab, rng)
    try:
        report = run_load(rs, prompts, rate_rps=args.rate,
                          max_new_tokens=args.max_new, rng=rng)
    finally:
        rs.stop()
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
