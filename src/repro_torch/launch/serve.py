"""Serving driver: open-loop Poisson load over the async serving plane,
ported from the JAX package's ``repro.launch.serve``.

Requests arrive on a Poisson process (exponential inter-arrival gaps) while
the replica decode loops run on background threads — the arrival rate does
not adapt to the system, so queueing and latency under load are measured.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 24 --rate 4.0            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu ...

Not ported yet: chunked prefill, the prefix cache, speculative decoding and
the flight recorder (their flags), and the elastic serve loop.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Union

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
    return {
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
        "decode_steps": counter("decode_steps"),
    }


def run_load(rs: ReplicaSet, prompts: List[np.ndarray], *, rate_rps: float,
             max_new_tokens: int, rng, timeout_s: float = 300.0) -> dict:
    """Drive a started ReplicaSet with Poisson arrivals and report. Every
    request's future is read, so a failed request raises here."""
    if prompts:
        # one throwaway request warms the device (library handles, caching
        # allocator) outside the measured window
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


def build_replicaset(arch: Union[str, ModelConfig], *, replicas: int,
                     slots: int, max_seq: int, monitor=None,
                     device=None) -> ReplicaSet:
    """A ReplicaSet serving ``arch``: an arch name serves its ``reduced()``
    config (the JAX package's default, so the two stay comparable); a
    ``ModelConfig`` is served as given (the full widths on the card). Params
    are drawn once from a ``torch.Generator`` seeded with 0. With
    ``device`` unset the replicas spread over every visible card; with no
    card it raises (pass ``device="cpu"``)."""
    from repro_torch.models.model import build_model

    cfg = reduced(get_config(arch)) if isinstance(arch, str) else arch
    home = resolve_device(device)
    if device is None:
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        pool = [home]
    model = build_model(cfg, device=home)
    params = model.init(torch.Generator(device=home).manual_seed(0))

    def factory(i: int, devices: tuple) -> ServingEngine:
        return ServingEngine(model, params, slots=slots, max_seq=max_seq,
                             name=f"replica{i}", monitor=monitor,
                             device=devices[0] if devices else home)

    return ReplicaSet(factory, replicas=replicas, monitor=monitor,
                      devices=pool)


def validate_serving_args(args, error) -> None:
    """Reject malformed serving knobs with a one-line error instead of a
    deep engine traceback."""
    for flag, value, least in (("--requests", args.requests, 1),
                               ("--replicas", args.replicas, 1),
                               ("--slots", args.slots, 1),
                               ("--max-new", args.max_new, 1),
                               ("--max-seq", args.max_seq, 2)):
        if value < least:
            error(f"{flag} must be >= {least}, got {value}")
    if args.rate < 0:
        error(f"--rate must be >= 0 (0 submits every request at once), "
              f"got {args.rate}")


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
    args = ap.parse_args(argv)
    validate_serving_args(args, ap.error)

    monitor = Monitor()
    rs = build_replicaset(args.arch, replicas=args.replicas,
                          slots=args.slots, max_seq=args.max_seq,
                          monitor=monitor, device=args.device)
    vocab = rs.engines[0].cfg.vocab_size      # the (reduced) serving config
    rs.start()
    rng = np.random.default_rng(0)
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
