"""Trace replay: re-serve a recorded request trace as a benchmark workload.

A record file is self-contained for replay: the ``meta`` header names the
serving config that produced it, and every request record carries its prompt
tokens, decode budget, and recorder-epoch-relative arrival time. Replay
rebuilds an equivalent serving plane, re-submits the same prompts on the
same arrival schedule, and reports the delta vs the recorded run — greedy
decode is deterministic, so replayed outputs must be token-identical to the
recorded ones (``token_parity``); a mismatch means the serving plane, not
the workload, changed.

Arrival pacing is coarse-grained like ``merged_poisson_load``: gaps under
~20ms are submitted back-to-back because ``time.sleep`` overshoots by tens
of milliseconds under busy decode threads.

A copy of the JAX package's ``repro.observability.replay``: it replays a
record file written by either package.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.observability.recorder import RecordStore, _percentile


def load_replay(*paths) -> Tuple[dict, List[dict]]:
    """Load record file(s) and return ``(meta, records)`` with the request
    records in arrival order — the replayable workload."""
    store = RecordStore.load(*paths)
    records = [r for r in store.records if r.get("prompt_tokens")]
    records.sort(key=lambda r: r.get("arrival_s") or 0.0)
    return store.meta, records


def replay_records(records: List[dict], submit, *, speed: float = 1.0,
                   timeout_s: float = 300.0) -> dict:
    """Re-submit ``records`` through ``submit(tokens, max_new_tokens=...,
    eos_id=...)`` on the recorded arrival schedule (sped up by ``speed``),
    wait for completion, and report the replayed run against the recorded
    one. ``submit`` is any ``ReplicaSet.submit_request``-shaped callable."""
    if not records:
        return {"requests": 0, "completed": 0, "token_parity": 1.0,
                "mismatches": 0}
    base = records[0].get("arrival_s") or 0.0
    t0 = time.perf_counter()
    pairs = []
    for rec in records:
        at = ((rec.get("arrival_s") or 0.0) - base) / max(speed, 1e-9)
        delay = t0 + at - time.perf_counter()
        if delay > 0.02:
            time.sleep(delay)
        req = submit(np.asarray(rec["prompt_tokens"], np.int32),
                     max_new_tokens=int(rec["max_new_tokens"]),
                     eos_id=int(rec.get("eos_id", -1)))
        pairs.append((rec, req))
    for _rec, req in pairs:
        req.future.result(timeout=timeout_s)
    wall = time.perf_counter() - t0
    return replay_report(pairs, wall)


def replay_report(pairs: List[tuple], wall_s: float) -> dict:
    """Token parity + latency delta between a recorded run and its replay.
    ``pairs`` is ``[(record, replayed Request), ...]``."""
    matched = mismatches = 0
    toks = 0
    ttfts, lats = [], []
    rec_ttfts, rec_lats = [], []
    for rec, req in pairs:
        toks += len(req.generated)
        replayed = [int(t) for t in req.generated]
        if replayed == list(rec.get("generated_tokens", ())):
            matched += 1
        else:
            mismatches += 1
        if req.ttft_s is not None:
            ttfts.append(req.ttft_s)
        if req.latency_s is not None:
            lats.append(req.latency_s)
        t = rec.get("timings") or {}
        if t.get("ttft_s") is not None:
            rec_ttfts.append(t["ttft_s"])
        if t.get("latency_s") is not None:
            rec_lats.append(t["latency_s"])

    def p50(vals: List[float]) -> Optional[float]:
        return _percentile(vals, 0.50)

    out = {
        "requests": len(pairs),
        "completed": sum(1 for _r, q in pairs if q.done_t is not None),
        "tokens": toks,
        "wall_s": wall_s,
        "tok_per_s": toks / wall_s if wall_s > 0 else 0.0,
        "token_parity": matched / len(pairs) if pairs else 1.0,
        "mismatches": mismatches,
        "ttft_p50_s": p50(ttfts),
        "latency_p50_s": p50(lats),
        "recorded_ttft_p50_s": p50(rec_ttfts),
        "recorded_latency_p50_s": p50(rec_lats),
    }
    if out["latency_p50_s"] and out["recorded_latency_p50_s"]:
        out["latency_p50_ratio"] = (out["latency_p50_s"]
                                    / out["recorded_latency_p50_s"])
    return out
