"""Flight recorder: async per-request record persistence + queryable store.

``Recorder`` is the st4sd-datastore ``reporter`` analogue for this repo's
serving plane: engines hand it finished requests, a background writer thread
appends one JSON line per request to the record file, and nothing on the
decode path ever blocks on the filesystem — the handoff queue is bounded,
overflow is *counted and dropped* (observability must never backpressure
serving), and ``stop()`` flushes what is queued.

Record schema (one JSONL object per request; see benchmarks/README.md):

  kind              "request" (the default), "meta" (file header: tenant,
                    arch, serving knobs — written once per recorder start so
                    replay can rebuild the serving plane), or "control"
                    (plane-level events: preemptions, resizes)
  rid               process-unique request id
  tenant / replica / generation / devices
                    where the request ran (generation bumps on every VRE
                    re-instantiation, so a record names the placement epoch)
  arrival_s         submit time relative to the recorder epoch (monotonic)
  prompt_tokens / generated_tokens / prompt_len / new_tokens / max_new_tokens
  timings           ttft_s, latency_s, queue_wait_s, prefill_s, decode_s
  counters          prefill_chunks, prefix_hit_tokens, spec_steps,
                    spec_proposed, spec_accepted
  disruptions       control-plane events the request rode through
                    (failover, preemption, resize, detached, requeued, ...)
  retries           failover re-queue count
  trace             the full span tree (relative times)

``RecordStore`` loads one or more record files back and answers the queries
``serve_report``, ``cli trace``, and the replay/benchmark harness need:
filter by tenant / time window / disruption, percentile summaries.

A copy of the JAX package's ``repro.observability.recorder`` with the same
record schema, so a record file written by either package loads in the
other's ``RecordStore``. Torch values (tensors, devices, dtypes) are turned
into plain JSON values on the calling thread: nothing torch-typed reaches
the writer thread. A record's ``devices`` is ``[str(engine.device)]``
(e.g. ``"cuda:0"``); span times are host times (no device sync per span).
"""
from __future__ import annotations

import json
import queue
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

# trace span/event names that mark a request as disrupted by the control
# plane (everything a record's ``disruptions`` list is built from)
DISRUPTION_EVENTS = ("failover", "preemption", "resize", "detached",
                     "requeued", "adopted")


def _jsonable(v):
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return v.tolist()
    if isinstance(v, (torch.device, torch.dtype)):
        return str(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


class Recorder:
    """Bounded-queue async JSONL writer for request records.

    ``context`` fields are merged into every record (the builder sets e.g.
    the VRE generation there); ``meta`` is written once as the file-header
    line so a record file is self-describing (and replayable) without the
    VRE config that produced it."""

    def __init__(self, path, *, tenant: str = "", meta: Optional[dict] = None,
                 context: Optional[dict] = None, max_queue: int = 4096,
                 monitor=None, name: str = "recorder"):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.tenant = tenant
        self.context = dict(context or {})
        self.monitor = monitor
        self.name = name
        self.epoch = time.perf_counter()     # arrival_s reference
        self.drops = 0
        self.written = 0
        self._q: "queue.Queue[dict]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._closed = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._writer,
                                        name=f"{name}-writer", daemon=True)
        header = {"kind": "meta", "tenant": tenant, "t_unix": time.time(),
                  **{k: _jsonable(v) for k, v in (meta or {}).items()}}
        self._enqueue(header)
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def _enqueue(self, rec: dict) -> bool:
        if self._closed:
            self.drops += 1
            return False
        try:
            self._q.put_nowait(rec)
            return True
        except queue.Full:
            # never block the decode loop on the filesystem: count the loss
            self.drops += 1
            if self.monitor is not None:
                self.monitor.count(self.name, "record_dropped")
                # gauge too: the /metrics surface scrapes gauges, so silent
                # record loss shows up on dashboards, not only in the
                # end-of-run JSONL summary
                self.monitor.gauge(self.name, "dropped", float(self.drops))
            return False

    def record(self, req, engine=None) -> bool:
        """Persist one finished request. Builds the (host-only) record dict
        on the calling thread — it needs the live request/engine — and hands
        serialization + IO to the writer thread."""
        return self._enqueue(build_record(req, engine, self))

    def control(self, event: str, **fields) -> bool:
        """Plane-level event record (preemption applied, resize, ...)."""
        return self._enqueue({"kind": "control", "event": event,
                              "tenant": self.tenant,
                              "at_s": round(time.perf_counter() - self.epoch,
                                            6),
                              **{k: _jsonable(v) for k, v in fields.items()}})

    # -- writer thread -----------------------------------------------------
    def _writer(self):
        f = self.path.open("a")
        try:
            while True:
                try:
                    rec = self._q.get(timeout=0.05)
                except queue.Empty:
                    if self._stop.is_set():
                        break
                    continue
                try:
                    f.write(json.dumps(rec, default=str) + "\n")
                    f.flush()
                    self.written += 1
                except Exception:
                    self.drops += 1
                finally:
                    self._q.task_done()
        finally:
            f.close()

    # -- lifecycle ---------------------------------------------------------
    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every queued record is on disk (or timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._q.unfinished_tasks == 0:
                return True
            time.sleep(0.005)
        return False

    def stop(self, timeout: float = 10.0) -> bool:
        """Flush and stop the writer. Idempotent; late ``record`` calls
        after stop are drop-counted, never an error."""
        with self._lock:
            if self._closed:
                return True
            self._closed = True
        ok = self.flush(timeout)
        self._stop.set()
        t = self._thread
        if t.is_alive():
            t.join(timeout)
        return ok and not t.is_alive()

    def summary(self) -> dict:
        return {"path": str(self.path), "written": self.written,
                "dropped": self.drops}


# ---------------------------------------------------------------------------
# Record assembly
# ---------------------------------------------------------------------------

def _walk_spans(span: dict, out: List[dict]):
    out.append(span)
    for c in span.get("children", ()):
        _walk_spans(c, out)


def build_record(req, engine=None, recorder: Optional[Recorder] = None
                 ) -> dict:
    """Flatten a finished request (+ its trace) into the record schema.
    Works with tracing disabled too — the record then simply lacks the
    span-derived timing breakdown."""
    trace = req.trace.finish().to_dict() if req.trace.enabled else {}
    spans: List[dict] = []
    if trace:
        _walk_spans(trace, spans)

    def total(name):
        vals = [s.get("duration_s") for s in spans if s["name"] == name
                and s.get("duration_s") is not None]
        return round(sum(vals), 6) if vals else None

    counters = {"prefill_chunks": 0, "prefix_hit_tokens": 0,
                "spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0}
    disruptions = []
    for s in spans:
        if s["name"] == "prefill":
            counters["prefix_hit_tokens"] += int(
                (s.get("attrs") or {}).get("prefix_hit_tokens", 0))
        for ev in s.get("events", ()):
            nm, attrs = ev["name"], ev.get("attrs", {})
            if nm == "chunk":
                counters["prefill_chunks"] += 1
            elif nm == "verify":
                counters["spec_steps"] += 1
                counters["spec_proposed"] += int(attrs.get("proposed", 0))
                counters["spec_accepted"] += int(attrs.get("accepted", 0))
            elif nm in DISRUPTION_EVENTS:
                disruptions.append({"event": nm, "at_s": ev["at_s"],
                                    **({"attrs": attrs} if attrs else {})})
    rec = {
        "kind": "request",
        "rid": getattr(req, "rid", -1),
        "tenant": recorder.tenant if recorder else "",
        "replica": getattr(engine, "name", None),
        "devices": [] if getattr(engine, "device", None) is None
        else [str(engine.device)],
        "arrival_s": round(req.submit_t - recorder.epoch, 6)
        if recorder else None,
        "prompt_tokens": np.asarray(req.tokens).tolist(),
        "prompt_len": int(len(req.tokens)),
        "max_new_tokens": int(req.max_new_tokens),
        "eos_id": int(req.eos_id),
        "generated_tokens": [int(t) for t in req.generated],
        "new_tokens": len(req.generated),
        "retries": int(req.retries),
        "timings": {
            "ttft_s": req.ttft_s,
            "latency_s": req.latency_s,
            "queue_wait_s": total("queue_wait"),
            "prefill_s": total("prefill"),
            "decode_s": total("decode"),
        },
        "counters": counters,
        "disruptions": disruptions,
        "trace": trace,
    }
    if recorder:
        rec.update({k: _jsonable(v) for k, v in recorder.context.items()})
    return rec


# ---------------------------------------------------------------------------
# Queryable store
# ---------------------------------------------------------------------------

def _percentile(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def _get_path(rec: dict, dotted: str):
    node = rec
    for part in dotted.split("."):
        node = node.get(part) if isinstance(node, dict) else None
        if node is None:
            return None
    return node


class RecordStore:
    """In-memory query surface over one or more record files."""

    def __init__(self, records: Sequence[dict], *,
                 meta: Optional[dict] = None,
                 controls: Optional[Sequence[dict]] = None):
        self.records = [r for r in records if r.get("kind", "request")
                        == "request"]
        self.meta = meta or {}
        self.controls = list(controls or ())

    @classmethod
    def load(cls, *paths) -> "RecordStore":
        """Load record file(s); a directory loads every ``*.jsonl`` under
        it. Later ``meta`` headers win (append-mode files re-stamp on every
        recorder start; the newest describes the final serving config)."""
        files: List[Path] = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                files.extend(sorted(p.rglob("*.jsonl")))
            else:
                files.append(p)
        records, controls, meta = [], [], {}
        for path in files:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    kind = rec.get("kind", "request")
                    if kind == "meta":
                        meta = rec
                    elif kind == "control":
                        controls.append(rec)
                    else:
                        records.append(rec)
        return cls(records, meta=meta, controls=controls)

    def __len__(self) -> int:
        return len(self.records)

    def query(self, *, tenant: Optional[str] = None,
              since_s: Optional[float] = None,
              until_s: Optional[float] = None,
              disrupted: Optional[bool] = None,
              rid: Optional[int] = None) -> List[dict]:
        """Filter records: ``tenant`` exact-matches, ``since_s``/``until_s``
        bound ``arrival_s`` (the recorder-epoch-relative time window),
        ``disrupted`` selects requests that did (True) / did not (False)
        ride through a control-plane event."""
        out = self.records
        if tenant is not None:
            out = [r for r in out if r.get("tenant") == tenant]
        if rid is not None:
            out = [r for r in out if r.get("rid") == rid]
        if since_s is not None:
            out = [r for r in out if r.get("arrival_s") is not None
                   and r["arrival_s"] >= since_s]
        if until_s is not None:
            out = [r for r in out if r.get("arrival_s") is not None
                   and r["arrival_s"] <= until_s]
        if disrupted is not None:
            out = [r for r in out
                   if bool(r.get("disruptions")) == disrupted]
        return list(out)

    def percentiles(self, field: str = "timings.latency_s",
                    qs: Sequence[float] = (0.5, 0.95),
                    records: Optional[Sequence[dict]] = None) -> dict:
        recs = self.records if records is None else records
        vals = [v for v in (_get_path(r, field) for r in recs)
                if isinstance(v, (int, float))]
        out = {"n": len(vals)}
        for q in qs:
            out[f"p{int(q * 100)}"] = _percentile(vals, q)
        return out

    def tenants(self) -> List[str]:
        return sorted({r.get("tenant", "") for r in self.records})

    def summary(self) -> dict:
        recs = self.records
        return {
            "records": len(recs),
            "tenants": self.tenants(),
            "prompt_tokens": sum(r.get("prompt_len", 0) for r in recs),
            "generated_tokens": sum(r.get("new_tokens", 0) for r in recs),
            "disrupted": sum(1 for r in recs if r.get("disruptions")),
            "retries": sum(r.get("retries", 0) for r in recs),
            "controls": len(self.controls),
            "ttft": self.percentiles("timings.ttft_s"),
            "latency": self.percentiles("timings.latency_s"),
            "queue_wait": self.percentiles("timings.queue_wait_s"),
        }


# ---------------------------------------------------------------------------
# Human rendering (cli trace)
# ---------------------------------------------------------------------------

def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "?"
    return f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.2f}s"


def _fmt_attrs(attrs: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in attrs.items())


def format_span_tree(record: dict) -> str:
    """ASCII rendering of one record's span tree::

        request rid=17 tenant=vre1 replica=replica0 (412.3ms)
        |- queue_wait 13.1ms
        |- prefill 120.4ms mode=chunked prefix_hit_tokens=32
        |    * chunk start=32 end=48
        |- decode 278.8ms
        |    * verify proposed=4 accepted=3
        |- * preemption old_shape=[3, 1] new_shape=[1, 1]
    """
    lines = [f"request rid={record.get('rid')} "
             f"tenant={record.get('tenant') or '-'} "
             f"replica={record.get('replica') or '-'} "
             f"({_fmt_s(record.get('timings', {}).get('latency_s'))}, "
             f"{record.get('prompt_len')}+{record.get('new_tokens')} tok, "
             f"retries={record.get('retries', 0)})"]

    def walk(span: dict, indent: str):
        label = f"{indent}|- {span['name']} {_fmt_s(span.get('duration_s'))}"
        attrs = span.get("attrs")
        if attrs:
            label += " " + _fmt_attrs(attrs)
        lines.append(label)
        for ev in span.get("events", ()):
            evl = f"{indent}|    * {ev['name']}"
            if ev.get("attrs"):
                evl += " " + _fmt_attrs(ev["attrs"])
            lines.append(evl + f" @{_fmt_s(ev.get('at_s'))}")
        for c in span.get("children", ()):
            walk(c, indent + "|   ")

    trace = record.get("trace") or {}
    for c in trace.get("children", ()):
        walk(c, "")
    for ev in trace.get("events", ()):
        evl = f"|- * {ev['name']}"
        if ev.get("attrs"):
            evl += " " + _fmt_attrs(ev["attrs"])
        lines.append(evl + f" @{_fmt_s(ev.get('at_s'))}")
    if not trace:
        lines.append("|- (no trace recorded)")
    return "\n".join(lines)
