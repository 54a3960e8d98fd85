"""The port's flight recorder and replay on the CPU, held against the JAX
package's: the cases of JAX's ``TestRecorder`` run against the port; record
files written by either package read identically by both ``RecordStore``s;
engine records (float32, params bridged from the JAX model) with the JAX
engine's span trees and tokens; a JAX-recorded file replayed through the
port's engine at token parity 1.0; the port driver's record header and its
replay."""
import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.observability import Recorder as JaxRecorder  # noqa: E402
from repro.observability import RecordStore as JaxStore  # noqa: E402
from repro.observability import TraceContext as JaxTrace  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.observability import (NULL_TRACE, Recorder, RecordStore,  # noqa: E402
                                       TraceContext, format_span_tree,
                                       load_replay, replay_records)
from repro_torch.observability.recorder import build_record  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

MAX_SEQ = 64


class _FakeEngine:
    name = "replica0"
    device = torch.device("cpu")


def _fake_request(rid=1, tokens=(5, 6, 7), generated=(8, 9),
                  trace_cls=TraceContext):
    """JAX's test request, traced with ``trace_cls`` (either package's)."""
    r = SimpleNamespace(rid=rid, tokens=np.asarray(tokens, np.int32),
                        prompt_len=len(tokens), generated=list(generated),
                        max_new_tokens=8, eos_id=-1, retries=0,
                        submit_t=time.perf_counter(), ttft_s=0.01,
                        latency_s=0.02)
    r.trace = trace_cls("request", rid=rid, prompt_len=len(tokens),
                        max_new_tokens=8)
    r.trace.open("queue_wait")
    r.trace.close("queue_wait", slot=0)
    span = r.trace.open("prefill", mode="chunked")
    span.annotate(prefix_hit_tokens=2)
    r.trace.event("prefix_cache_hit", tokens=2)
    r.trace.event("chunk", start=2, end=len(tokens))
    r.trace.close("prefill", tokens=len(tokens))
    r.trace.open("decode")
    r.trace.event("verify", proposed=3, accepted=2)
    r.trace.event("preemption", old_shape=[4, 1], new_shape=[2, 1])
    r.trace.close("decode", tokens=len(generated))
    return r


# -- JAX's TestRecorder cases, against the port ------------------------------

def test_roundtrip_and_store(tmp_path):
    path = tmp_path / "rec.jsonl"
    rec = Recorder(str(path), tenant="t0", meta={"arch": "toy"})
    rec.record(_fake_request(rid=1), _FakeEngine())
    rec.record(_fake_request(rid=2), _FakeEngine())
    rec.control("resize", old_shape=[4, 1], new_shape=[2, 1])
    rec.stop()
    # meta header + 2 requests + 1 control
    assert rec.summary()["written"] == 4 and rec.summary()["dropped"] == 0
    store = RecordStore.load(str(path))
    assert store.meta["arch"] == "toy"
    assert len(store.records) == 2 and len(store.controls) == 1
    r = store.query(rid=1)[0]
    assert r["tenant"] == "t0" and r["devices"] == ["cpu"]
    assert r["counters"]["prefix_hit_tokens"] == 2
    assert r["counters"]["spec_accepted"] == 2
    assert r["counters"]["prefill_chunks"] == 1
    assert r["disruptions"][0]["event"] == "preemption"
    assert r["disruptions"][0]["attrs"]["new_shape"] == [2, 1]
    assert store.query(disrupted=True) == store.records


def test_timings_from_spans(tmp_path):
    rec = Recorder(str(tmp_path / "rec.jsonl"), meta={})
    record = build_record(_fake_request(), _FakeEngine(), rec)
    rec.stop()
    t = record["timings"]
    assert t["queue_wait_s"] >= 0
    assert t["prefill_s"] >= 0 and t["decode_s"] >= 0
    assert record["prompt_tokens"] == [5, 6, 7]
    assert record["generated_tokens"] == [8, 9]


def test_drop_counting_after_stop(tmp_path):
    rec = Recorder(str(tmp_path / "rec.jsonl"), meta={})
    rec.stop()
    rec.record(_fake_request(), _FakeEngine())
    assert rec.summary()["dropped"] == 1


def test_stop_idempotent(tmp_path):
    rec = Recorder(str(tmp_path / "rec.jsonl"), meta={})
    assert rec.stop() and rec.stop()


def test_append_mode_remeta(tmp_path):
    path = str(tmp_path / "rec.jsonl")
    rec1 = Recorder(path, meta={"generation": 1})
    rec1.record(_fake_request(rid=1), _FakeEngine())
    rec1.stop()
    rec2 = Recorder(path, meta={"generation": 2})
    rec2.record(_fake_request(rid=2), _FakeEngine())
    rec2.stop()
    store = RecordStore.load(path)
    assert store.meta["generation"] == 2
    assert [r["rid"] for r in store.records] == [1, 2]


def test_store_load_directory_and_filters(tmp_path):
    for i, tenant in enumerate(("a", "b")):
        rec = Recorder(str(tmp_path / f"vre{i}.jsonl"), tenant=tenant,
                       meta={})
        rec.record(_fake_request(rid=i), _FakeEngine())
        rec.stop()
    store = RecordStore.load(str(tmp_path))
    assert store.tenants() == ["a", "b"]
    assert [r["rid"] for r in store.query(tenant="b")] == [1]
    s = store.summary()
    assert s["records"] == 2 and s["disrupted"] == 2


def test_percentiles(tmp_path):
    rec = Recorder(str(tmp_path / "r.jsonl"), meta={})
    for i in range(4):
        rec.record(_fake_request(rid=i), _FakeEngine())
    rec.stop()
    p = RecordStore.load(str(rec.path)).percentiles("timings.latency_s")
    assert p["n"] == 4 and p["p50"] > 0


def test_format_span_tree(tmp_path):
    rec = Recorder(str(tmp_path / "r.jsonl"), tenant="t", meta={})
    rec.record(_fake_request(rid=9), _FakeEngine())
    rec.stop()
    text = format_span_tree(RecordStore.load(str(rec.path)).records[0])
    assert "rid=9" in text
    assert "queue_wait" in text and "prefill" in text
    assert "prefix_cache_hit" in text and "verify" in text


def test_torch_values_reach_the_file_as_plain_json(tmp_path):
    """Tensors, devices and dtypes in the context, the meta header and a
    control event are written as plain JSON values."""
    path = tmp_path / "r.jsonl"
    rec = Recorder(str(path), meta={"arch": "toy",
                                    "slots": torch.tensor(4)},
                   context={"device": torch.device("cpu"),
                            "count": torch.tensor(3),
                            "dtype": torch.bfloat16})
    rec.record(_fake_request(rid=4), _FakeEngine())
    rec.control("resize", shape=torch.tensor([2, 1]))
    rec.stop()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["slots"] == 4
    req = next(x for x in lines if x["kind"] == "request")
    assert (req["device"], req["count"], req["dtype"]) == \
        ("cpu", 3, "torch.bfloat16")
    assert next(x for x in lines if x["kind"] == "control")["shape"] == [2, 1]


# -- either package's file in both stores ------------------------------------

class _JaxFakeEngine:
    name = "replica0"
    devices = ()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_record_files_load_identically_in_both_stores(tmp_path, writer):
    path = str(tmp_path / "rec.jsonl")
    if writer == "jax":
        rec = JaxRecorder(path, tenant="t0", meta={"arch": "toy"})
        for rid in (1, 2):
            rec.record(_fake_request(rid=rid, trace_cls=JaxTrace),
                       _JaxFakeEngine())
    else:
        rec = Recorder(path, tenant="t0", meta={"arch": "toy"})
        for rid in (1, 2):
            rec.record(_fake_request(rid=rid), _FakeEngine())
    rec.control("resize", old_shape=[4, 1], new_shape=[2, 1])
    rec.stop()
    ours, theirs = RecordStore.load(path), JaxStore.load(path)
    assert ours.summary() == theirs.summary()
    assert ours.records == theirs.records and ours.meta == theirs.meta
    assert ours.controls == theirs.controls
    assert ours.query(disrupted=True, tenant="t0") == \
        theirs.query(disrupted=True, tenant="t0")
    assert ours.summary()["records"] == 2


# -- the engine's records against the JAX engine's ---------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    jmodel = jax_build(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(t_reduced(t_get_config("yi-9b")),
                               dtype="float32")
    tm = build_model(tcfg, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jmodel, jp, tm, tp


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 503, size=n).astype(np.int32)
            for n in (6, 9, 12, 5)]


def _shape(record):
    """A record without its times: what both packages must agree on."""
    def spans(s):
        return [(c["name"], {k: v for k, v in c.get("attrs", {}).items()
                             if k != "replica"},
                 [e["name"] for e in c.get("events", ())], spans(c))
                for c in s.get("children", ())]
    keep = ("prompt_tokens", "prompt_len", "max_new_tokens", "eos_id",
            "generated_tokens", "new_tokens", "retries", "counters",
            "disruptions", "tenant", "replica")
    return {**{k: record[k] for k in keep}, "spans": spans(record["trace"]),
            "timings": sorted(record["timings"])}


def test_engine_records_match_the_jax_engines(tmp_path, models):
    jmodel, jp, tm, tp = models
    out = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.jsonl")
        if pkg == "jax":
            rec = JaxRecorder(path, tenant="unit", meta={"arch": "yi-9b"})
            eng = JaxEngine(jmodel, jp, slots=2, max_seq=MAX_SEQ,
                            name="unit", recorder=rec)
        else:
            rec = Recorder(path, tenant="unit", meta={"arch": "yi-9b"})
            eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ,
                                name="unit", device="cpu", recorder=rec)
        futs = [eng.submit(p, max_new_tokens=4) for p in _prompts()]
        eng.run_until_idle()
        for f in futs:
            f.result(timeout=60)
        rec.stop()
        out[pkg] = RecordStore.load(path).records
    assert len(out["port"]) == len(_prompts())
    for r in out["port"]:
        names = [c["name"] for c in r["trace"]["children"]]
        assert names[:3] == ["queue_wait", "prefill", "decode"]
        assert r["timings"]["latency_s"] > 0 and r["devices"] == ["cpu"]
        assert len(r["generated_tokens"]) == 4
    key = lambda r: tuple(r["prompt_tokens"])  # noqa: E731
    assert sorted(map(_shape, out["port"]), key=key) == \
        sorted(map(_shape, out["jax"]), key=key)


def test_disabled_engine_has_null_trace(models):
    _, _, tm, tp = models
    assert Request(np.asarray([1, 2], np.int32), 4, -1).trace is NULL_TRACE
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    assert eng.submit_request(np.asarray([1, 2, 3])).trace is NULL_TRACE


def _pumped(eng):
    """Run ``eng.step`` on a thread until the returned event is set."""
    stop = threading.Event()

    def drive():
        while not stop.is_set():
            eng.step()
            time.sleep(0.001)
    t = threading.Thread(target=drive, daemon=True)
    t.start()
    return stop, t


def test_jax_recorded_file_replays_through_the_port_engine(tmp_path, models):
    jmodel, jp, tm, tp = models
    path = str(tmp_path / "jax.jsonl")
    rec = JaxRecorder(path, tenant="unit", meta={"arch": "yi-9b"})
    jeng = JaxEngine(jmodel, jp, slots=2, max_seq=MAX_SEQ, recorder=rec)
    futs = [jeng.submit(p, max_new_tokens=5) for p in _prompts()]
    jeng.run_until_idle()
    for f in futs:
        f.result(timeout=60)
    rec.stop()
    meta, records = load_replay(path)
    assert meta["arch"] == "yi-9b" and len(records) == len(_prompts())
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, device="cpu")
    stop, pump = _pumped(eng)
    try:
        rep = replay_records(records, eng.submit_request, speed=100.0)
    finally:
        stop.set()
        pump.join(timeout=10)
    assert not pump.is_alive()
    assert rep["token_parity"] == 1.0 and rep["mismatches"] == 0
    assert rep["requests"] == rep["completed"] == len(records)


# -- the driver's record header and replay -----------------------------------

def test_record_meta_names_the_provider_and_the_departures():
    yi = t_get_config("yi-9b")
    knobs = {"replicas": 1, "slots": 4}
    assert serve.record_meta(yi, knobs) == {
        "arch": "yi-9b", "provider": "h100", "serving": knobs}
    cut = dataclasses.replace(yi, num_layers=2, dtype="float32")
    assert serve.record_meta(cut, knobs)["model"] == {
        "num_layers": 2, "dtype": "float32"}
    small = dataclasses.replace(t_reduced(yi), dtype="float32")
    meta = serve.record_meta(small, knobs)
    assert (meta["provider"], meta["model"]) == ("cpu", {"dtype": "float32"})
    for m in (serve.record_meta(yi, knobs), serve.record_meta(cut, knobs),
              meta):
        assert serve.model_config(m["arch"], m["provider"],
                                  m.get("model")) in (yi, cut, small)
    moe = t_get_config("granite-moe-1b-a400m")
    odd = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe, top_k=1))
    with pytest.raises(ValueError, match="record header"):
        serve.record_meta(odd, knobs)


def test_build_replicaset_records_and_replays_from_the_header(tmp_path):
    """The driver's pool with ``record_path``: one record per request (the
    warmup too), a header naming the reduced model and the knobs, and a
    replay through a pool built from the header alone at parity 1.0."""
    path = str(tmp_path / "rec.jsonl")
    rs = serve.build_replicaset("yi-9b", replicas=1, slots=2,
                                max_seq=MAX_SEQ, device="cpu",
                                record_path=path)
    rs.start()
    try:
        prompts = serve.make_prompts(3, 503, np.random.default_rng(0))
        report = serve.run_load(rs, prompts, rate_rps=0, max_new_tokens=4,
                                rng=np.random.default_rng(0))
    finally:
        rs.stop()
    assert report["records"]["records"] == 4
    assert report["records"]["dropped"] == 0
    meta, records = load_replay(path)
    assert meta["arch"] == "yi-9b" and meta["provider"] == "cpu"
    assert meta["serving"]["slots"] == 2 and "model" not in meta
    assert {r["devices"][0] for r in records} == {"cpu"}
    rep = serve.replay_file(path, device="cpu", speed=100.0)
    assert rep["token_parity"] == 1.0 and rep["requests"] == 4


def test_edge_router_over_an_engine_list(models):
    """Least-loaded dispatch over plain engines, drained synchronously
    (engines not started run to idle), with per-engine metrics."""
    from repro_torch.serving.engine import EdgeRouter
    _, _, tm, tp = models
    engines = [ServingEngine(tm, tp, slots=1, max_seq=MAX_SEQ, name=f"e{i}",
                             device="cpu") for i in range(2)]
    router = EdgeRouter(engines)
    futs = [router.submit(p, max_new_tokens=3) for p in _prompts()]
    assert [e.load for e in engines] == [2, 2]
    router.drain(60)
    assert all(len(f.result(timeout=1)) == 3 for f in futs)
    assert {n: m["completed"] for n, m in router.metrics().items()} == \
        {"e0": 2, "e1": 2}
    engines[0].kill()
    engines[1].kill()
    with pytest.raises(RuntimeError, match="no healthy"):
        router.submit(_prompts()[0])
    with pytest.raises(ValueError):
        EdgeRouter([])
