"""``python -m repro_torch.cli`` on the CPU, held against the JAX package's
``repro.cli``: the lifecycle commands and their JSON, the malformed serving
knobs of ``tests/test_cli_validation.py``, ``serve --record`` with the JAX
CLI's tokens per prompt (both packages' served-model caches hold one float32
reduced model), ``trace --json``, the training service raising with its
ROADMAP item, the autoscaler's SLO config and ``rebalance``/``resize`` as
JAX's, and the driver's shared-prefix prompts and merged Poisson schedule
equal to JAX's."""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.core.services as jax_services  # noqa: E402
from repro import cli as jax_cli  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.core.vre import VREConfig as JVREConfig  # noqa: E402
from repro.core.vre import VirtualResearchEnvironment as JVRE  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
import repro_torch.core.services as services  # noqa: E402
from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params as bridge  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.observability import RecordStore  # noqa: E402

SERVE_EXTRA = {"replicas": 1, "slots": 2, "max_seq": 64}


def _json_prefix(text: str):
    return json.JSONDecoder().raw_decode(text)[0]


def _init(tmp_path, name="dep", provider="cpu", services_=None,
          extra=None, main=cli.main):
    d = tmp_path / name
    main(["init", provider, str(d)])
    raw = json.loads((d / "vre.json").read_text())
    if services_ is not None:
        raw["services"] = services_
    raw["extra"].update(extra or {})
    (d / "vre.json").write_text(json.dumps(raw))
    return d


def test_cli_init_apply_install_status_destroy(tmp_path, capsys):
    d = _init(tmp_path, services_=["volumes", "dashboard"])
    out = capsys.readouterr().out
    assert out.startswith(f"initialized deployment directory {d}")
    assert "python -m repro_torch.cli apply" in out
    cli.main(["apply", "--dir", str(d)])
    out = capsys.readouterr().out
    report = _json_prefix(out)
    assert report["mode"] == "decentralized" and report["nodes"] == 1
    assert "VRE 'my-vre' RUNNING (2 services" in out
    assert (d / "manifest.json").exists()
    cli.main(["install", "workflows", "--dir", str(d)])
    assert "installed package 'workflows'" in capsys.readouterr().out
    assert "workflows" in json.loads((d / "vre.json").read_text())["services"]
    cli.main(["status", "--dir", str(d)])
    status = json.loads(capsys.readouterr().out)["status"]
    assert set(status["services"]) == {"volumes", "dashboard"}
    assert all(s["healthy"] for s in status["services"].values())
    cli.main(["destroy", "--dir", str(d)])
    assert "VRE destroyed" in capsys.readouterr().out
    assert not (d / "manifest.json").exists()
    cli.main(["status", "--dir", str(d)])
    assert "never applied" in capsys.readouterr().out


def test_cli_outputs_have_the_jax_clis_keys(tmp_path, capsys):
    """apply's report and status's manifest carry the JAX CLI's keys."""
    docs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = _init(tmp_path, name=name, services_=["volumes", "data"],
                  main=main)
        capsys.readouterr()
        main(["apply", "--dir", str(d)])
        report = _json_prefix(capsys.readouterr().out)
        main(["status", "--dir", str(d)])
        manifest = json.loads(capsys.readouterr().out)
        docs[name] = (report, manifest)
    (jr, jm), (tr, tm) = docs["jax"], docs["port"]
    assert jr.keys() == tr.keys() and jm.keys() == tm.keys()
    assert jm["status"].keys() == tm["status"].keys()
    assert jm["status"]["services"].keys() == tm["status"]["services"].keys()


def test_a_vre_json_of_the_jax_cli_applies_unchanged(tmp_path, capsys):
    d = _init(tmp_path, services_=["volumes", "data", "dashboard",
                                   "workflows"], main=jax_cli.main)
    assert json.loads((d / "vre.json").read_text())["provider"] == "cpu"
    cli.main(["apply", "--dir", str(d)])
    assert "RUNNING (4 services" in capsys.readouterr().out


def test_init_h100_writes_the_card_and_raises_without_one(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    d = tmp_path / "dep"
    cli.main(["init", "h100", str(d)])
    assert json.loads((d / "vre.json").read_text())["provider"] == "h100"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["apply", "--dir", str(d)])
    # a vre.json without a provider means the card, too
    raw = json.loads((d / "vre.json").read_text())
    del raw["provider"]
    (d / "vre.json").write_text(json.dumps(raw))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["apply", "--dir", str(d)])


@pytest.mark.parametrize("flags", [
    ["--chunk-tokens", "0"],
    ["--chunk-tokens", "-4"],
    ["--prefix-cache-mb", "0"],
    ["--prefix-cache-mb", "-1.5"],
    ["--prefix-cache-mb", "8"],              # requires --chunk-tokens
    ["--speculate", "0"],
    ["--speculate", "-3"],
    ["--draft", "ngram"],                    # requires --speculate
    ["--requests", "0"],
    ["--rate", "-1"],
])
def test_cli_serve_rejects_malformed_serving_knobs(tmp_path, capsys, flags):
    d = tmp_path / "dep"
    d.mkdir()
    (d / "vre.json").write_text(json.dumps({
        "name": "t", "provider": "cpu", "mesh_shape": [1, 1],
        "mesh_axes": ["data", "model"], "arch": "yi-9b", "services": []}))
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--dir", str(d)] + flags)
    assert exc.value.code not in (0, None)
    msg = str(exc.value.code) + capsys.readouterr().err
    assert msg.startswith("serve: ") and flags[0] in msg


@pytest.fixture
def seeded_models(monkeypatch):
    """One float32 reduced yi-9b in both packages' served-model caches
    (params bridged from the JAX model)."""
    jcfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    jmodel = jax_build(jcfg)
    jp, _ = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(t_reduced(t_get_config("yi-9b")),
                               dtype="float32")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setitem(jax_services._SERVED_MODEL_CACHE, ("yi-9b", "cpu"),
                        (jcfg, jmodel, jp))
    monkeypatch.setitem(services._SERVED_MODEL_CACHE, ("yi-9b", "cpu"),
                        (tcfg, build_model(tcfg, device="cpu"), tp))


def test_cli_serve_record_gives_the_jax_clis_tokens(tmp_path, capsys,
                                                    seeded_models):
    stores, reports = {}, {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = _init(tmp_path, name=name, services_=[], extra=SERVE_EXTRA,
                  main=main)
        rec = tmp_path / f"{name}.jsonl"
        capsys.readouterr()
        main(["serve", "--dir", str(d), "--requests", "5", "--rate", "0",
              "--max-new", "5", "--seed", "3", "--record", str(rec)])
        reports[name] = json.loads(capsys.readouterr().out)
        stores[name] = RecordStore.load(rec)
    ours, theirs = reports["port"], reports["jax"]
    assert ours.keys() == theirs.keys()
    assert ours["records"].keys() == theirs["records"].keys()
    assert ours["completed"] == theirs["completed"] == 5
    assert ours["tokens"] == theirs["tokens"] == 25
    # one record per submitted request, the warmup's too; compared by prompt
    by_prompt = {name: {tuple(r["prompt_tokens"]): (r["max_new_tokens"],
                                                   r["generated_tokens"])
                        for r in s.records}
                 for name, s in stores.items()}
    assert len(stores["port"]) == 6
    assert by_prompt["port"] == by_prompt["jax"]
    meta = stores["port"].meta
    assert (meta["arch"], meta["provider"], meta["tenant"]) == \
        ("yi-9b", "cpu", "my-vre")
    assert meta["model"] == {"dtype": "float32"}
    assert meta.keys() - {"model"} == stores["jax"].meta.keys()
    assert meta["serving"] == stores["jax"].meta["serving"]


def test_cli_trace_json(tmp_path, capsys, seeded_models):
    d = _init(tmp_path, services_=[], extra=SERVE_EXTRA)
    rec = tmp_path / "r.jsonl"
    cli.main(["serve", "--dir", str(d), "--requests", "3", "--rate", "0",
              "--max-new", "3", "--record", str(rec)])
    capsys.readouterr()
    cli.main(["trace", "--records", str(rec), "--json", "--limit", "2"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["matched"] == doc["summary"]["records"] == 4
    assert len(doc["records"]) == 2
    jax_cli.main(["trace", "--records", str(rec), "--json", "--limit", "2"])
    assert json.loads(capsys.readouterr().out) == doc
    cli.main(["trace", "--records", str(rec), "--limit", "1"])
    text = capsys.readouterr().out
    assert "queue_wait" in text and "decode" in text
    assert "3 more matching records" in text
    (tmp_path / "empty.jsonl").write_text("")
    with pytest.raises(SystemExit, match="no records"):
        cli.main(["trace", "--records", str(tmp_path / "empty.jsonl")])


# -- what is not ported yet raises with its ROADMAP item; A.6 is ported ------

def test_lm_trainer_fails_apply_naming_a7(tmp_path):
    """The trainer is ported for every token-input family (A.7, A.7b); an
    embeddings-input arch's trainer fails at apply naming A.7c, what is
    left of A.7."""
    d = _init(tmp_path, services_=["volumes", "lm-trainer"])
    vre_json = d / "vre.json"
    conf = json.loads(vre_json.read_text())
    conf["arch"] = "musicgen-medium"
    vre_json.write_text(json.dumps(conf))
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.7c"):
        cli.main(["apply", "--dir", str(d)])


def test_autoscale_fails_naming_a6(tmp_path):
    """The autoscaler is ported (ROADMAP A.6 is done): an ``autoscale``
    VRE whose SLO config declares no target fails at build with the JAX
    service's message, and one with a target builds an autoscaler with the
    SLO engine on it."""
    errors = {}
    for name, config, vre_cls in (("jax", JVREConfig, JVRE),
                                  ("port", VREConfig,
                                   VirtualResearchEnvironment)):
        cfg = config(name="t", services=["lm-server"], provider="cpu",
                     arch="yi-9b", workdir=str(tmp_path / name),
                     extra={**SERVE_EXTRA, "autoscale": True,
                            "slo": {"window_s": 5.0}})
        with pytest.raises(ValueError) as exc:
            vre_cls(cfg).instantiate()
        errors[name] = str(exc.value)
    assert errors["port"] == errors["jax"]
    assert "declares no targets" in errors["port"]
    vre = VirtualResearchEnvironment(VREConfig(
        name="t", services=["lm-server"], provider="cpu", arch="yi-9b",
        workdir=str(tmp_path / "ok"),
        extra={**SERVE_EXTRA, "autoscale": True,
               "slo": {"ttft_p95_s": 0.5}}))
    vre.instantiate()
    try:
        scaler = vre.service("lm-server").autoscaler
        assert scaler.cfg.max_replicas == 4
        assert [t.name for t in scaler.slo.targets] == ["ttft_p95"]
        assert scaler.resize_mesh == vre.request_resize
    finally:
        vre.destroy()


def test_rebalance_and_resize_raise_naming_a6(tmp_path, seeded_models):
    """``rebalance`` re-places the pool and keeps serving; ``resize`` onto
    more devices than the pool holds raises the JAX VRE's message (the
    elastic path is ported: ROADMAP A.6 is done)."""
    cfg = VREConfig(name="t", services=["lm-server"], provider="cpu",
                    arch="yi-9b", workdir=str(tmp_path), extra=SERVE_EXTRA)
    vre = VirtualResearchEnvironment(cfg)
    vre.instantiate()
    server = vre.service("lm-server")
    assert server.health() and server.metrics()["replicas"] == 1
    stats = server.rebalance(vre.mesh)
    assert stats["replicas"] == 1 and stats["requeued"] == 0
    assert server.metrics()["rebalances"] == 1
    fut = server.router.submit(np.arange(1, 6), max_new_tokens=3)
    server.drain(60)
    assert len(fut.result(timeout=60)) == 3
    with pytest.raises(RuntimeError,
                       match="provider has 1 devices, VRE wants 2"):
        vre.resize((2, 1))
    assert vre.state == "DESTROYED"
    assert not server.health()


def test_slots_per_device_sets_the_replicas_slots_as_jax(tmp_path,
                                                        seeded_models):
    slots = {}
    for name, config, vre_cls in (("jax", JVREConfig, JVRE),
                                  ("port", VREConfig,
                                   VirtualResearchEnvironment)):
        cfg = config(name="t", services=["lm-server"], provider="cpu",
                     arch="yi-9b", workdir=str(tmp_path / name),
                     extra={**SERVE_EXTRA, "slots_per_device": 3})
        vre = vre_cls(cfg)
        vre.instantiate()
        try:
            server = vre.service("lm-server")
            slots[name] = [e.slots for e in server.replicaset.engines]
            if name == "port":
                fut = server.router.submit(np.arange(1, 6), max_new_tokens=3)
                server.drain(60)
                assert len(fut.result(timeout=60)) == 3
        finally:
            vre.destroy()
    # one CPU device in the replica's slice: 3 slots a device
    assert slots["port"] == slots["jax"] == [3]


# -- the driver's traffic shapes ---------------------------------------------

@pytest.mark.parametrize("seed,prefix_len", [(0, 48), (5, 7)])
def test_shared_prefix_prompts_equal_jaxs(seed, prefix_len):
    ours = serve.make_shared_prefix_prompts(
        6, 503, np.random.default_rng(seed), prefix_len=prefix_len)
    theirs = jax_serve.make_shared_prefix_prompts(
        6, 503, np.random.default_rng(seed), prefix_len=prefix_len)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert all((p[:prefix_len] == ours[0][:prefix_len]).all() for p in ours)


def test_merged_poisson_load_schedule_equals_jaxs():
    """Two tenants' streams merge into the same submission order, with the
    same prompts, as JAX's for one seed (rates high enough that nothing
    sleeps long)."""
    def run(mod):
        rng = np.random.default_rng(4)
        order = []

        def submitter(name):
            def submit(p, max_new_tokens):
                order.append((name, tuple(int(t) for t in p),
                              max_new_tokens))
                return len(order)
            return submit
        streams = [(n, submitter(n),
                    mod.make_prompts(5, 503, rng), rate)
                   for n, rate in (("hot", 2000.0), ("cold", 500.0))]
        out = mod.merged_poisson_load(streams, rng, max_new_tokens=7)
        return order, {k: len(v) for k, v in out.items()}
    assert run(serve) == run(jax_serve)
    order, counts = run(serve)
    assert counts == {"hot": 5, "cold": 5}
    assert {name for name, *_ in order[:3]} != {"cold"}


def test_driver_shared_prefix_and_record_on_cpu(tmp_path, capsys):
    rec = tmp_path / "r.jsonl"
    report = serve.main(["--requests", "3", "--replicas", "1", "--slots",
                         "2", "--max-new", "3", "--max-seq", "96",
                         "--rate", "0", "--shared-prefix", "20",
                         "--record", str(rec), "--device", "cpu"])
    assert report["completed"] == 3 and report["records"]["records"] == 4
    recs = RecordStore.load(rec).records
    heads = {tuple(r["prompt_tokens"][:20]) for r in recs}
    assert len(heads) == 1
    with pytest.raises(SystemExit):
        serve.main(["--shared-prefix", "-1", "--device", "cpu"])


# -- elastic serving, the fleet and telemetry (ROADMAP A.6) ------------------

FLEET_KEYS = {"phases", "admissions", "per_vre", "arbiter", "carried",
              "requests", "completed", "completion_rate", "tokens", "wall_s",
              "tok_per_s", "mode", "pool_devices"}


def _exit_message(main, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code not in (0, None)
    return str(exc.value.code) + capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--chunk-tokens", "-1"],
    ["--prefix-cache-mb", "-1"],
    ["--prefix-cache-mb", "8", "--chunk-tokens", "0"],
    ["--speculate", "-2"],
    ["--tick-interval", "-0.5"],
    ["--vres", "3"],                  # more tenants than the pool's devices
])
def test_cli_fleet_rejects_bad_values_with_jaxs_messages(flags, capsys):
    theirs = _exit_message(jax_cli.main, ["fleet"] + flags, capsys)
    ours = _exit_message(cli.main, ["fleet", "--provider", "cpu"] + flags,
                         capsys)
    assert theirs.startswith("fleet: ") and ours.startswith("fleet: ")
    assert ours == theirs.replace(
        "XLA_FLAGS=--xla_force_host_platform_device_count=N for a dry-run",
        "REPRO_TORCH_DEVICE_SHARES=N for N shares of each device")


def test_cli_rejects_a_malformed_share_count(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_DEVICE_SHARES", "two")
    msg = _exit_message(cli.main, ["fleet", "--provider", "cpu"], capsys)
    assert msg.startswith("fleet: REPRO_TORCH_DEVICE_SHARES must be a "
                          "positive integer, got 'two'")
    d = _init(tmp_path, services_=[], extra=SERVE_EXTRA)
    msg = _exit_message(cli.main, ["serve", "--dir", str(d)], capsys)
    assert msg.startswith("serve: REPRO_TORCH_DEVICE_SHARES")


def test_cli_serve_waves_reports_jaxs_keys(tmp_path, capsys, monkeypatch,
                                           seeded_models):
    """``serve --waves 2 --autoscale --force-resize --telemetry-port 0``:
    the JAX CLI on its one host device clears the infeasible resize; the
    port, given two shares of the host, resizes to (2, 1). Both reports
    carry the same keys, every wave's too."""
    reports = {}
    argv = ["--requests", "4", "--rate", "0", "--max-new", "3", "--waves",
            "2", "--autoscale", "--force-resize", "--telemetry-port", "0"]
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = _init(tmp_path, name=name, services_=[],
                  extra={**SERVE_EXTRA, "replicas": "auto"}, main=main)
        if name == "port":
            monkeypatch.setenv("REPRO_TORCH_DEVICE_SHARES", "2")
        capsys.readouterr()
        main(["serve", "--dir", str(d)] + argv)
        captured = capsys.readouterr()
        reports[name] = json.loads(captured.out)
        assert "telemetry: http://127.0.0.1:" in captured.err
    ours, theirs = reports["port"], reports["jax"]
    assert ours.keys() == theirs.keys()
    assert [w.keys() for w in ours["waves"]] == \
        [w.keys() for w in theirs["waves"]]
    assert theirs["resizes"] == [] and theirs["final_mesh"] == [1, 1]
    assert ours["completion_rate"] == theirs["completion_rate"] == 1.0
    assert ours["final_mesh"] == [2, 1]
    (resize,) = ours["resizes"]
    assert set(resize) == {"after_wave", "old_shape", "new_shape",
                           "downtime_s", "reinstantiate_s",
                           "carried_requests", "tok_per_s_before",
                           "tok_per_s_after"}
    assert ours["telemetry"]["url"].startswith("http://127.0.0.1:")
    # the autoscaler may add or drop replicas; they sit on the mesh's shares
    shares = [{d for devs in w["placements"].values() for d in devs}
              for w in ours["waves"]]
    assert shares[0] == {"cpu#0"} and shares[1] <= {"cpu#0", "cpu#1"}


def test_cli_fleet_on_shares_of_the_host(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_DEVICE_SHARES", "4")
    report = cli.main(["fleet", "--provider", "cpu", "--requests", "4",
                       "--max-new", "3", "--shared-prefix", "32",
                       "--chunk-tokens", "16", "--workdir",
                       str(tmp_path / "fleet"), "--telemetry-port", "0"])
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(report))
    # the port adds the cards behind the pool's shares
    assert set(report) == FLEET_KEYS | {"telemetry", "pool_cards"}
    assert report["mode"] == "arbitrated" and report["pool_devices"] == 4
    assert report["pool_cards"] == ["cpu"]
    assert report["completion_rate"] == 1.0
    assert report["arbiter"]["admissions"] == 2
