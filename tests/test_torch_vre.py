"""The port's VRE layers on the CPU, held against the JAX package's: the
cases of ``tests/test_deployment_vre.py``, ``tests/test_workflow_scheduler.py``
and ``tests/test_checkpoint_data.py`` run against the port; checkpoints
crossing between the packages bit for bit (bfloat16 included); data batches
equal to the JAX pipeline's; the device mesh the VRE procures."""
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JaxStore  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JaxData  # noqa: E402
import repro_torch.core.services  # noqa: E402,F401  (registers the packages)
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.core.deployment import (CentralizedDeployer,  # noqa: E402
                                         DecentralizedDeployer, ImageCache,
                                         node_roles)
from repro_torch.core.monitoring import Monitor  # noqa: E402
from repro_torch.core.registry import (EndpointDirectory,  # noqa: E402
                                       StaleEndpoint)
from repro_torch.core.scheduler import ClusterScheduler  # noqa: E402
from repro_torch.core.vre import (DeviceMesh, VREConfig,  # noqa: E402
                                  VirtualResearchEnvironment)
from repro_torch.core.workflow import Workflow  # noqa: E402
from repro_torch.device import DeviceShare, resolve_device  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, Prefetcher,  # noqa: E402
                                       SyntheticLMData, device_batch,
                                       split_partitions)


# -- tests/test_deployment_vre.py --------------------------------------------

def test_node_roles_ratio():
    roles = node_roles(9)
    assert roles[0] == "master+edge"
    assert roles[1:6] == ["service"] * 5
    assert roles[6:9] == ["storage"] * 3


def test_image_cache_hit_miss(tmp_path):
    cache = ImageCache(str(tmp_path))
    calls = {"n": 0}

    def build():
        calls["n"] += 1
        return {"artifact": 42}

    v1, hit1 = cache.get_or_build("svc/a", build)
    v2, hit2 = cache.get_or_build("svc/a", build)
    assert v1 == v2 == {"artifact": 42}
    assert (hit1, hit2) == (False, True)
    assert calls["n"] == 1


def test_decentralized_beats_centralized(tmp_path):
    """With identical per-node work, decentralized wall time scales far
    better (the paper's Fig. 7 effect, modulo simulated RTT)."""
    def ctx(node_id, role):
        time.sleep(0.004)          # contextualization work per node
        return {}

    dec = DecentralizedDeployer(ImageCache(str(tmp_path)), rtt_s=0.02)
    cen = CentralizedDeployer(rtt_s=0.02, pushes_per_node=2)
    r_dec = min((dec.deploy(16, ctx) for _ in range(3)),
                key=lambda r: r.wall_s)
    r_cen = min((cen.deploy(16, ctx) for _ in range(3)),
                key=lambda r: r.wall_s)
    assert r_dec.wall_s < r_cen.wall_s / 2
    assert r_cen.modeled_network_s > r_dec.modeled_network_s


def test_deployer_raises_a_builders_error(tmp_path):
    """A node's failure (a model build out of device memory) surfaces from
    ``deploy``, not only inside a future."""
    def ctx(node_id, role):
        if node_id == 0:
            raise MemoryError("out of device memory")
        return {}
    with pytest.raises(MemoryError, match="out of device memory"):
        DecentralizedDeployer(ImageCache(str(tmp_path)), rtt_s=0).deploy(
            2, ctx, simulate_network=False)


def test_vre_lifecycle_and_endpoints(tmp_path):
    cfg = VREConfig(name="t", mesh_shape=(1, 1),
                    services=["volumes", "data", "dashboard"],
                    arch="yi-9b", provider="cpu", workdir=str(tmp_path))
    vre = VirtualResearchEnvironment(cfg)
    vre.instantiate()
    assert vre.state == "RUNNING"
    assert vre.endpoints.resolve("volumes").startswith("vre://t/")
    st = vre.status()
    assert set(st["services"]) == {"volumes", "data", "dashboard"}
    assert all(s["healthy"] for s in st["services"].values())
    vre.destroy()
    assert vre.state == "DESTROYED"
    with pytest.raises(RuntimeError):
        vre.service("volumes")


def test_vre_services_work_end_to_end(tmp_path):
    """The default template's services do their work: volumes save and
    restore, data yields batches of the reduced vocabulary, workflows run a
    partitioned DAG, the dashboard summarises."""
    cfg = VREConfig(name="t", services=["volumes", "data", "dashboard",
                                        "workflows"],
                    arch="yi-9b", provider="cpu", workdir=str(tmp_path))
    vre = VirtualResearchEnvironment(cfg)
    vre.instantiate()
    try:
        state = {"w": torch.arange(6.0).reshape(2, 3)}
        vre.service("volumes").save(state, step=1, blocking=True)
        back = vre.service("volumes").restore(state)
        assert torch.equal(back["w"], state["w"])
        batch = next(iter(vre.service("data")))
        assert batch["inputs"].shape == (8, 64) and batch["inputs"].max() < 503
        wf = vre.service("workflows").new("w")
        wf.map_partitions("sq", lambda p: int((p ** 2).sum()),
                          np.arange(10), 3, reducer=sum)
        assert vre.service("workflows").run(wf)["sq:gather"] == 285
        assert isinstance(vre.service("dashboard").metrics(), dict)
    finally:
        vre.destroy()


def test_failed_build_releases_what_was_built(tmp_path):
    # an embeddings-input arch's trainer fails at build (ROADMAP A.7c)
    cfg = VREConfig(name="t", services=["volumes", "lm-trainer"],
                    arch="musicgen-medium", provider="cpu",
                    workdir=str(tmp_path))
    vre = VirtualResearchEnvironment(cfg)
    with pytest.raises(NotImplementedError, match=r"A\.7c"):
        vre.instantiate()
    assert vre.services == {} and vre.mesh is None
    assert vre.state != "RUNNING"


def test_endpoint_lease_refreshes_and_goes_stale():
    d = EndpointDirectory(default_ttl_s=0.0)
    d.publish("svc", "vre://a/svc@g1")
    d.set_refresher(lambda name: ("vre://a/svc@g2", {}))
    assert d.resolve("svc") == "vre://a/svc@g2" and d.refreshes == 1
    d.set_refresher(lambda name: None)
    with pytest.raises(StaleEndpoint):
        d.resolve("svc")
    with pytest.raises(KeyError):
        d.resolve("other")


# -- the device substrate ----------------------------------------------------

def test_default_provider_is_the_card():
    assert VREConfig(name="t").provider == "h100"


@pytest.mark.parametrize("provider,shape,match", [
    ("cpu", (2, 1), "provider has 1 devices, VRE wants 2"),
    ("h100", (1, 1), "no CUDA device is visible"),
])
def test_procure_mesh_raises_on_too_few_devices(tmp_path, provider, shape,
                                                match, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    vre = VirtualResearchEnvironment(VREConfig(
        name="t", mesh_shape=shape, provider=provider,
        workdir=str(tmp_path)))
    with pytest.raises(RuntimeError, match=match):
        vre.instantiate()
    assert vre.state == "DEFINED"


def test_procure_mesh_rejects_an_unknown_provider(tmp_path):
    vre = VirtualResearchEnvironment(VREConfig(
        name="t", provider="tpu-v5e", workdir=str(tmp_path)))
    with pytest.raises(ValueError, match="unknown provider"):
        vre.instantiate()


def test_mesh_of_the_cards(tmp_path, monkeypatch):
    """Provider h100 procures every visible card, shaped like the mesh
    (a host with two cards, simulated; nothing touches a device)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    vre = VirtualResearchEnvironment(VREConfig(
        name="t", mesh_shape=(2, 1), provider="h100", workdir=str(tmp_path)))
    mesh = vre._procure_mesh()
    assert isinstance(mesh, DeviceMesh)
    assert mesh.shape == {"data": 2, "model": 1} and mesh.devices.size == 2
    assert mesh.axis_names == ("data", "model")
    assert list(mesh.devices.flat) == [DeviceShare(torch.device("cuda", 0)),
                                       DeviceShare(torch.device("cuda", 1))]
    assert [resolve_device(d) for d in mesh.devices.flat] == [
        torch.device("cuda", 0), torch.device("cuda", 1)]


def test_request_resize_records_and_resize_raises(tmp_path):
    vre = VirtualResearchEnvironment(VREConfig(
        name="t", mesh_shape=(1, 1), provider="cpu", workdir=str(tmp_path)))
    assert vre.request_resize() == (2, 1)
    assert vre.pending_resize == (2, 1)
    assert vre.request_resize((4, 2)) == (4, 2)
    # a resize past the provider's one host device raises after the
    # destroy, as the JAX VRE does
    with pytest.raises(RuntimeError, match="provider has 1 devices, VRE "
                                           "wants 2"):
        vre.resize((2, 1))


# -- tests/test_workflow_scheduler.py ----------------------------------------

def test_toposort_and_local_run():
    wf = Workflow("t")
    wf.add("a", lambda: 1)
    wf.add("b", lambda a: a + 1, deps=["a"])
    wf.add("c", lambda a, b: a + b, deps=["a", "b"])
    assert wf.run_local() == {"a": 1, "b": 2, "c": 3}


def test_cycle_detection():
    wf = Workflow("cyc")
    wf.add("a", lambda b: b, deps=["b"])
    wf.add("b", lambda a: a, deps=["a"])
    with pytest.raises(ValueError):
        wf.toposort()


def test_scheduler_matches_local_reference():
    data = np.arange(500, dtype=np.float64)
    wf, wf2 = Workflow("m"), Workflow("m")
    for w in (wf, wf2):
        w.map_partitions("sq", lambda p: float((p ** 2).sum()), data, 7,
                         reducer=sum)
    local = wf.run_local()
    dist = ClusterScheduler(num_workers=4).run(wf2)
    assert abs(local["sq:gather"] - dist["sq:gather"]) < 1e-9


def test_failure_rescheduling_and_exhaustion():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    wf = Workflow("f")
    wf.add("x", flaky, retries=3)
    sched = ClusterScheduler(num_workers=3)
    assert sched.run(wf)["x"] == "ok"
    assert sched.stats["rescheduled"] == 2

    wf2 = Workflow("f2")
    wf2.add("x", lambda: (_ for _ in ()).throw(RuntimeError("always")),
            retries=1)
    with pytest.raises(RuntimeError):
        ClusterScheduler(num_workers=3).run(wf2)


def test_dead_worker_does_not_block_dag():
    sched = ClusterScheduler(num_workers=3, monitor=Monitor())
    sched.kill_worker(0)
    wf = Workflow("d")
    for i in range(6):
        wf.add(f"t{i}", lambda i=i: i * i, group="t")
    assert sched.run(wf) == {f"t{i}": i * i for i in range(6)}


def test_straggler_speculation_wins():
    sched = ClusterScheduler(num_workers=4, speculation_factor=2.0,
                             speculation_min_s=0.05)
    slow_once = {"fired": False}
    lock = threading.Lock()

    def tool(i):
        with lock:
            first = not slow_once["fired"] and i == 7
            if first:
                slow_once["fired"] = True
        time.sleep(1.0 if first else 0.01)
        return i

    wf = Workflow("s")
    for i in range(8):
        wf.add(f"p{i}", tool, args=(i,), group="pool")
    t0 = time.perf_counter()
    res = sched.run(wf)
    assert res["p7"] == 7
    assert sched.stats["speculative"] >= 1
    assert time.perf_counter() - t0 < 1.0   # didn't wait for the straggler


# -- tests/test_checkpoint_data.py -------------------------------------------

def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)},
            "layers": [torch.full((2,), 0.5), torch.tensor([1, 2])]}


def _leaves(tree):
    from repro_torch.checkpoint.store import _flatten_with_paths
    return _flatten_with_paths(tree)


def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), num_servers=2)
    state = _state()
    store.save(state, step=3, blocking=True)
    assert store.latest_step() == 3
    like = {k: v if not isinstance(v, dict) else
            {kk: torch.zeros_like(vv) for kk, vv in v.items()}
            for k, v in state.items()}
    back = store.restore(like)
    assert [k for k, _ in _leaves(back)] == [k for k, _ in _leaves(state)]
    for (_, a), (_, b) in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["layers"], list)


def test_checkpoint_async_commit_and_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), num_servers=2)
    for s in (1, 2, 3, 4):
        store.save(_state(), step=s)
    store.wait()
    assert store.latest_step() == 4
    store.gc(keep_last=2)
    assert store.latest_step() == 4
    assert store.restore(_state(), step=3) is not None
    with pytest.raises(FileNotFoundError):
        store.restore(_state(), step=1)


def test_uncommitted_checkpoint_invisible(tmp_path):
    store = CheckpointStore(str(tmp_path))
    d = store.step_dir(9)
    d.mkdir(parents=True)
    (d / "garbage.npy").write_bytes(b"xx")          # no COMMITTED marker
    assert store.latest_step() is None


def _jax_state():
    """_state() as the JAX package holds it."""
    return {"params": {"w": jnp.arange(12.0).reshape(3, 4),
                       "b": jnp.ones(4, jnp.bfloat16)},
            "opt": {"count": jnp.asarray(7, jnp.int32)},
            "layers": [jnp.full((2,), 0.5), jnp.asarray([1, 2], jnp.int32)]}


def _bits(x) -> np.ndarray:
    """Raw bytes of a leaf of either package, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_crosses_between_the_packages_bit_exact(tmp_path, saver):
    if saver == "jax":
        JaxStore(str(tmp_path)).save(_jax_state(), step=5, blocking=True)
        state = _state()
        state["layers"][1] = state["layers"][1].to(torch.int32)
        back = CheckpointStore(str(tmp_path)).restore(state)
        pairs = zip(_leaves(_jax_state()), _leaves(back))
    else:
        state = _state()
        state["layers"][1] = state["layers"][1].to(torch.int32)
        CheckpointStore(str(tmp_path)).save(state, step=5, blocking=True)
        back = JaxStore(str(tmp_path)).restore(_jax_state())
        pairs = zip(_leaves(state), _leaves(jax.tree.map(np.asarray, back)))
    for (ka, a), (kb, b) in pairs:
        assert ka == kb
        assert str(getattr(a, "dtype")).removeprefix("torch.") == \
            str(getattr(b, "dtype")).removeprefix("torch.")
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_data_determinism_and_host_sharding():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=8)
    a = SyntheticLMData(cfg, host_id=0, num_hosts=2)
    b = SyntheticLMData(cfg, host_id=1, num_hosts=2)
    a1, a2 = a.batch(5), a.batch(5)
    np.testing.assert_array_equal(a1["inputs"], a2["inputs"])
    assert not np.array_equal(a1["inputs"], b.batch(5)["inputs"])
    assert a1["inputs"].shape == (4, 32)
    assert (a1["inputs"] > 0).all() and (a1["inputs"] < 100).all()
    full = np.concatenate([a1["inputs"], a1["labels"][:, -1:]], axis=1)
    np.testing.assert_array_equal(full[:, 1:], a1["labels"])
    with pytest.raises(ValueError, match="split"):
        SyntheticLMData(cfg, num_hosts=3)


@pytest.mark.parametrize("host,embeddings_dim", [(0, 0), (1, 0), (2, 16)])
def test_data_batches_equal_the_jax_pipelines(host, embeddings_dim):
    kw = dict(vocab_size=503, seq_len=48, global_batch=12, seed=3,
              mean_doc_len=20, embeddings_dim=embeddings_dim)
    ours = SyntheticLMData(DataConfig(**kw), host_id=host, num_hosts=3)
    theirs = JaxData(JaxDataConfig(**kw), host_id=host, num_hosts=3)
    for step in (0, 7):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_device_batch_and_partitions():
    batch = SyntheticLMData(DataConfig(vocab_size=50, seq_len=8,
                                       global_batch=2)).batch(0)
    placed = device_batch(batch, "cpu")
    assert placed["inputs"].dtype == torch.int32
    assert torch.equal(placed["labels"], torch.as_tensor(batch["labels"]))
    parts = split_partitions(np.arange(10), 3)
    assert [len(p) for p in parts] == [4, 3, 3]


def test_prefetcher_preserves_order():
    it = iter([{"x": np.full(2, i)} for i in range(10)])
    assert [b["x"][0] for b in Prefetcher(it, depth=3)] == list(range(10))
