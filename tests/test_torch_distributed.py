"""The port's distributed layer on 4 gloo ranks on the CPU, against the JAX
package's: the expert-parallel MoE (``moe_apply`` on a (data 2, model 2)
mesh) against the dropless oracle and against JAX's ``shard_map`` branch on
a mesh of the same shape (JAX on 4 forced host devices in a subprocess),
its gradients against the single-rank layer's; and JAX's
``tests/test_distributed_subprocess.py`` cases at 4 ranks: the compressed
pod reduction, the GPipe pipeline, a checkpoint restored onto another mesh.
Each module fixture spawns its ranks once (``run_ranks``); the rank bodies
are in ``tests/torch_dist_ranks.py``."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from conftest import run_devices  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402

GRANITE = "granite-moe-1b-a400m"
# dropless (the oracle's), reduced granite's own, and one with drops: at
# 16 local tokens a rank, top 2 of 8 experts, capacity 16, 16, 4 a rank
FACTORS = (64.0, 4.0, 1.0)
# tests/test_distributed_subprocess.py's tolerance for the EP layer
TOL = 2e-5


N_STAGES, LAYERS_PER_STAGE = 2, 2


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's side on 4 forced host devices, in an .npz: reduced granite's
    MoE params (PRNGKey(0), f32), x (4, 8, d) from a seed, ``moe_apply`` on
    a (data 2, model 2) mesh at each factor and ``moe_apply_ref``; and
    ``pipeline_forward`` on a 2-stage pod axis of a (pod 2, data 2) mesh on
    seeded weights and microbatches."""
    path = tmp_path_factory.mktemp("jax") / "jax_side.npz"
    run_devices(f"""
        import dataclasses, jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro.configs import get_config, reduced
        from repro.distributed.pipeline import pipeline_forward
        from repro.distributed.sharding import Parallelism
        from repro.models.moe import moe_init, moe_apply, moe_apply_ref
        cfg = dataclasses.replace(reduced(get_config("{GRANITE}")),
                                  dtype="float32")
        mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
        par = Parallelism(("data",), ("data",), "model")
        p, _ = moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
        x = np.random.default_rng(1).standard_normal(
            (4, 8, cfg.d_model)).astype(np.float32)
        out = {{"p_" + k: np.asarray(v) for k, v in p.items()}}
        out["x"] = x
        with mesh:
            for cf in {FACTORS!r}:
                y, aux = jax.jit(lambda p, x: moe_apply(
                    p, cfg, x, mesh, par, capacity_factor=cf))(p, x)
                out[f"y_{{cf}}"], out[f"aux_{{cf}}"] = np.asarray(y), \\
                    np.asarray(aux)
        yr, auxr = moe_apply_ref(p, cfg, jnp.asarray(x))
        out["y_ref"], out["aux_ref"] = np.asarray(yr), np.asarray(auxr)

        pmesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("pod", "data"))
        rng = np.random.default_rng(0)
        ws = (rng.standard_normal(({N_STAGES}, {LAYERS_PER_STAGE}, 16, 16))
              * 0.3).astype(np.float32)
        xm = rng.standard_normal((4, 3, 16)).astype(np.float32)
        def body(params, h):
            for i in range({LAYERS_PER_STAGE}):
                h = jnp.tanh(h @ params[i])
            return h
        with pmesh:
            pp = jax.jit(lambda ws, x: pipeline_forward(
                pmesh, "pod", body, ws, x,
                layers_per_stage={LAYERS_PER_STAGE}))(ws, xm)
        out.update(pp_ws=ws, pp_x=xm, pp_out=np.asarray(pp))
        np.savez("{path}", **out)
        print("OK")
    """, n_devices=4)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_side(jax_side):
    """The port's side on 4 gloo ranks, one process group: (rank 0's EP
    results, every rank's compressed reduction, pipeline and restore)."""
    params = {k[2:]: v for k, v in jax_side.items() if k.startswith("p_")}
    g = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    out = run_ranks(ranks.distributed_cases, 4, args=(
        (GRANITE, params, jax_side["x"], FACTORS),
        (g, jax_side["pp_ws"], jax_side["pp_x"], N_STAGES,
         LAYERS_PER_STAGE)), timeout=300)
    return out[0][0], g, [o[1] for o in out], [o[2] for o in out]


@pytest.fixture(scope="module")
def jax_ep(jax_side):
    return jax_side


@pytest.fixture(scope="module")
def port_ep(port_side):
    return port_side[0]


def test_expert_parallel_moe_matches_the_dropless_oracle(jax_ep, port_ep):
    np.testing.assert_allclose(port_ep[64.0]["y"], jax_ep["y_ref"],
                               atol=TOL, rtol=TOL)
    # the load-balance term: the mean over the batch shards of each
    # shard's, JAX's pmean, not the oracle's over the whole batch
    np.testing.assert_allclose(port_ep[64.0]["aux"], jax_ep["aux_64.0"],
                               rtol=1e-6)


@pytest.mark.parametrize("cf", FACTORS[1:])
def test_expert_parallel_moe_matches_jax_on_the_same_mesh(jax_ep, port_ep,
                                                         cf):
    """Capacity from each rank's local tokens: at factor 1.0 the ranks drop
    tokens, so the result is JAX's on a (2, 2) mesh and neither the
    oracle's nor the single-rank layer's."""
    np.testing.assert_allclose(port_ep[cf]["y"], jax_ep[f"y_{cf}"],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port_ep[cf]["aux"], jax_ep[f"aux_{cf}"],
                               rtol=1e-6)
    if cf == 1.0:
        assert np.abs(port_ep[cf]["y"] - jax_ep["y_ref"]).max() > 1e-2


def test_expert_parallel_gradients_match_the_single_rank_layer(jax_ep,
                                                               port_ep):
    """d(sum(y * w) + aux) w.r.t. x and every param on the mesh (dropless)
    against the single-rank layer's on one process: the gradients summed
    over the experts' ranks and the batch shards, the load-balance term's
    counted once. On the mesh aux is the mean of each batch shard's term
    (JAX's pmean), so the reference takes the single-rank layer's aux of
    each half of the batch, averaged."""
    cfg = dataclasses.replace(t_reduced(t_get_config(GRANITE)),
                              dtype="float32")
    p = {k[2:]: torch.from_numpy(v).requires_grad_()
         for k, v in jax_ep.items() if k.startswith("p_")}
    x = torch.from_numpy(jax_ep["x"]).requires_grad_()
    y, _ = moe.moe_apply(p, cfg, x, capacity_factor=64.0)
    aux = sum(moe.moe_apply(p, cfg, half, capacity_factor=64.0)[1]
              for half in x.chunk(2)) / 2
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        x.shape, np.float32))
    names = sorted(p)
    want = torch.autograd.grad((y * w).sum() + aux, [x] + [p[k]
                                                          for k in names])
    got = port_ep[64.0]["grads"]
    for name, g in zip(["x"] + names, want):
        np.testing.assert_allclose(got[name], g.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)


# -- JAX's multi-device cases at 4 ranks -------------------------------------

@pytest.fixture(scope="module")
def port_cases(port_side):
    return port_side[1], port_side[2]


@pytest.fixture(scope="module")
def jax_pipeline(jax_side):
    return {k[3:]: v for k, v in jax_side.items() if k.startswith("pp_")}


def test_compressed_pod_psum(port_cases):
    """JAX's bounds: a leaf replicated over the pods reduces to itself
    within one int8 step, and the error-feedback residual is within half of
    one, on every rank."""
    g, out = port_cases
    scale = np.abs(g).max() / 127.0
    for red, resid in (o["psum"] for o in out):
        assert np.abs(red - g).max() <= scale + 1e-6
        assert np.abs(resid).max() <= scale * 0.5 + 1e-6


def test_pipeline_matches_sequential_and_jax(port_cases, jax_pipeline):
    ws, x = jax_pipeline["ws"], jax_pipeline["x"]
    ref = torch.from_numpy(x)
    for s in range(N_STAGES):
        for i in range(LAYERS_PER_STAGE):
            ref = torch.tanh(ref @ torch.from_numpy(ws[s, i]))
    for o in port_cases[1]:
        np.testing.assert_allclose(o["pipeline"], ref.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(o["pipeline"], jax_pipeline["out"],
                                   atol=1e-5, rtol=1e-5)


def test_checkpoint_restores_onto_another_mesh(port_cases):
    """Saved from a (data 2, model 2) mesh, restored onto (data 4, model 1):
    bit-equal, on the new mesh, each rank its own rows."""
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for rank, o in enumerate(port_cases[1]):
        r = o["reshard"]
        np.testing.assert_array_equal(r["full"], w)
        assert r["mesh"] == {"data": 4, "model": 1}
        np.testing.assert_array_equal(r["local"], w[2 * rank:2 * rank + 2])


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_on_sharded_leaves_matches_full_tensors(port_side, moments):
    """Two AdamW steps (clipped by the global norm) on DTensor leaves,
    sharded on one mesh axis, on both, or replicated: each rank updates its
    local shards, the norm's squares summed once per element over the
    ranks, int8 scales from the whole leaf; the same params, moments and
    scales as the steps on the full tensors, to f32 rounding, on every
    rank."""
    for diffs in port_side[3]:
        assert diffs[moments] <= 1e-6, diffs


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2"):
        run_ranks(ranks.fail_on_rank_one, 2, timeout=120)
