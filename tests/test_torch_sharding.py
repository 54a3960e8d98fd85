"""The port's sharding rules and abstract specs against the JAX package's,
with no process group (both sides on abstract meshes): for every arch and
step kind on the (16, 16) and (2, 16, 16) production meshes, the policy's
mode, h_pad, every param's spec and the fallbacks; long_500k's sharded KV
sequence; the params' logical axes and shapes leaf for leaf at reduced
size and, through meta tensors, at full width; the abstract optimizer
state and batch; and the int8 quantisation helpers bit for bit. The
coverage ``tests/test_sharding_policy.py`` means to give (it fails at
collection on this JAX)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS, SHAPES, get_config, reduced  # noqa: E402
from repro.distributed import collectives as jax_coll  # noqa: E402
from repro.distributed.sharding import Parallelism as JaxPar  # noqa: E402
from repro.distributed.sharding import ShardingPolicy as JaxPolicy  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.pipeline import bubble_fraction  # noqa: E402
from repro_torch.distributed.sharding import (Parallelism,  # noqa: E402
                                              ShardingPolicy, is_axes_leaf)
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.layers import MetaGenerator  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), t_mesh.AbstractMesh(shape, axes)


def _spec(p):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


_CACHE = {}


def _cached(key, make):
    """The params of a (arch, h_pad) depend on nothing else: built once."""
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _jax_params(cfg, mesh, par, policy):
    """(abstract params, axes) of JAX's ``build_model`` under ``policy``
    (whose q-head padding is all that shapes them)."""
    pad = policy is not None and policy.mode == "expand"
    return _cached(("jax", cfg.name, policy.h_pad if pad else None),
                   lambda: _jax_init_shapes(cfg, mesh, par, policy))


def _jax_init_shapes(cfg, mesh, par, policy):
    model = jax_build(cfg, mesh, par, policy)
    cap = {}

    def only_p(key):
        p, ax = model.init(key)
        cap["ax"] = ax
        return p
    return jax.eval_shape(only_p, jax.random.PRNGKey(0)), cap["ax"]


def _axes_leaves(tree):
    if is_axes_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _axes_leaves(tree[k])]
    return [x for v in tree for x in _axes_leaves(v)]


def _spec_leaves(tree):
    """A spec tree's leaves (tuples) in ``leaves``' order."""
    if isinstance(tree, tuple):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for v in tree for x in _spec_leaves(v)]


def _port_model(cfg, mesh, par, policy):
    return build_model(cfg, "meta", mesh, par, policy)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_matches_jax(arch, kind):
    """On both production meshes: the attention mode, h_pad, the spec of
    every leaf of the params' axes tree (JAX's leaves and shapes through
    the port's policy, and the port's own meta params and axes), and the
    fallbacks in order."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        jpar, tpar = JaxPar.for_mesh(jmesh), Parallelism.for_mesh(tmesh)
        assert dataclasses.asdict(tpar) == dataclasses.asdict(jpar)
        jpol = JaxPolicy(cfg, jmesh, jpar, kind=kind)
        tpol = ShardingPolicy(tcfg, tmesh, tpar, kind=kind)
        assert (tpol.mode, tpol.h_pad, tpol.tp) == \
            (jpol.mode, jpol.h_pad, jpol.tp), name
        sds, axes = _jax_params(cfg, jmesh, jpar, jpol)
        want = [_spec(s) for s in jax.tree.leaves(
            jpol.tree_specs(sds, axes), is_leaf=lambda x: isinstance(x, P))]
        got = [tpol.spec(s.shape, a) for s, a in
               zip(jax.tree.leaves(sds), _axes_leaves(axes))]
        assert got == want, name
        assert tpol.fallbacks == jpol.fallbacks, name
        # the port's own params under a policy of its own
        tpol = ShardingPolicy(tcfg, tmesh, tpar, kind=kind)
        pad = tpol.h_pad if tpol.mode == "expand" else None
        params, taxes, _ = _cached(
            ("port", arch, pad), lambda: specs.abstract_params(
                _port_model(tcfg, tmesh, tpar, tpol), tpol))
        assert _spec_leaves(tpol.tree_specs(params, taxes)) == want, name
        assert tpol.fallbacks == jpol.fallbacks, name


@pytest.mark.parametrize("arch", [a for a in ARCHS if "long_500k" in
                                  get_config(a).runnable_shapes()])
def test_long_context_policy_shards_the_cache_sequence(arch):
    """``make_policy`` for long_500k: the KV cache's sequence over the batch
    axes (batch 1 falls back), on both meshes."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        jpol, _ = jax_specs.make_policy(cfg, SHAPES["long_500k"], jmesh)
        tpol, _ = specs.make_policy(tcfg, T_SHAPES["long_500k"], tmesh)
        assert tpol.shard_seq_kv and jpol.shard_seq_kv
        for shape, axes in (
                ((1, 524288, max(cfg.num_kv_heads, 1), cfg.head_dim),
                 ("batch", "seq_kv", "kv_heads", "head_dim")),
                ((2, 524288, cfg.d_model), ("batch", "seq_kv", "act"))):
            assert tpol.spec(shape, axes) == _spec(jpol.spec(shape, axes))
        assert tpol.fallbacks == jpol.fallbacks


@pytest.mark.parametrize("arch", ARCHS)
def test_no_unexpected_fallbacks_on_production_mesh(arch):
    """Every param of every arch shards with zero fallbacks on 16 x 16
    (JAX's test of the same name)."""
    tcfg = t_get_config(arch)
    _, tmesh = _meshes("1pod")
    par = Parallelism.for_mesh(tmesh)
    pol = ShardingPolicy(tcfg, tmesh, par, kind="train")
    specs.abstract_params(_port_model(tcfg, tmesh, par, pol), pol)
    assert pol.fallbacks == []


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_axes_match_jax_init(arch, size):
    """``model.axes()`` is JAX's ``init`` axes tree leaf for leaf, with the
    stacked layer axis; the params' shapes and dtypes agree (reduced: real
    params on the CPU; full width: meta tensors against
    ``jax.eval_shape``)."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if size == "reduced":
        cfg, tcfg = reduced(cfg), t_reduced(tcfg)
    sds, axes = _jax_params(cfg, None, None, None)
    model = build_model(tcfg, "cpu")
    assert _axes_leaves(model.axes()) == _axes_leaves(axes)
    assert jax.tree.structure(model.axes(), is_leaf=is_axes_leaf) == \
        jax.tree.structure(axes, is_leaf=is_axes_leaf)
    params = model.init() if size == "reduced" else \
        model.init(MetaGenerator())
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for t in leaves(params)]
    want = [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(sds)]
    assert got == want
    if size == "full":
        assert all(t.device.type == "meta" for t in leaves(params))


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_abstract_opt_state_matches_jax(moments):
    """The AdamW state's shapes, dtypes and specs, and the batch's, for
    llama4 (padded heads) on the multi-pod mesh."""
    arch = "llama4-maverick-400b-a17b"
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jmesh, tmesh = _meshes("2pod")
    shape, tshape = SHAPES["train_4k"], T_SHAPES["train_4k"]
    jpol, jpar = jax_specs.make_policy(cfg, shape, jmesh)
    tpol, tpar = specs.make_policy(tcfg, tshape, tmesh)
    jp, jaxes, _ = jax_specs.abstract_params(
        jax_build(cfg, jmesh, jpar, jpol), jpol)
    tp, taxes, _ = specs.abstract_params(
        build_model(tcfg, "meta", tmesh, tpar, tpol), tpol)
    jopt, jsh = jax_specs.abstract_opt_state(jp, jaxes, jpol, moments)
    topt, tsh = specs.abstract_opt_state(tp, taxes, tpol, moments)
    assert sorted(topt) == sorted(jopt)
    for k in jopt:
        want = jax.tree.leaves(jopt[k])
        got = leaves(topt[k])
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for t in got] == [(tuple(s.shape), str(s.dtype))
                                  for s in want], k
        want_specs = [_spec(s.spec) for s in jax.tree.leaves(
            jsh[k], is_leaf=lambda x: hasattr(x, "spec"))]
        assert _spec_leaves(tsh[k]) == want_specs, k
    for mode_arch in (arch, "musicgen-medium"):
        c, tc = get_config(mode_arch), t_get_config(mode_arch)
        jb = jax_specs.batch_specs(c, shape, jax_specs.make_policy(
            c, shape, jmesh)[0])
        tb = specs.batch_specs(tc, tshape, specs.make_policy(
            tc, tshape, tmesh)[0])
        for k in ("inputs", "labels"):
            t, spec = tb[k]
            assert (tuple(t.shape), str(t.dtype).removeprefix("torch."),
                    spec) == (tuple(jb[k].shape), str(jb[k].dtype),
                              _spec(jb[k].sharding.spec)), (mode_arch, k)


def test_quantize_int8_matches_jax_bit_for_bit():
    """Seeded values and exact ties (k + 0.5 steps: half to even in both)."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    ties = (np.arange(-10, 10, dtype=np.float32) + 0.5) / 127.0
    for x in (g, np.concatenate([ties, [1.0]]).astype(np.float32)):
        jq, js = jax_coll.quantize_int8(jnp.asarray(x))
        tq, ts = collectives.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            collectives.dequantize_int8(tq, ts).numpy(),
            np.asarray(jax_coll.dequantize_int8(jq, js)))
    # a given scale, with values past the int8 range clipped
    jq, _ = jax_coll.quantize_int8(jnp.asarray(g), 0.01)
    tq, _ = collectives.quantize_int8(torch.from_numpy(g),
                                      torch.tensor(0.01))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_ef_compress_tree_matches_jax():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((8, 5)).astype(np.float32),
         "b": [rng.standard_normal((3,)).astype(np.float32)]}
    e = {"a": rng.standard_normal((8, 5)).astype(np.float32) * 1e-3,
         "b": [np.zeros(3, np.float32)]}
    for resid in (None, e):
        want = jax_coll.ef_compress_tree(
            jax.tree.map(jnp.asarray, g),
            None if resid is None else jax.tree.map(jnp.asarray, resid))
        got = collectives.ef_compress_tree(
            jax.tree.map(torch.from_numpy, g),
            None if resid is None else jax.tree.map(torch.from_numpy, resid))
        for w, t in zip(want, got):
            for wl, tl in zip(jax.tree.leaves(w), leaves(t)):
                np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))


def test_meshes_need_a_process_group_of_their_size():
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        t_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        t_mesh.make_production_mesh(multi_pod=True)
    assert t_mesh.AbstractMesh((2, 16, 16), ("pod", "data", "model")).size \
        == 512


def test_bubble_fraction():
    from repro.distributed.pipeline import bubble_fraction as jax_bubble
    for s, m in ((2, 4), (4, 8), (1, 3)):
        assert bubble_fraction(s, m) == jax_bubble(s, m)
