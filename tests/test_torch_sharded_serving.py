"""Prefill and decode under a sharding policy: the port's dense, rolling
and MoE transformers on 4 gloo ranks on the CPU, float32, against the
unsharded port and the JAX package, and the prefill and decode kinds'
abstract specs against JAX's.

Reduced yi-9b, gemma2-27b (rolling local caches: a 40-token prompt past
its 32-token window), gemma3-12b (qk norm) and granite-moe-1b-a400m
(expert parallel, at capacity factor 1.0 so that tokens drop) on two
meshes: (data 2, model 2), "heads" for prefill and decode (2 of 4 q heads
and 1 of 2 kv heads a rank); and (data 1, model 4), "expand" prefill (one q
head a rank, kv expanded, the cache's sequence over ``model``) and
"head_dim" decode (4 of 16 a rank; rope's exchange, the qk norm's and the
scores' all-reduces). Each run prefills 4 x 40 tokens to max_seq 48 under
a prefill-kind policy, places the caches for a decode-kind policy's model
and decodes 6 steps fed JAX's greedy tokens (the last step's row 0 at
position 48, past the end, where nothing is written), then 2 steps from
the decode model's ``init_cache``. Granite's expert capacity follows the
batch shard, so at (data 2, model 2) it is fed seeded tokens and held to
JAX on a (2, 2) mesh of 4 forced host devices (a subprocess, run beside
the ranks), elsewhere to the unsharded port and JAX. One spawn of the
ranks for every run (``tests/torch_dist_ranks.py``), the unsharded port's
steps once for each config.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from conftest import run_devices  # noqa: E402
from repro.configs import ARCHS, SHAPES, get_config, reduced  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

B, S, MAX_SEQ, STEPS = 4, 40, 48, 6
GRANITE = "granite-moe-1b-a400m"
# logits, caches: f32 through 2-4 reduced layers, summed in another order
# over the ranks (the unsharded port and JAX agree to ~1e-5)
ATOL, RTOL = 1e-4, 1e-5
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCH_RUNS = ("yi-9b", "gemma2-27b", "gemma3-12b", GRANITE)
RUNS = [(a, m) for a in ARCH_RUNS for m in MESHES]
IDS = [f"{a}-{m}" for a, m in RUNS]
MODES = {"2x2": ("heads", "heads"), "1x4": ("expand", "head_dim")}


def _over(arch, port: bool):
    """Granite at capacity factor 1.0: with 2 of 8 experts a token, 16
    tokens a rank keep 4 places an expert, so some tokens drop."""
    if arch != GRANITE:
        return {}
    cfg = t_reduced(t_get_config(arch)) if port else reduced(get_config(arch))
    return {"moe": dataclasses.replace(cfg.moe, capacity_factor=1.0)}


def _perturb(tree, seed=0):
    """Every all-zero leaf (the norm weights) drawn from N(0, 0.1²), so
    the norms' weights take part."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.size and not x.any():
            return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def _jax_serve(cfg, params, toks):
    """``_jax_serve_once``, each config once (the meshes share it)."""
    key = cfg.name
    if key not in _SERVED:
        _SERVED[key] = _jax_serve_once(cfg, params, toks)
    return _SERVED[key]


_SERVED = {}


def _jax_serve_once(cfg, params, toks):
    """JAX's unsharded prefill and greedy decode (its own tokens fed back,
    the last step's row 0 at MAX_SEQ): (numpy results, the tokens fed)."""
    m = JM.build_model(cfg)
    prefill = jax.jit(m.prefill, static_argnums=2)
    decode = jax.jit(m.decode)
    lg, c = prefill(params, jnp.asarray(toks, jnp.int32), MAX_SEQ)
    out = {"prefill": np.asarray(lg), "prefill_caches": jax.tree.map(
        np.asarray, c), "decode": []}
    feed = []
    for t in range(STEPS):
        nxt = np.asarray(lg[:, -1, :cfg.vocab_size].argmax(-1), np.int32)
        feed.append(nxt)
        pos = np.full((B,), S + t, np.int32)
        if t == STEPS - 1:
            pos[0] = MAX_SEQ
        lg, c = decode(params, c, jnp.asarray(nxt)[:, None],
                       jnp.asarray(pos))
        out["decode"].append(np.asarray(lg))
    out["decode_caches"] = jax.tree.map(np.asarray, c)
    return out, np.stack(feed, 1)


# granite at (data 2, model 2) is fed these tokens, the same in JAX on the
# mesh: its greedy tokens are compared step by step, not fed back
MESH_FEED_SEED = 4


def _jax_mesh_code(path) -> str:
    """Granite on JAX with 4 forced host devices: prefill under a
    prefill-kind policy and decode under a decode-kind one on a (data 2,
    model 2) mesh, from PRNGKey(0) params, fed seeded tokens; an .npz at
    ``path``."""
    return f"""
        import dataclasses, jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro.configs import get_config, reduced
        from repro.configs.base import ShapeConfig
        from repro.launch import specs
        from repro.models.model import build_model
        cfg = reduced(get_config("{GRANITE}"))
        cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.
                                  replace(cfg.moe, capacity_factor=1.0))
        mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
        pp, par = specs.make_policy(cfg, ShapeConfig("p", {S}, {B},
                                                      "prefill"), mesh)
        pd, _ = specs.make_policy(cfg, ShapeConfig("d", {MAX_SEQ}, {B},
                                                    "decode"), mesh)
        mp, md = build_model(cfg, mesh, par, pp), build_model(cfg, mesh,
                                                                par, pd)
        params, _ = mp.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(3).integers(1, cfg.vocab_size,
                                                 ({B}, {S})).astype(np.int32)
        feed = np.random.default_rng({MESH_FEED_SEED}).integers(
            1, cfg.vocab_size, ({B}, {STEPS})).astype(np.int32)
        out = {{}}
        with mesh:
            lg, c = jax.jit(lambda p, x: mp.prefill(p, x, {MAX_SEQ}))(
                params, toks)
            out["prefill"] = np.asarray(lg)
            for i, x in enumerate(jax.tree.leaves(c)):
                out["pc_%d" % i] = np.asarray(x)
            dec = jax.jit(md.decode)
            for t in range({STEPS}):
                pos = np.full(({B},), {S} + t, np.int32)
                if t == {STEPS} - 1:
                    pos[0] = {MAX_SEQ}
                lg, c = dec(params, c, jnp.asarray(feed[:, t:t + 1]),
                            jnp.asarray(pos))
                out["d_%d" % t] = np.asarray(lg)
            for i, x in enumerate(jax.tree.leaves(c)):
                out["dc_%d" % i] = np.asarray(x)
        np.savez("{path}", **out)
        print("OK")
    """


def _unflatten(like, flat, prefix):
    n = len(jax.tree.leaves(like))
    return jax.tree.unflatten(jax.tree.structure(like),
                              [flat[f"{prefix}_{i}"] for i in range(n)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded references here and granite's on the mesh in a
    subprocess, while the ranks take every run."""
    path = tmp_path_factory.mktemp("jax") / "granite_mesh.npz"
    refs, args = {}, []
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        on_mesh = pool.submit(run_devices, _jax_mesh_code(path), 4)
        for arch, mesh in RUNS:
            cfg = dataclasses.replace(reduced(get_config(arch)),
                                      dtype="float32", **_over(arch, False))
            params, _ = JM.build_model(cfg).init(jax.random.PRNGKey(0))
            params = jax.tree.map(np.asarray, params)
            toks = np.random.default_rng(3).integers(
                1, cfg.vocab_size, (B, S)).astype(np.int32)
            if arch == GRANITE and mesh == "2x2":
                feed = np.random.default_rng(MESH_FEED_SEED).integers(
                    1, cfg.vocab_size, (B, STEPS)).astype(np.int32)
                refs[arch, mesh] = (None, feed)
                key = f"{arch}-unperturbed"
            else:
                params = _perturb(params)
                refs[arch, mesh] = _jax_serve(cfg, params, toks)
                key = arch
            args.append({"arch": arch, "over": _over(arch, True),
                         "mesh": MESHES[mesh], "params": params,
                         "tokens": toks.astype(np.int64),
                         "feed": refs[arch, mesh][1].astype(np.int64),
                         "max_seq": MAX_SEQ, "ref_key": key})
        out, units = run_ranks(ranks.serving_cases, 4, args=(args,),
                               timeout=600)[0]
        on_mesh.result()
    flat = dict(np.load(path))
    cfg = dataclasses.replace(reduced(get_config(GRANITE)), dtype="float32",
                              **_over(GRANITE, False))
    m = JM.build_model(cfg)
    like = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0))[0])
    pc = jax.eval_shape(lambda p, x: m.prefill(p, x, MAX_SEQ)[1], like,
                        jax.ShapeDtypeStruct((B, S), jnp.int32))
    refs[GRANITE, "2x2"] = (
        {"prefill": flat["prefill"],
         "prefill_caches": _unflatten(pc, flat, "pc"),
         "decode": [flat[f"d_{t}"] for t in range(STEPS)],
         "decode_caches": _unflatten(pc, flat, "dc"), "on_mesh": True},
        refs[GRANITE, "2x2"][1])
    for run in RUNS:
        if not refs[run][0].get("on_mesh"):
            refs[run][0]["on_mesh"] = False
    return {run: (refs[run], res) for run, res in zip(RUNS, out)}, units


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} leaf {i}")


def _sides(runs, run):
    """[(name, reference results)]: JAX (on the mesh for granite at data
    2), and the unsharded port where its function is the sharded one's."""
    (ref, _), res = runs[0][run]
    sides = [("jax", ref)]
    if not ref["on_mesh"]:
        sides.append(("port", res["port"]))
    return sides, res["sharded"]


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_prefill_logits_and_caches(runs, run):
    """The last position's logits and every layer's K/V cache, gathered
    whole, against JAX and the unsharded port."""
    sides, got = _sides(runs, run)
    assert got["modes"][:2] == MODES[run[1]]
    for name, want in sides:
        _close(got["prefill"], want["prefill"], f"{name} prefill logits")
        _close(got["prefill_caches"], want["prefill_caches"],
               f"{name} prefill caches")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_decode_logits_caches_and_greedy_tokens(runs, run):
    """Six decode steps fed JAX's greedy tokens (granite at (2, 2): seeded
    tokens, the same on JAX's mesh; the last step past the cache's end for
    row 0): each step's logits and the final caches against JAX and the
    unsharded port; the sharded argmax at each step is JAX's."""
    sides, got = _sides(runs, run)
    (_, feed) = runs[0][run][0]
    for name, want in sides:
        for t in range(STEPS):
            _close(got["decode"][t], want["decode"][t],
                   f"{name} decode step {t}")
        _close(got["decode_caches"], want["decode_caches"],
               f"{name} decode caches")
    vocab = t_reduced(t_get_config(run[0])).vocab_size

    def greedy(res):
        return np.stack([res["prefill"][:, -1, :vocab].argmax(-1)] + [
            res["decode"][t][:, -1, :vocab].argmax(-1)
            for t in range(STEPS - 1)], 1)
    ref = runs[0][run][0][0]
    # JAX's greedy tokens: the ones fed, or on the mesh its own argmax
    np.testing.assert_array_equal(
        greedy(got), greedy(ref) if ref["on_mesh"] else feed)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_decode_from_init_cache(runs, run):
    """Two steps from the decode model's ``init_cache`` (DTensor zeros in
    ``abstract_cache``'s specs) against the unsharded port's."""
    (_, res) = runs[0][run]
    got = res["sharded"]
    assert got["placed"]
    if run != (GRANITE, "2x2"):
        for t in range(2):
            _close(got["from_init"][t], res["port"]["from_init"][t],
                   f"from init step {t}")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_each_kinds_model_runs_the_other_kinds_step(runs, run):
    """The decode-kind model's prefill ("head_dim" at (1, 4): q, k and v
    gathered for flash) and the prefill-kind model's first decode step on
    its own caches ("expand" at (1, 4): the sequence-sharded cache
    gathered) give the unsharded port's logits."""
    (_, res) = runs[0][run]
    if run != (GRANITE, "2x2"):
        got, want = res["sharded"]["cross"], res["port"]
        _close(got[0], want["prefill"], "decode-kind prefill")
        _close(got[1], want["decode"][0], "prefill-kind decode")


# flash's (q, k) shapes on a rank: (data 2, model 2) its 2 of 4 q heads and
# 1 of 2 kv heads; (data 1, model 4) its one q head and that head's kv
# head, expanded
LOCAL_FLASH = {"2x2": ((2, S, 2, 16), (2, S, 1, 16)),
               "1x4": ((4, S, 1, 16), (4, S, 1, 16))}


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_flash_runs_on_each_ranks_heads(runs, run):
    """The sharded prefill's flash op sees this rank's rows and heads."""
    got = runs[0][run][1]["sharded"]
    assert got["kernel_shapes"] == {"flash": [LOCAL_FLASH[run[1]]],
                                    "ssd": []}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_head_dim_rope_and_norms_give_the_unsharded_values(runs, mesh):
    """Rope's exchange gives the unsharded rotation bit for bit; the qk
    norm over the whole head dim and the gated norm over a sharded
    ``d_inner`` within f32 rounding of the sums' order."""
    diffs = runs[1][MESHES[mesh]]
    assert diffs["rope"] == 0.0
    assert diffs["qk_norm"] < 1e-6 and diffs["gated_norm"] < 1e-6


def test_chunk_and_verify_refuse_a_policy():
    """``prefill_chunk`` and ``decode_verify`` keep their refusal under a
    policy (no JAX code runs them sharded); prefill and decode are
    there."""
    cfg = t_reduced(t_get_config("yi-9b"))
    tmesh = t_mesh.AbstractMesh((2, 2), ("data", "model"))
    policy, par = specs.make_policy(cfg, T_SHAPES["decode_32k"], tmesh)
    model = build_model(cfg, "meta", tmesh, par, policy)
    for name in ("prefill_chunk", "decode_verify"):
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            getattr(model, name)(None, None, None, None)
    assert callable(model.prefill) and callable(model.decode)


# -- the abstract specs of the prefill and decode kinds -----------------------

SPEC_MESHES = {"1pod": ((16, 16), ("data", "model")),
               "2pod": ((2, 16, 16), ("pod", "data", "model"))}
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _spec(p):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


def _jax_specs(tree):
    return [_spec(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def _sds(tree):
    """(shape, dtype, spec) of each ShapeDtypeStruct of a JAX tree."""
    return [(tuple(s.shape), str(s.dtype), _spec(s.sharding.spec))
            for s in jax.tree.leaves(tree)]


def _meta(tree, spec_tree):
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch."), sp)
            for t, sp in zip(leaves(tree), ranks._leaves(spec_tree))]


def _pair(t):
    """A (meta tensor, spec) pair as (shape, dtype, spec)."""
    return (tuple(t[0].shape), str(t[0].dtype).removeprefix("torch."), t[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    """``input_specs`` of every kind (``abstract_cache`` and
    ``decode_specs`` through it) against JAX's, for train_4k, prefill_32k,
    decode_32k and long_500k where the arch runs them, on the single- and
    multi-pod meshes: every argument's shape, dtype and spec, the specs of
    JAX's aux (params, state, caches), the caches' axes, and the policy's
    fallbacks in order."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    for mesh_name, (shape, axes) in SPEC_MESHES.items():
        jmesh, tmesh = AbstractMesh(shape, axes), t_mesh.AbstractMesh(
            shape, axes)
        for name in SHAPE_NAMES:
            if name not in cfg.runnable_shapes():
                continue
            where = (mesh_name, name)
            jpol, jpar = jax_specs.make_policy(cfg, SHAPES[name], jmesh)
            tpol, tpar = specs.make_policy(tcfg, T_SHAPES[name], tmesh)
            jargs, jaux = jax_specs.input_specs(
                cfg, SHAPES[name], jpol, JM.build_model(cfg, jmesh, jpar,
                                                        jpol))
            targs, taux = specs.input_specs(
                tcfg, T_SHAPES[name], tpol,
                build_model(tcfg, "meta", tmesh, tpar, tpol))
            assert len(targs) == len(jargs), where
            kind = SHAPES[name].kind
            if kind == "train":
                jstate, tstate = jargs[0], targs[0]
                assert _meta(tstate["params"], taux["state_sh"]["params"]) \
                    == _sds(jstate["params"]), where
                for k in ("m", "v"):
                    assert _meta(tstate["opt"][k],
                                 taux["state_sh"]["opt"][k]) == \
                        _sds(jstate["opt"][k]), (where, k)
                assert taux["moment_dtype"] == jaux["moment_dtype"]
                batch = [(k, targs[1][k], jargs[1][k])
                         for k in ("inputs", "labels")]
            else:
                assert _meta(targs[0], taux["params_sh"]) == \
                    _sds(jargs[0]), where
                assert ranks._leaves(taux["params_sh"]) == \
                    _jax_specs(jaux["params_sh"]), where
                batch = [("inputs", targs[1], jargs[1])]
            if kind == "decode":
                assert _meta(targs[1], taux["cache_sh"]) == \
                    _sds(jargs[1]), where
                assert ranks._leaves(taux["cache_sh"]) == \
                    _jax_specs(jaux["cache_sh"]), where
                assert ranks._leaves(taux["cache_axes"]) == [
                    tuple(a) for a in jax.tree.leaves(
                        jaux["cache_axes"], is_leaf=_axes_leaf)], where
                batch = [("inputs", targs[2], jargs[2]),
                         ("pos", targs[3], jargs[3])]
            for k, t, j in batch:
                assert _pair(t) == _sds(j)[0], (where, k)
            assert tpol.fallbacks == jpol.fallbacks, where


def _axes_leaf(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)
