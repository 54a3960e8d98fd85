"""Rank bodies for the port's multi-rank CPU tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_sharded_train.py``,
``tests/test_torch_sharded_serving.py``, ``tests/test_torch_sharded_ssm.py``),
run by ``repro_torch.distributed.spawn.run_ranks`` on 4 gloo ranks. This
module imports no JAX: every spawned rank imports it. Inputs come in as
numpy (JAX-initialised params, seeded data), results go back as numpy."""
from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _cfg(arch, **over):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               **over)


# -- the MoE layer, expert-parallel ------------------------------------------

def moe_ep(rank, world, arch, params, x, factors):
    """The port's expert-parallel ``moe_apply`` on a (data 2, model 2) mesh
    at each capacity factor of ``factors``: (y, aux) full on rank 0, and
    the gradients of sum(y * w) + aux w.r.t. x and every param at the first
    factor."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import Parallelism, ShardingPolicy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    cfg = _cfg(arch)
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    par = Parallelism(("data",), ("data",), "model")
    policy = ShardingPolicy(cfg, mesh, par)
    p = policy.distribute_tree(
        {k: torch.from_numpy(v) for k, v in params.items()},
        moe.moe_axes(cfg))
    out = {}
    for i, cf in enumerate(factors):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xd = policy.distribute(torch.from_numpy(x), ("batch", "seq", "act"))
        xd = xd.detach().requires_grad_()
        y, aux = moe.moe_apply(leaves, cfg, xd, mesh, par,
                               capacity_factor=cf)
        out[cf] = {"y": _np(y), "aux": _np(aux)}
        if i == 0:
            w = policy.distribute(torch.from_numpy(
                np.random.default_rng(7).standard_normal(x.shape,
                                                         np.float32)),
                ("batch", "seq", "act"))
            loss = (y * w).sum() + aux
            names = sorted(leaves)
            grads = torch.autograd.grad(loss, [xd] + [leaves[k]
                                                      for k in names])
            out[cf]["grads"] = {k: _np(g) for k, g in
                                zip(["x"] + names, grads)}
        assert isinstance(y, DTensor)
    return out if rank == 0 else None


# -- compressed reduction, pipeline, resharding restore ----------------------

def collectives_pipeline_reshard(rank, world, g, ws, x, n_stages,
                                 layers_per_stage):
    """JAX's tests of ``tests/test_distributed_subprocess.py`` at 4 ranks:
    ``compressed_pod_psum`` on a (pod 2, data 2) mesh, ``pipeline_forward``
    with 2 stages on ``pod`` of a (pod 2, model 2) mesh, a checkpoint saved
    from a (data 2, model 2) mesh and restored onto (data 4, model 1)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.distributed.collectives import compressed_pod_psum
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import distribute_full
    from repro_torch.launch.mesh import make_test_mesh
    out = {}
    mesh = make_test_mesh((2, 2), ("pod", "data"), device_type="cpu")
    red, resid = compressed_pod_psum({"w": torch.from_numpy(g)}, None, mesh)
    out["psum"] = (red["w"].numpy(), resid["w"].numpy())

    pmesh = make_test_mesh((2, 2), ("pod", "model"), device_type="cpu")
    # the stages' weights sharded on their leading dim over ``pod``
    wsd = distribute_full(torch.from_numpy(ws), pmesh,
                          (Shard(0), Replicate()))

    def body(params, h):
        for i in range(layers_per_stage):
            h = torch.tanh(h @ params[i])
        return h
    out["pipeline"] = pipeline_forward(
        pmesh, "pod", body, wsd, torch.from_numpy(x),
        layers_per_stage=layers_per_stage).numpy()

    mesh_a = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    mesh_b = make_test_mesh((4, 1), ("data", "model"), device_type="cpu")
    w = torch.arange(64.0).reshape(8, 8)
    wa = distribute_full(w, mesh_a, (Shard(0), Shard(1)))
    root = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(root, src=0)
    store = CheckpointStore(root[0])
    store.save({"w": wa}, 0, blocking=True)
    dist.barrier()
    back = store.restore({"w": w}, 0,
                         placements={"w": (mesh_b, (Shard(0), Shard(1)))})
    out["reshard"] = {"full": _np(back["w"]),
                      "local": back["w"].to_local().numpy(),
                      "mesh": dict(zip(back["w"].device_mesh.mesh_dim_names,
                                       back["w"].device_mesh.shape)),
                      "placements": [str(p) for p in back["w"].placements]}
    return out


# -- the sharded train step ---------------------------------------------------

def _pad_heads(tree, cfg, h_pad):
    """A numpy params (or moments) tree with each attention's q heads
    padded to ``h_pad`` by zero wq columns and wo rows (the layout a
    model under an "expand" policy inits)."""
    def pad(x, axis):
        shape = list(x.shape)
        shape[axis] = h_pad - cfg.num_heads
        return np.concatenate([x, np.zeros(shape, x.dtype)], axis=axis)
    out = dict(tree)
    out["blocks"] = [dict(b, attn=dict(b["attn"], wq=pad(b["attn"]["wq"], 2),
                                       wo=pad(b["attn"]["wo"], 1)))
                     for b in tree["blocks"]]
    return out


def sharded_steps(rank, world, runs, batches):
    """For each (arch, config overrides, mesh shape, microbatches, numpy
    train state) of ``runs``: the port's train step under ``make_policy``
    on that mesh of the 4 ranks, one step a batch (the state's q heads
    padded first where the policy pads them). Returns on rank 0 per run
    the policy's mode and h_pad, the metrics a step and the final params
    and first moments in full."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.params import train_state_from_numpy
    from repro_torch.optim.adamw import OptimizerConfig, leaves
    from repro_torch.training import train_step as ts
    out = []
    for arch, over, shape, mb, state in runs:
        cfg = _cfg(arch, **over)
        mesh = make_test_mesh(shape, ("data", "model"), device_type="cpu")
        b, s = batches[0]["inputs"].shape
        policy, par = specs.make_policy(cfg, ShapeConfig("t", s, b, "train"),
                                        mesh)
        model = build_model(cfg, "cpu", mesh, par, policy)
        if policy.h_pad > cfg.num_heads:
            state = {"params": _pad_heads(state["params"], cfg, policy.h_pad),
                     "opt": {k: _pad_heads(v, cfg, policy.h_pad)
                             if k in ("m", "v") else v
                             for k, v in state["opt"].items()}}
        st = ts.distribute_state(model, train_state_from_numpy(state, "cpu"))
        ocfg = OptimizerConfig(warmup_steps=2, total_steps=10)
        step = ts.make_train_step(model, cfg, ocfg,
                                  ts.TrainStepConfig(microbatches=mb))
        metrics = []
        for batch in batches:
            st, m = step(st, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        res = {"mode": policy.mode, "h_pad": policy.h_pad,
               "metrics": metrics,
               "params": [_np(x) for x in leaves(st["params"])],
               "m": [_np(x) for x in leaves(st["opt"]["m"])],
               "placements": [str(x.placements)
                              for x in leaves(st["params"])][:4]}
        out.append(res if rank == 0 else None)
    return out


def adamw_sharded(rank, world):
    """Two AdamW steps on DTensor leaves of a (data 2, model 2) mesh (sharded
    on one mesh axis, on both, replicated) against the same steps on the
    full tensors, for f32, bf16 and int8 moments: the largest difference
    of the grad norm, params and moments (int8: their scales too)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import distribute_full
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adamw
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    rng = np.random.default_rng(3)
    shapes = {"a": ((8, 6), (Shard(0), Shard(1))),
              "b": ((6,), (Replicate(), Replicate())),
              "c": ((4, 8), (Replicate(), Shard(1))),
              "d": ((2, 4, 6), (Shard(2), Shard(1)))}
    params = {k: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
              for k, (sh, _) in shapes.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for k, (sh, _) in shapes.items()} for _ in range(2)]
    place = lambda tree: {k: distribute_full(v, mesh, shapes[k][1])
                          for k, v in tree.items()}
    out = {}
    for moments in ("float32", "bfloat16", "int8"):
        cfg = adamw.OptimizerConfig(warmup_steps=1, moment_dtype=moments,
                                    clip_norm=1.0)
        full = {k: v.clone() for k, v in params.items()}
        full_opt = adamw.init(full, cfg)
        sh = place(params)
        sh_opt = adamw.init(sh, cfg)
        diffs = []
        for g in grads:
            _, _, fs = adamw.update(g, full_opt, full, cfg)
            _, _, ss = adamw.update(place(g), sh_opt, sh, cfg)
            diffs.append(abs(float(fs["grad_norm"]) - float(ss["grad_norm"])))
        for k in shapes:
            diffs.append(float((_np_t(sh[k]) - full[k]).abs().max()))
            for m in ("m", "v"):
                diffs.append(float((_np_t(sh_opt[m][k]).float()
                                    - full_opt[m][k].float()).abs().max()))
                if moments == "int8":
                    diffs.append(abs(float(sh_opt[f"{m}_scale"][k])
                                     - float(full_opt[f"{m}_scale"][k])))
        out[moments] = max(diffs)
    return out


def _np_t(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def distributed_cases(rank, world, ep_args, pp_args):
    """``moe_ep``, ``collectives_pipeline_reshard`` and ``adamw_sharded``
    in one process group: (rank 0's EP results, this rank's other
    results, its AdamW differences)."""
    return (moe_ep(rank, world, *ep_args),
            collectives_pipeline_reshard(rank, world, *pp_args),
            adamw_sharded(rank, world))


def fail_on_rank_one(rank, world):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def gloo_cuda_collectives(rank, world):
    """Every collective the sharded path issues, on CUDA tensors of two
    ranks sharing the card over gloo: the port's helpers and DTensor's
    redistributes (both staged through the host). Returns on each rank
    {case: (result on the card, the expected value's, staged by op)}."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    import torch.distributed as dist
    from repro_torch.distributed import comm
    group = dist.group.WORLD
    x = torch.arange(24.0, device="cuda").reshape(4, 6) + 100 * rank
    full = torch.cat([torch.arange(24.0).reshape(4, 6) + 100 * r
                      for r in range(world)])
    total = sum(torch.arange(24.0).reshape(4, 6) + 100 * r
                for r in range(world))
    out = {}

    def case(name, fn, want):
        comm.staged.clear()
        got = fn()
        torch.cuda.synchronize()
        out[name] = (bool(got.is_cuda), bool(torch.equal(got.cpu(), want)),
                     dict(comm.staged))
    case("all_reduce", lambda: comm.all_reduce(x.clone(), group), total)
    case("all_gather", lambda: comm.all_gather(x, group, 0), full)
    case("reduce_scatter", lambda: comm.reduce_scatter(x, group, 0),
         total.chunk(world)[rank])
    case("broadcast", lambda: comm.broadcast(x.clone(), 1, group),
         torch.arange(24.0).reshape(4, 6) + 100)
    case("send_recv", lambda: comm.send_recv(x, (rank + 1) % world,
                                             (rank - 1) % world, group),
         torch.arange(24.0).reshape(4, 6) + 100 * ((rank - 1) % world))
    mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data",
                                                                "model"))

    def redist(src, dst, local):
        return lambda: DTensor.from_local(local, mesh, src).redistribute(
            mesh, dst).to_local()
    rep = Replicate()
    case("dtensor_partial_to_replicate",
         redist([rep, Partial()], [rep, rep], x), total)
    case("dtensor_partial_to_shard",
         redist([rep, Partial()], [rep, Shard(0)], x),
         total.chunk(world)[rank])
    case("dtensor_shard_to_replicate",
         redist([rep, Shard(0)], [rep, rep], x), full)
    case("dtensor_shard0_to_shard1",
         redist([rep, Shard(0)], [rep, Shard(1)], x),
         full.chunk(world, dim=1)[rank])
    return out


# -- prefill and decode under a policy ----------------------------------------

def _full(tree):
    """A tree of DTensors (or tensors) gathered whole, as numpy copies
    (decode goes on writing the caches in place)."""
    from repro_torch.models.params import _map
    return _map(tree, lambda t: _np(t).copy())


def sharded_serve(rank, world, run, refs):
    """One serving run of ``serving_cases``: the port's prefill of
    ``run["tokens"]`` (B, S) to ``max_seq`` under a prefill-kind policy on
    a (data, model) mesh of ``run["mesh"]``, the caches placed for a
    decode-kind policy's model (``constrain_tree`` into its
    ``cache_axes()``), then one decode step for each token column of
    ``run["feed"]`` (B, T) at positions S + t (the last step's row 0 at
    ``max_seq``, past the end, where it writes nothing). The same steps
    unsharded, from the same numpy params, on rank 0 only, once for each
    ``run["ref_key"]`` (kept in ``refs``); and decode from the decode
    model's ``init_cache`` for two steps. Returns on rank 0 every logits
    tensor and the caches after prefill and after the last step, both runs,
    the modes, and the caches' placements against their specs."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.params import params_from_numpy
    cfg = _cfg(run["arch"], **run.get("over", {}))
    mesh = make_test_mesh(run["mesh"], ("data", "model"), device_type="cpu")
    toks = torch.from_numpy(run["tokens"])
    feed = torch.from_numpy(run["feed"])
    b, s = toks.shape
    max_seq = run["max_seq"]
    params = params_from_numpy(run["params"], "cpu")
    pos = [torch.full((b,), s + t) for t in range(feed.shape[1])]
    pos[-1][0] = max_seq

    def serve(pm, dm, pp, dp, place):
        out = {}
        with torch.no_grad():
            lg, c = pm.prefill(pp, toks, max_seq)
            out["prefill"] = _np(lg)
            c = place(c)
            out["prefill_caches"] = _full(c)
            steps = []
            for t in range(feed.shape[1]):
                lg, c = dm.decode(dp, c, feed[:, t:t + 1], pos[t])
                steps.append(_np(lg))
            out["decode"] = steps
            out["decode_caches"] = _full(c)
            c0 = dm.init_cache(b, max_seq)
            fresh = []
            for t in range(2):
                lg, c0 = dm.decode(dp, c0, toks[:, t:t + 1],
                                   torch.full((b,), t))
                fresh.append(_np(lg))
            out["from_init"] = fresh
        return out

    if rank == 0 and run["ref_key"] not in refs:
        plain = build_model(cfg, "cpu")
        refs[run["ref_key"]] = serve(plain, plain, params, params,
                                     lambda c: c)
    shape_p = ShapeConfig("p", s, b, "prefill")
    shape_d = ShapeConfig("d", max_seq, b, "decode")
    pol_p, par = specs.make_policy(cfg, shape_p, mesh)
    pol_d, _ = specs.make_policy(cfg, shape_d, mesh)
    mp = build_model(cfg, "cpu", mesh, par, pol_p)
    md = build_model(cfg, "cpu", mesh, par, pol_d)
    with _kernel_shapes() as shapes:
        got = serve(mp, md, mp.distribute(params), md.distribute(params),
                    lambda c: pol_d.constrain_tree(c, md.cache_axes()))
    got["kernel_shapes"] = shapes
    # each kind's model on the other kind's step: the decode-kind model
    # prefills ("head_dim": q, k, v gathered for flash), the prefill-kind
    # model decodes its own caches ("expand": the sequence-sharded cache
    # gathered)
    with torch.no_grad():
        lg, _ = md.prefill(md.distribute(params), toks, max_seq)
        _, c = mp.prefill(mp.distribute(params), toks, max_seq)
        lg1, _ = mp.decode(mp.distribute(params), c, feed[:, :1], pos[0])
    got["cross"] = [_np(lg), _np(lg1)]
    # the decode model's caches sit in abstract_cache's specs
    caches = md.init_cache(b, max_seq)
    _, _, want_specs = specs.abstract_cache(md, pol_d, b, max_seq)
    pairs = list(zip(_leaves(caches), _leaves(want_specs)))
    got["placed"] = bool(pairs) and all(
        isinstance(t, DTensor) and tuple(t.placements) == pol_d.placements(sp)
        for t, sp in pairs)
    got["modes"] = (pol_p.mode, pol_d.mode, pol_p.h_pad)
    return {"port": refs[run["ref_key"]], "sharded": got} if rank == 0 \
        else None


class _kernel_shapes:
    """Records the shapes the flash and SSD ops see (the names the models
    call), as {op: sorted shapes}, while in the block."""
    def __enter__(self):
        from repro_torch.models import layers, mamba2
        self.mods, self.seen = (layers, mamba2), {"flash": set(),
                                                  "ssd": set()}
        self.fa, self.ssd = layers.flash_attention, mamba2.ssd_chunked

        def fa(q, k, v, **kw):
            self.seen["flash"].add((tuple(q.shape), tuple(k.shape)))
            return self.fa(q, k, v, **kw)

        def ssd(x, dt, A, B, C, chunk):
            self.seen["ssd"].add((tuple(x.shape), tuple(B.shape)))
            return self.ssd(x, dt, A, B, C, chunk)
        layers.flash_attention, mamba2.ssd_chunked = fa, ssd
        return self.seen

    def __exit__(self, *exc):
        layers, mamba2 = self.mods
        layers.flash_attention, mamba2.ssd_chunked = self.fa, self.ssd
        for k in self.seen:
            self.seen[k] = sorted(self.seen[k])


def _leaves(tree):
    """Leaves of a cache tree (dicts by sorted key, lists, tuples) or of
    its spec tree, whose leaves are specs: tuples of mesh-axis entries."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not all(
            isinstance(e, (str, tuple, type(None))) for e in tree):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def head_dim_units(rank, world):
    """The head-dim-sharded pieces against their unsharded versions, on
    the ``model`` group of a (data 1, model 4) and a (data 2, model 2)
    mesh: ``apply_rope_head_dim`` (largest difference, expected 0: the
    same operations on each block), ``head_dim_norms`` (gemma3's qk norm
    over the whole head dim) and the Mamba2 gated norm on a DTensor whose
    ``d_inner`` is sharded (DTensor's all-reduce of the sum of squares).
    Returns on rank 0 {mesh: {check: largest difference}}."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import distribute_full
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(5)
    b, s, h, kv, hd = 2, 5, 4, 2, 16
    q, k = (torch.randn(b, s, n, hd, generator=g) for n in (h, kv))
    qn, kn = (torch.randn(hd, generator=g) * 0.1 for _ in range(2))
    positions = torch.arange(3, 3 + s)[None]
    x = torch.randn(b, s, 32, generator=g)
    w = torch.randn(32, generator=g) * 0.1
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = make_test_mesh(shape, ("data", "model"), device_type="cpu")
        group = comm.axis_group(mesh, "model")
        tp, r = comm.group_size(group), comm.group_rank(group)

        def block(t):
            return t.chunk(tp, dim=-1)[r]
        rq, rk = L.apply_rope_head_dim(block(q), block(k), positions, 1e4,
                                       group, hd)
        want_q = L.apply_rope(q, positions, 1e4)
        want_k = L.apply_rope(k, positions, 1e4)
        nq, nk = L.head_dim_norms(block(q), block(k), block(qn), block(kn),
                                  1e-6, group, hd)
        diffs = {
            "rope": max(float((a - block(c)).abs().max()) for a, c in
                        ((rq, want_q), (rk, want_k))),
            "qk_norm": max(float((a - block(L.rms_norm(c, wn, 1e-6)))
                                 .abs().max())
                           for a, c, wn in ((nq, q, qn), (nk, k, kn))),
        }
        xd = distribute_full(x, mesh, (Replicate(), Shard(2)))
        wd = distribute_full(w, mesh, (Replicate(), Shard(0)))
        diffs["gated_norm"] = float((L.rms_norm(xd, wd).full_tensor()
                                     - L.rms_norm(x, w)).abs().max())
        out[shape] = diffs
    return out if rank == 0 else None


def serving_cases(rank, world, runs):
    """``sharded_serve`` for each run of ``runs`` and ``head_dim_units``,
    in one process group: (rank 0's run results, rank 0's unit checks)."""
    refs = {}
    return ([sharded_serve(rank, world, run, refs) for run in runs],
            head_dim_units(rank, world))
