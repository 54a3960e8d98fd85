"""AdamW with dtype-configurable moments, global-norm clipping and a
warmup + cosine schedule, ported from the JAX package's
``repro.optim.adamw``: plain functions over the params tree (nested dicts
and lists of tensors).

The update math runs in f32; moments are stored in ``moment_dtype``
(``float32``, ``bfloat16``, or ``int8`` with a per-tensor f32 scale);
params with ``ndim < 2`` (norms, biases) take no decay; params are rounded
back to their own dtype after each step, with no f32 master copy (JAX keeps
none). Where JAX builds a new tree, ``update`` writes the new params and
moments into the given tensors in place (JAX's donated buffers), leaf by
leaf and, for f32 and bf16 moments, in chunks of a leaf, so its transient
memory is a few chunks' temporaries however large a stacked leaf is.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" for very large models
    grad_accum_dtype: str = "float32"


# elements a chunk of the f32/bf16 update (a few 256 MB f32 temporaries)
CHUNK = 1 << 26
# elements a chunk of ``global_norm``'s sum of squares (its own constant: a
# norm must not depend on the update's chunking)
NORM_CHUNK = 1 << 26


def leaves(tree) -> list:
    """The tensors of a tree in ``jax.tree_util``'s order: dict keys
    sorted, list items by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-structured
    ``rest``, in a tree of ``tree``'s structure; called in ``leaves``'
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32: linear warmup to
    ``peak_lr``, then a cosine down to ``min_lr_frac`` of it."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _is_int8(cfg) -> bool:
    return cfg.moment_dtype == "int8"


def init(params, cfg: OptimizerConfig) -> dict:
    """Zero moments (and, for int8, zero per-tensor scales) shaped like
    ``params``, on their devices (a DTensor param's moments are DTensors in
    its placements; scales stay plain, the same on every rank), and a step
    count of 0."""
    dev = _local(leaves(params)[0]).device
    count = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(dtype):
        return lambda p: torch.zeros_like(
            p, dtype=dtype, memory_format=torch.contiguous_format)
    if _is_int8(cfg):
        sc = lambda p: torch.zeros((), dtype=torch.float32,
                                   device=_local(p).device)
        return {"m": tree_map(zeros(torch.int8), params),
                "m_scale": tree_map(sc, params),
                "v": tree_map(zeros(torch.int8), params),
                "v_scale": tree_map(sc, params), "count": count}
    mdt = getattr(torch, cfg.moment_dtype)
    return {"m": tree_map(zeros(mdt), params),
            "v": tree_map(zeros(mdt), params), "count": count}


def _local(x):
    """A DTensor's local shard; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _unique_share(x) -> float:
    """1 / the number of ranks that hold a copy of each of DTensor ``x``'s
    elements (the product of its replicated mesh dims' sizes)."""
    mesh = x.device_mesh
    return 1.0 / math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                           if not p.is_shard())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares, JAX's
    ``sum(square(x.astype(f32)))``, a chunk of a leaf at a time (bounded
    temporaries). ``torch.sum`` reduces in a tree on the CPU too, where
    ``linalg.vector_norm``'s running f32 sum loses ~1e-3 of the norm of a
    19M-element leaf. DTensor leaves (a sharded state) sum their local
    shards, each weighted by 1 / its copies (a power of two: exact), and one
    all-reduce over the mesh adds the ranks' sums; the result is a plain
    tensor, the same on every rank."""
    total, mesh = None, None
    for leaf in leaves(tree):
        share = 1.0
        if isinstance(leaf, DTensor):
            mesh, share = leaf.device_mesh, _unique_share(leaf)
            leaf = leaf.to_local()
        for chunk in leaf.contiguous().view(-1).split(NORM_CHUNK):
            sq = torch.sum(torch.square(chunk.to(torch.float32)))
            if share != 1.0:
                sq = sq * share
            total = sq if total is None else total + sq
    if mesh is not None:
        _all_reduce_mesh(total, mesh, torch.distributed.ReduceOp.SUM)
    return torch.sqrt(total)


def _all_reduce_mesh(t, mesh, op):
    """All-reduce ``t`` in place over every rank of ``mesh``: one call when
    the mesh spans the process group, else one a mesh axis."""
    from repro_torch.distributed import comm
    if mesh.size() == torch.distributed.get_world_size():
        comm.all_reduce(t, None if mesh.size() == 1 else
                        torch.distributed.group.WORLD, op)
        return t
    for name in mesh.mesh_dim_names:
        comm.all_reduce(t, comm.axis_group(mesh, name), op)
    return t


def _q8(x, mesh=None):
    """Per-tensor int8: the scale from the largest magnitude over the
    whole tensor (over ``mesh``'s ranks when ``x`` is a local shard)."""
    top = x.abs().max()
    if mesh is not None:
        _all_reduce_mesh(top, mesh, torch.distributed.ReduceOp.MAX)
    scale = torch.clamp(top, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _chunks(*tensors):
    """Matching flat chunks of same-shaped contiguous tensors."""
    flat = [t.view(-1) for t in tensors]
    return zip(*(f.split(CHUNK) for f in flat))


def _adam_step(g, m32, v32, p, cfg, decay: bool, scale, lr, bc1, bc2):
    """The update of one leaf or chunk: the new f32 moments into ``m32``
    and ``v32`` and the new params into ``p``, all in place (``p`` rounded
    to its dtype), in JAX's order of operations. ``decay``: the leaf has
    ndim >= 2."""
    g = g.to(torch.float32) * scale
    m32.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v32.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    step = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
    if cfg.weight_decay and decay:
        step.add_(p.to(torch.float32) * cfg.weight_decay)
    p.copy_(p.to(torch.float32) - lr * step)


def _update_leaf(g, m, v, p, cfg, scale, lr, bc1, bc2):
    """f32 or bf16 moments, chunk by chunk: elementwise, so the same
    result as the whole leaf at once."""
    for gc, mc, vc, pc in _chunks(g.contiguous(), m, v, p):
        m32, v32 = mc.to(torch.float32), vc.to(torch.float32)
        _adam_step(gc, m32, v32, pc, cfg, p.ndim >= 2, scale, lr, bc1, bc2)
        if m32.data_ptr() != mc.data_ptr():      # bf16 moments
            mc.copy_(m32)
            vc.copy_(v32)


def _update_int8(grads, opt_state, params, cfg, scale, lr, bc1, bc2):
    def upd(g, m8, ms, v8, vs, p):
        mesh = p.device_mesh if isinstance(p, DTensor) else None
        g, m8, v8, p = (_local(t) for t in (g, m8, v8, p))
        m32 = m8.to(torch.float32) * ms
        v32 = v8.to(torch.float32) * vs
        _adam_step(g, m32, v32, p, cfg, p.ndim >= 2, scale, lr, bc1,
                   bc2)
        nm8, nms = _q8(m32, mesh)
        nv8, nvs = _q8(v32, mesh)
        m8.copy_(nm8)
        ms.copy_(nms)
        v8.copy_(nv8)
        vs.copy_(nvs)

    tree_map(upd, grads, opt_state["m"], opt_state["m_scale"],
             opt_state["v"], opt_state["v_scale"], params)


@torch.no_grad()
def update(grads, opt_state, params, cfg: OptimizerConfig):
    """One AdamW step: (params, opt_state, {"grad_norm", "lr"}), the first
    two the given trees updated in place. The scalars stay on the params'
    device (no wait for it). DTensor leaves (a sharded state; each grad and
    moment in its param's placements) update their local shards, so each
    moment stays in its param's placements."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = schedule(cfg, count)
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, c)
    bc2 = 1 - torch.pow(cfg.b2, c)
    if _is_int8(cfg):
        _update_int8(grads, opt_state, params, cfg, scale, lr, bc1, bc2)
    else:
        tree_map(lambda g, m, v, p: _update_leaf(
            *(_local(t) for t in (g, m, v, p)), cfg, scale, lr, bc1, bc2),
            grads, opt_state["m"], opt_state["v"], params)
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
