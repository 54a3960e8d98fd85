"""Mixture-of-Experts layer, ported from the JAX package's
``repro.models.moe``.

GShard-style capacity: the router picks top-k experts per token; every
expert gets a fixed-capacity buffer filled in token-major order (overflow is
dropped); the expert FFN is three grouped matmuls over those buffers (the
CUDA kernel on the card); the outputs scatter back weighted by the gates.
``moe_apply_ref`` is the dense dropless oracle of the tests.

Expert parallelism (JAX's ``shard_map`` branch of ``moe_apply``): on a mesh
whose ``model`` axis has tp > 1 ranks dividing the experts, the tokens stay
batch-sharded and replicated over ``model``, each ``model`` rank owns E / tp
experts, its experts' weights are all-gathered over the FSDP axes, the
router runs on every rank, each rank fills and runs its own experts'
buffers (capacity from its local tokens) on the grouped-matmul kernel, and
one all-reduce over ``model`` sums the outputs; the load-balance term is
averaged over the batch axes. The kernels see the local tensors only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import axis_size
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models.layers import (dense_init, mlp_apply, mlp_axes,
                                       mlp_init)


def moe_init(gen, cfg, dtype, stack: int):
    """One MoE layer's params, stacked on a leading ``stack`` axis. The
    router stays f32 in any model dtype, as in the JAX package."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, stack=stack),
        "wi": dense_init(gen, (e, d, f), dtype, stack=stack),
        "wg": dense_init(gen, (e, d, f), dtype, stack=stack),
        "wo": dense_init(gen, (e, f, d), dtype, scale=1.0 / math.sqrt(f),
                         stack=stack),
    }
    if m.shared_expert_d_ff:
        p["shared"] = mlp_init(gen, d, m.shared_expert_d_ff, dtype, stack)
    return p


def moe_axes(cfg) -> dict:
    """Logical axes of ``moe_init``'s params (unstacked), as JAX's."""
    ax = {"router": ("embed", "experts"),
          "wi": ("experts", "embed", "expert_mlp"),
          "wg": ("experts", "embed", "expert_mlp"),
          "wo": ("experts", "expert_mlp", "embed")}
    if cfg.moe.shared_expert_d_ff:
        ax["shared"] = mlp_axes()
    return ax


def _route(router_w, x_flat, top_k: int):
    """x_flat: (T, d). Returns top-k gates (renormalised), expert ids in
    descending gate order, and the Switch load-balance aux term."""
    logits = x_flat.float() @ router_w
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    topk_w, topk_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    e = router_w.shape[1]
    assign = F.one_hot(topk_idx, e).float().sum(1)             # (T, E)
    f_e = assign.mean(0) / top_k
    p_e = probs.mean(0)
    aux = e * torch.sum(f_e * p_e)
    return topk_w, topk_idx, aux


def _capacity(tokens: int, top_k: int, num_experts: int, factor: float) -> int:
    return max(1, int(math.ceil(tokens * top_k / num_experts * factor)))


def _expert_buffers(x_flat, topk_w, topk_idx, num_experts: int,
                    capacity: int, first: int = 0, size=None):
    """Fixed-capacity buffers for experts ``first .. first + size - 1``
    (default: every expert).

    Returns (buf_x (E, C, d), buf_w (E, C) f32, buf_tok (E, C) int64, valid
    (E, C) f32), E = ``size``. Assignment j (token-major, then slot k) for
    expert e lands
    in slot ``rank_j``, its order among e's assignments, if rank_j < C; the
    rest go to a spill row that is dropped. The JAX package loops over
    experts with one cumsum each; here a stable sort by expert gives every
    rank at once (its place in the sort less its expert's first place),
    with the same result: a cumsum along the (T*k) axis of a (T*k, E)
    one-hot is one serial scan per expert on the card. The slots take their
    token's row by a scatter, not a gather from ``buf_tok``: the gather's
    gradient would sum every empty slot's zero into token 0 one row at a
    time."""
    t, k = topk_idx.shape
    a = topk_idx.reshape(-1)                                   # (T*k,)
    tok = torch.arange(t, device=a.device).repeat_interleave(k)
    order = torch.argsort(a, stable=True)
    count = torch.zeros(num_experts, dtype=torch.long,
                        device=a.device).scatter_add_(0, a, torch.ones_like(a))
    start = torch.cumsum(count, 0) - count
    rank = torch.empty_like(a)
    rank[order] = torch.arange(a.numel(), device=a.device) - start[a[order]]
    size = num_experts if size is None else size
    keep = rank < capacity
    if first or size < num_experts:
        keep &= (a >= first) & (a < first + size)
    n = size * capacity
    slot = torch.where(keep, (a - first) * capacity + rank, n)  # spill: row n

    def scatter(values, dtype):
        buf = torch.zeros(n + 1, dtype=dtype, device=a.device)
        return buf.scatter_(0, slot, values.to(dtype))[:n].view(
            size, capacity)
    buf_w = scatter(torch.where(keep, topk_w.reshape(-1).float(), 0.0),
                    torch.float32)
    buf_tok = scatter(torch.where(keep, tok, 0), torch.long)
    valid = scatter(keep, torch.float32)
    d = x_flat.shape[1]
    rows = x_flat[:, None].expand(t, k, d).reshape(t * k, d)   # row j: tok_j
    buf_x = x_flat.new_zeros((n + 1, d)).index_put((slot,), rows)[:n].view(
        size, capacity, d)
    return buf_x, buf_w, buf_tok, valid


def _expert_ffn(wi, wg, wo, buf_x):
    """Gated expert FFN over (E, C, d) buffers: three grouped matmuls."""
    h = F.silu(grouped_matmul(buf_x, wg)) * grouped_matmul(buf_x, wi)
    return grouped_matmul(h, wo)


def _maybe_shared(params, x, y):
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x)
    return y


def _moe_local(params, cfg, x, cf):
    """Single-rank capacity MoE (the EP path's math, no collectives)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    topk_w, topk_idx, aux = _route(params["router"], xf, m.top_k)
    cap = _capacity(b * s, m.top_k, m.num_experts, cf)
    buf_x, buf_w, buf_tok, valid = _expert_buffers(
        xf, topk_w, topk_idx, m.num_experts, cap)
    h = _expert_ffn(params["wi"], params["wg"], params["wo"], buf_x)
    gate = (buf_w * valid).to(h.dtype)[..., None]
    # a scatter-add into the model dtype, as JAX's .at[].add; on the card
    # index_add_ sums a token's k contributions with atomics, in no fixed
    # order
    y = torch.zeros_like(xf).index_add_(0, buf_tok.reshape(-1),
                                        (h * gate).reshape(-1, d))
    return y.reshape(b, s, d), aux


def moe_apply(params, cfg, x, mesh=None, parallel=None,
              capacity_factor=None):
    """x: (B, S, d). Returns (y, aux_loss). With no mesh, or a ``model``
    axis of one rank or one that does not divide the experts, the
    single-rank path (JAX's ``_moe_local``; on a mesh, over the whole
    batch on every rank, as GSPMD computes JAX's); else expert-parallel
    (``x`` and the params DTensors on ``mesh``). The shared expert, where
    the config has one, is added after either."""
    cf = capacity_factor if capacity_factor is not None else \
        cfg.moe.capacity_factor
    tp_axis = parallel.tp_axis if parallel is not None else None
    tp = axis_size(mesh, tp_axis) if (tp_axis and mesh is not None) else 1
    if tp > 1 and cfg.moe.num_experts % tp == 0:
        y, aux = _moe_expert_parallel(params, cfg, x, mesh, parallel, cf)
    elif mesh is not None:
        y, aux = _moe_replicated(params, cfg, x, mesh, cf)
    else:
        y, aux = _moe_local(params, cfg, x, cf)
    return _maybe_shared(params, x, y), aux


def _moe_replicated(params, cfg, x, mesh, cf):
    """The single-rank path on a mesh: x and the expert params gathered
    whole on every rank (their gradients the same on every rank), the
    output handed back in x's placements."""
    full = {k: params[k].full_tensor() for k in ("router", "wi", "wg", "wo")}
    y, aux = _moe_local(full, cfg, x.full_tensor(), cf)
    rep = [Replicate()] * mesh.ndim
    y = DTensor.from_local(y, mesh, rep).redistribute(mesh, x.placements)
    return y, DTensor.from_local(aux, mesh, rep)


def _moe_expert_parallel(params, cfg, x, mesh, parallel, cf):
    """JAX's ``shard_map`` body on this rank's local tensors: x (B_loc, S,
    d) batch-sharded, the same on every ``model`` rank; the rank's E / tp
    experts (``first = rank * e_loc``), whose weights are all-gathered over
    the FSDP axes; the router gathered whole. The tokens and gates that
    enter the rank's expert buffers get their gradient summed over
    ``model`` (each rank routes to its own experts); the router's and
    everything before it are the same on every ``model`` rank."""
    m = cfg.moe
    names = list(mesh.mesh_dim_names)
    tp_axis = parallel.tp_axis
    tp_group = comm.axis_group(mesh, tp_axis)
    e_loc = m.num_experts // comm.group_size(tp_group)
    first = comm.group_rank(tp_group) * e_loc
    bplace = [Shard(0) if n in parallel.batch_axes else Replicate()
              for n in names]
    x = x.redistribute(mesh, bplace)
    x_loc = x.to_local()
    bl, sl, d = x_loc.shape
    xf = x_loc.reshape(bl * sl, d)
    # the router whole: its gradient summed over the batch axes and the
    # same on every model rank, which keeps its own columns
    router = comm.local_whole(params["router"], parallel)
    rp = params["router"].placements[names.index(tp_axis)]
    if rp.is_shard():
        router = comm.gather_same(router, tp_group, rp.dim)
    topk_w, topk_idx, aux = _route(router, xf, m.top_k)
    cap = _capacity(bl * sl, m.top_k, m.num_experts, cf)
    buf_x, buf_w, buf_tok, valid = _expert_buffers(
        comm.enter(xf, tp_group), comm.enter(topk_w, tp_group), topk_idx,
        m.num_experts, cap, first=first, size=e_loc)
    wi, wg, wo = (comm.local_whole(params[k], parallel).contiguous()
                  for k in ("wi", "wg", "wo"))
    h = _expert_ffn(wi, wg, wo, buf_x.contiguous())
    gate = (buf_w * valid).to(h.dtype)[..., None]
    y = torch.zeros_like(xf).index_add_(0, buf_tok.reshape(-1),
                                        (h * gate).reshape(-1, d))
    y = comm.sum_over(y, tp_group)
    for name in parallel.batch_axes:
        aux = comm.mean_over(aux, comm.axis_group(mesh, name))
    y = DTensor.from_local(y.reshape(bl, sl, d), mesh, bplace,
                           shape=x.shape, stride=x.stride())
    return y, DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim)


def moe_apply_ref(params, cfg, x):
    """Dense dropless oracle: y = sum_k w_k * ffn_{idx_k}(x). O(T*E*d*f)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    topk_w, topk_idx, aux = _route(params["router"], xf, m.top_k)
    y = torch.zeros_like(xf)
    for e in range(m.num_experts):
        h = F.silu(xf @ params["wg"][e]) * (xf @ params["wi"][e])
        fe = h @ params["wo"][e]
        w_e = torch.where(topk_idx == e, topk_w, 0.0).sum(-1)    # (T,)
        y = y + fe * w_e[:, None].to(fe.dtype)
    return _maybe_shared(params, x, y.reshape(b, s, d)), aux
