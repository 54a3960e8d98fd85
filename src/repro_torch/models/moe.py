"""Mixture-of-Experts layer, ported from the JAX package's
``repro.models.moe`` (its single-rank path, which serving takes).

GShard-style capacity: the router picks top-k experts per token; every
expert gets a fixed-capacity buffer filled in token-major order (overflow is
dropped); the expert FFN is three grouped matmuls over those buffers (the
CUDA kernel on the card); the outputs scatter back weighted by the gates.
``moe_apply_ref`` is the dense dropless oracle of the tests.

Not ported yet: the expert-parallel path (JAX ``moe_apply`` over a mesh with
a ``model`` axis), which comes with the distributed slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init


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
                    capacity: int):
    """Fixed-capacity buffers for every expert.

    Returns (buf_x (E, C, d), buf_w (E, C) f32, buf_tok (E, C) int64, valid
    (E, C) f32). Assignment j (token-major, then slot k) for expert e lands
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
    first = torch.cumsum(count, 0) - count
    rank = torch.empty_like(a)
    rank[order] = torch.arange(a.numel(), device=a.device) - first[a[order]]
    keep = rank < capacity
    n = num_experts * capacity
    slot = torch.where(keep, a * capacity + rank, n)           # spill: row n

    def scatter(values, dtype):
        buf = torch.zeros(n + 1, dtype=dtype, device=a.device)
        return buf.scatter_(0, slot, values.to(dtype))[:n].view(
            num_experts, capacity)
    buf_w = scatter(torch.where(keep, topk_w.reshape(-1).float(), 0.0),
                    torch.float32)
    buf_tok = scatter(torch.where(keep, tok, 0), torch.long)
    valid = scatter(keep, torch.float32)
    d = x_flat.shape[1]
    rows = x_flat[:, None].expand(t, k, d).reshape(t * k, d)   # row j: tok_j
    buf_x = x_flat.new_zeros((n + 1, d)).index_put((slot,), rows)[:n].view(
        num_experts, capacity, d)
    return buf_x, buf_w, buf_tok, valid


def _expert_ffn(wi, wg, wo, buf_x):
    """Gated expert FFN over (E, C, d) buffers: three grouped matmuls."""
    h = F.silu(grouped_matmul(buf_x, wg)) * grouped_matmul(buf_x, wi)
    return grouped_matmul(h, wo)


def _maybe_shared(params, x, y):
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x)
    return y


def moe_apply(params, cfg, x, capacity_factor=None):
    """x: (B, S, d). Returns (y, aux_loss). The JAX package's ``moe_apply``
    with ``mesh=None`` (``_moe_local`` plus the shared expert)."""
    m = cfg.moe
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
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
    return _maybe_shared(params, x, y.reshape(b, s, d)), aux


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
