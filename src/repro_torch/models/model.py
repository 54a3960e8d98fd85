"""The port's models, from the JAX package's ``repro.models.model``: the
transformer (``_build_transformer`` and the sub-layer it scans, dense or MoE
FFN, global or sliding-window attention), the pure SSM stack
(``_build_ssm``) and the hybrid (``_build_hybrid``: Mamba2 segments with one
shared attention+MLP block applied after each):

    model = build_model(cfg, device="cuda")
    params = model.init(generator)
    logits, aux = model.forward(params, tokens)          # train mode
    logits, caches = model.prefill(params, tokens, max_seq)
    logits, caches = model.decode(params, caches, tokens, pos)
    logits, caches = model.prefill_chunk(params, caches, tokens, pos0)
    logits, caches = model.decode_verify(params, caches, tokens, pos)
    caches = model.init_cache(batch, max_seq)

Params keep the JAX pytrees and layouts, so ``repro_torch.models.params``
carries JAX-initialised weights across unchanged: the transformer's
``{"embed": {"tok"}, "blocks": [per-sub dict stacked on a leading n_super
axis], "final_norm"}`` and the SSM's ``{"embed", "mamba": {"ln", "mamba":
{...}} stacked on a leading layer axis, "final_norm"}``; the hybrid's
``{"embed", "mamba" (as the SSM's), "shared": one sub's dict with no
leading axis, "final_norm"}``. The transformer's caches are a list (one per
sub) of ``{"k", "v"}`` tensors of shape (n_super, B, L, KV, hd), where L is
``max_seq``, or the window W for a sliding-window sub whose window is
shorter than ``max_seq`` (a rolling cache: position p lives in slot p % W);
the SSM's are ``{"conv": {"x", "B", "C"}, "ssd"}`` stacked on the layer
axis; the hybrid's the pair (the SSM's, ``{"k", "v"}`` stacked on the
shared block's applications). Where JAX returns a new cache, the port
writes the cache in place: decode, ``prefill_chunk`` and ``decode_verify``
update the cache they are given and return it. A write at a position past
a global cache's end is dropped, as JAX's scatter drops out-of-range
updates (never clamped onto a real position): the write index is worked out
on the host from the positions, so pass them as CPU tensors to keep the
host from waiting on the device.

Ported: every config: dense and MoE transformers with global or
sliding-window attention, QKV bias, QK norm, post norms and softcaps
(``yi-9b``, ``qwen2-72b``, ``gemma2-27b``, ``gemma3-12b``,
``granite-moe-1b-a400m``, ``llama4``), pure SSM (``mamba2-370m``) and the
hybrid (``zamba2-1.2b``), served and trained; and the ``embeddings`` input
mode (``musicgen-medium``, ``internvl2-26b``), built, prefilled, decoded
and trained: a stub front end's (B, S, d) float embeddings take the place
of the token ids and enter the stack as they are, cast to the model's
dtype, with no sqrt(d) scale (JAX's ``_embed_inputs``); the tied table
still gives the logits. The serving engine stays token-only, as JAX's.
Training (``forward``) runs each transformer super-block, and each Mamba2
layer, under ``cfg.remat_policy`` (``"full"`` recomputes it in the
backward, ``"minimal"`` saves its matmul outputs, ``"none"`` saves
everything); attention through the flash op's forward and backward
kernels, MoE through the grouped matmul's, Mamba2 through the SSD op's.
The hybrid's shared attention+MLP block runs once after each segment, not
remat'd, as in JAX.
``split_blocks`` gives the per-layer views a train step differentiates.
``model.kernel_ops`` lists the kernel modules the model's path launches.
Under a sharding policy (``build_model``'s docstring) every family trains,
prefills and decodes on DTensors, each kernel on each rank's local shard
(``model.cache_axes()`` names the caches' logical axes).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import is_axes_leaf, local_span
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE

# ---------------------------------------------------------------------------
# Sub-block descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sub:
    window: int          # 0 = global attention
    theta: float
    ffn: str             # "dense" | "moe"


def program(cfg: ModelConfig):
    """Returns (n_super, [Sub, ...]) for attention-family archs."""
    theta_g = cfg.rope_theta_global or cfg.rope_theta
    if cfg.local_global_pattern:
        lp, gp = cfg.local_global_pattern
        subs = [Sub(cfg.sliding_window, cfg.rope_theta, "dense")] * lp + \
               [Sub(0, theta_g, "dense")] * gp
        assert cfg.num_layers % (lp + gp) == 0
        return cfg.num_layers // (lp + gp), subs
    if cfg.family == "moe":
        n = cfg.moe.moe_every_n
        subs = [Sub(0, theta_g, "dense")] * (n - 1) + [Sub(0, theta_g, "moe")]
        assert cfg.num_layers % n == 0
        return cfg.num_layers // n, subs
    return cfg.num_layers, [Sub(0, theta_g, "dense")]


# ---------------------------------------------------------------------------
# Attention/FFN sub-layer
# ---------------------------------------------------------------------------


def sub_init(gen, cfg: ModelConfig, sub: Sub, dtype, n_super: int,
             h_pad: Optional[int] = None):
    """One sub-layer's params, stacked on a leading ``n_super`` axis (none
    when ``n_super`` is 0, as the hybrid's shared block); ``h_pad`` pads
    the q heads (``layers.attn_init``)."""
    p = {"ln1": L.zeros(gen, (cfg.d_model,), dtype, n_super),
         "attn": L.attn_init(gen, cfg, dtype, n_super, h_pad),
         "ln2": L.zeros(gen, (cfg.d_model,), dtype, n_super)}
    if sub.ffn == "dense":
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, n_super)
    else:
        p["moe"] = MOE.moe_init(gen, cfg, dtype, n_super)
    if cfg.post_norm:
        p["post_ln1"] = L.zeros(gen, (cfg.d_model,), dtype, n_super)
        p["post_ln2"] = L.zeros(gen, (cfg.d_model,), dtype, n_super)
    return p


def sub_axes(cfg: ModelConfig, sub: Sub) -> dict:
    """Logical axes of ``sub_init``'s params without the stacked axis, as
    JAX's ``sub_init``."""
    ax = {"ln1": ("norm",), "attn": L.attn_axes(cfg), "ln2": ("norm",)}
    if sub.ffn == "dense":
        ax["mlp"] = L.mlp_axes()
    else:
        ax["moe"] = MOE.moe_axes(cfg)
    if cfg.post_norm:
        ax["post_ln1"] = ("norm",)
        ax["post_ln2"] = ("norm",)
    return ax


def _ones_like_tree(tree):
    return {k: _ones_like_tree(v) if isinstance(v, dict) else 1.0
            for k, v in tree.items()}


def sub_masks(cfg: ModelConfig, sub: Sub, h_pad=None) -> dict:
    """Gradient-mask tree of ``sub_init``'s keys (JAX's ``sub_masks``)."""
    return {**_ones_like_tree(sub_axes(cfg, sub)),
            "attn": L.attn_grad_masks(cfg, h_pad)}


def stack_axes(ax_tree):
    """Each axes leaf with the stacked ``"super"`` axis in front (JAX's
    ``_stack_axes``)."""
    if is_axes_leaf(ax_tree):
        return ("super",) + ax_tree
    return {k: stack_axes(v) for k, v in ax_tree.items()}


def _rolling(sub: Sub, max_seq: int) -> bool:
    return bool(sub.window) and sub.window < max_seq


def _cache_len(sub: Sub, max_seq: int) -> int:
    return sub.window if _rolling(sub, max_seq) else max_seq


def _global_sub_index(subs) -> int:
    """The first global sub, whose cache length is ``max_seq`` (JAX's)."""
    return next((i for i, s in enumerate(subs) if s.window == 0), 0)


def _build_prefill_cache(k, v, cache_len: int):
    """k/v: (B, S, KV, hd) -> cache of length cache_len: zero-padded when
    cache_len >= S, else rolling (the last cache_len positions, position p
    in slot p % cache_len)."""
    s = k.shape[1]
    if cache_len >= s:
        pad = cache_len - s
        return F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad))
    # the tail's first position, s - cache_len, lands in slot s % cache_len
    shift = s % cache_len
    return (torch.roll(k[:, s - cache_len:], shift, 1),
            torch.roll(v[:, s - cache_len:], shift, 1))


def _decode_attn_rolling(cfg, q, k_cache, v_cache, pos, scores_sum=None):
    """Rolling-cache decode attention. Slot s holds absolute position
    pos - ((pos - s) mod W), valid iff >= 0; every valid slot lies inside
    the window."""
    slots = torch.arange(k_cache.shape[1], device=q.device)
    kpos = pos[:, None] - torch.remainder(pos[:, None] - slots[None, :],
                                          k_cache.shape[1])
    return L.masked_attention(cfg, q, k_cache, v_cache, (kpos >= 0)[:, None],
                              scores_sum)


def _write_index(pos0, c: int, cache_len: int, rows=None, device=None,
                 rolling: bool = False):
    """Where a call writes K/V for tokens at positions ``pos0[r] + j``
    (j < c): (cache row, cache slot, call row, call column), on ``device``.
    A global cache takes every position below ``cache_len`` in the slot of
    that number; later positions are dropped, as JAX's scatter drops
    out-of-range updates. A ``rolling`` cache takes every position, in slot
    position % cache_len. ``rows`` (B,) maps call rows to cache rows
    (default: the same row). Worked out on the host from ``pos0`` (a CPU
    tensor costs no wait for the device), then one copy."""
    positions = pos0.cpu()[:, None] + torch.arange(c)
    keep = torch.ones_like(positions, dtype=torch.bool) if rolling \
        else positions < cache_len
    r, j = keep.nonzero(as_tuple=True)
    slots = positions[r, j] % cache_len if rolling else positions[r, j]
    cache_rows = r if rows is None else rows.cpu()[r]
    return tuple(torch.stack([cache_rows, slots, r, j])
                 .to(device).unbind(0))


def sub_apply(p, cfg: ModelConfig, sub: Sub, h, positions, mode: str,
              cache=None, pos=None, max_seq: Optional[int] = None,
              write=None, rows=None, mesh=None, parallel=None, policy=None):
    """One transformer sub-layer. Returns (h, new_cache); in ``train``
    mode (h, aux), aux the MoE layer's load-balance term (0 for a dense
    FFN), differentiable.

    ``prefill``: attention over the whole sequence on the flash op; the new
    cache is this layer's K/V padded to ``max_seq``. ``decode``: one token
    per row at ``pos``; its K/V is written into ``cache`` in place (JAX:
    ``cache.at[arange(b), pos].set(k[:, 0])``) and ``cache`` is returned.
    ``chunk``: C tokens per row at ``positions``; their K/V is written in
    place (JAX: ``cache.at[arange(b)[:, None], positions].set(k)``) and the
    chunk attends over its rows of the cache, ``rows`` of it when given.
    ``write`` is the sub's ``_write_index`` (decode and chunk). A rolling
    sub (window < ``max_seq``, the global caches' length) keeps a cache of
    its window and decodes at slot ``pos % window``. ``train``: the
    prefill's attention with no cache, differentiable (on the card the
    flash op's forward and backward kernels).

    With a ``policy`` (h and p DTensors): in ``train`` mode q, k and v are
    constrained to the policy's heads sharding before attention runs on
    each rank's heads; in ``"expand"`` mode k and v are first expanded to
    one kv head per (padded) q head and take the q heads' sharding (JAX's
    constraints). In ``prefill`` and ``decode`` the attention half runs in
    a local region (``_attn_sharded``; ``cache`` a ``_LocalCache``). The
    MoE FFN runs expert-parallel on ``mesh`` in every mode."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    if policy is not None and mode in ("prefill", "decode"):
        out, new_cache = _attn_sharded(p["attn"], cfg, sub, hn, positions,
                                       mode, cache, pos, max_seq, write,
                                       mesh, parallel)
    else:
        out, new_cache = _attn(p["attn"], cfg, sub, hn, positions, mode,
                               cache, pos, max_seq, write, rows, policy)
    if cfg.post_norm:
        out = L.rms_norm(out, p["post_ln1"], cfg.norm_eps)
    h = h + out
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    aux = None
    if sub.ffn == "dense":
        mo = L.mlp_apply(p["mlp"], hn)
    else:
        mo, aux = MOE.moe_apply(p["moe"], cfg, hn, mesh, parallel)
    if policy is not None:
        mo = policy.constraint(mo, ("batch", "seq", "act"))
    if cfg.post_norm:
        mo = L.rms_norm(mo, p["post_ln2"], cfg.norm_eps)
    if mode == "train":
        return h + mo, (aux if aux is not None else _zero_aux(h))
    return h + mo, new_cache


def _attn(p, cfg, sub, hn, positions, mode, cache, pos, max_seq, write,
          rows, policy):
    """The attention half of ``sub_apply`` on whole tensors, or on
    DTensors in ``train`` mode: (output after ``wo``, new cache)."""
    q, k, v = L.qkv_proj(p, cfg, hn, positions, sub.theta)
    if policy is not None:
        qa = ("batch", "seq", "q_heads", "head_dim")
        q = policy.constraint(q, qa)
        if policy.mode == "expand":
            head_map = L.kv_head_map(cfg.num_heads, cfg.num_kv_heads,
                                     q.shape[2])
            k, v = (policy.constraint(L.expand_kv(t, head_map), qa)
                    for t in (k, v))
        else:
            k, v = (policy.constraint(t, ("batch", "seq", "kv_heads",
                                          "head_dim")) for t in (k, v))
    new_cache = None
    if mode in ("decode", "chunk"):
        crow, cpos, r, j = write
        cache["k"][crow, cpos] = k[r, j]
        cache["v"][crow, cpos] = v[r, j]
        new_cache = cache
        if mode == "decode" and _rolling(sub, max_seq):
            attn = _decode_attn_rolling(cfg, q, cache["k"], cache["v"], pos)
        elif mode == "decode":
            attn = L.decode_attention(cfg, q, cache["k"], cache["v"], pos,
                                      window=sub.window)
        else:
            kc, vc = ((cache["k"], cache["v"]) if rows is None
                      else (cache["k"][rows], cache["v"][rows]))
            attn = L.chunk_attention(cfg, q, kc, vc, positions)
    elif mode == "prefill":
        kc, vc = _build_prefill_cache(k, v, _cache_len(sub, max_seq))
        new_cache = {"k": kc, "v": vc}
        attn = L.attention(cfg, q, k, v, window=sub.window)
    elif mode == "train":
        attn = L.attention(cfg, q, k, v, window=sub.window)
    else:
        raise ValueError(f"mode {mode!r} is not ported (prefill, decode, "
                         f"chunk, train)")
    out = L.out_proj(attn, p["wo"])
    if policy is not None:
        # the heads' partial sums all-reduced here, over ``model``
        out = policy.constraint(out, ("batch", "seq", "act"))
    return out, new_cache


@dataclasses.dataclass
class _LocalCache:
    """One sub-layer's K/V cache in a sharded prefill or decode: this
    rank's parts ``k`` and ``v`` (in decode, views of the stacked local
    tensors, written in place), their DTensor ``placements`` and the
    global ``shape`` (B, L, KV, hd)."""
    k: torch.Tensor
    v: torch.Tensor
    placements: tuple
    shape: tuple


def _attn_sharded(p, cfg, sub, hn, positions, mode, cache, pos, max_seq,
                  write, mesh, parallel):
    """The attention half of a sub-layer in prefill or decode under a
    policy, on each rank's local tensors: (output after ``wo``, a DTensor
    in hn's placements; the new ``_LocalCache`` in prefill, ``cache`` in
    decode). Each weight is this rank's part, gathered whole over the FSDP
    axes (``comm.local_whole``); what the ``model`` (tp) axis shards in
    ``wq`` and ``wk`` sets the mode:

      q and kv heads (``"heads"``): q, k, v, the cache and flash or decode
        attention on this rank's heads; no collective inside.
      q heads only (``"expand"``): k and v whole on every rank, expanded to
        this rank's (padded) q heads for attention; the prefill cache
        (unexpanded, as JAX's) keeps this rank's block of the sequence.
      the head dim (``"head_dim"``): q, k, v and the cache hold this rank's
        block of the head dim. The qk norm's sums of squares take one
        all-reduce (``L.head_dim_norms``), rope one exchange with the rank
        holding the other half (``L.apply_rope_head_dim``), the decode
        scores (B, KV, G, 1, L) one all-reduce before the softcap, mask and
        softmax (JAX's psum); a prefill gathers q, k and v whole for flash
        and keeps its block of the output.

    Then ``wo``'s partial sums over the sharded heads or head dim take one
    all-reduce over ``model``. A cache whose sequence is sharded (the
    ``"expand"`` prefill cache, long-context decode) is all-gathered along
    it for decode attention. Writes go to the rank that holds the row and
    slot; a position past a global cache's end is dropped, as unsharded
    (``_write_index``, worked out on the host). Every collective is one of
    ``comm``'s, counted in ``comm.staged`` when staged through the host."""
    names = list(mesh.mesh_dim_names)
    ti = names.index(parallel.tp_axis) if parallel.tp_axis in names else None
    group = comm.axis_group(mesh, parallel.tp_axis) if ti is not None \
        else None
    tp, rank = comm.group_size(group), comm.group_rank(group)

    def tp_dim(w):
        pl = w.placements[ti] if ti is not None else Replicate()
        return pl.dim if pl.is_shard() and tp > 1 else None
    q_dim, kv_dim = tp_dim(p["wq"]), tp_dim(p["wk"])
    by_heads, by_hd = q_dim == 1, q_dim == 2
    lp = {k: comm.local_whole(w, parallel) for k, w in p.items()}
    x = hn.to_local()
    dev = x.device
    b0, bl = local_span(hn.shape, mesh, hn.placements, 0)
    if mode == "decode":
        pos = pos[b0:b0 + bl].to(dev)
        positions = pos[:, None]
    q, k, v = L.qkv_proj(lp, cfg, x, positions, sub.theta,
                         group if by_hd else None)
    expand = by_heads and kv_dim is None
    if expand:
        hl = q.shape[2]
        head_map = L.kv_head_map(cfg.num_heads, cfg.num_kv_heads,
                                 hl * tp)[rank * hl:(rank + 1) * hl]
    if mode == "prefill":
        kc, vc = _build_prefill_cache(k, v, _cache_len(sub, max_seq))
        kpl = list(hn.placements)
        if kv_dim is not None:
            kpl[ti] = Shard(kv_dim + 1)      # wk (d, KV, hd) -> k (B,S,KV,hd)
        new_cache = _LocalCache(kc, vc, tuple(kpl),
                                (hn.shape[0], kc.shape[1], cfg.num_kv_heads,
                                 cfg.head_dim))
        if expand:
            k, v = L.expand_kv(k, head_map), L.expand_kv(v, head_map)
        if by_hd:
            q, k, v = (comm.all_gather(t, group, 3) for t in (q, k, v))
        attn = L.attention(cfg, q, k, v, window=sub.window)
        if by_hd:
            attn = attn.chunk(tp, dim=3)[rank]
    else:
        new_cache = cache
        s0, sl = local_span(cache.shape, mesh, cache.placements, 1)
        crow, slot, r, j = _local_write(write, b0, bl, s0, sl, dev)
        cache.k[crow, slot] = k[r, j]
        cache.v[crow, slot] = v[r, j]
        kc, vc = cache.k, cache.v
        for i in reversed(range(mesh.ndim)):
            if cache.placements[i].is_shard(1):
                g = mesh.get_group(names[i])
                kc, vc = (comm.all_gather(t, g, 1) for t in (kc, vc))
        if expand:
            kc, vc = (torch.index_select(t, 2, head_map.to(dev))
                      for t in (kc, vc))
        ssum = (lambda s: comm.all_reduce(s, group)) if by_hd else None
        if _rolling(sub, max_seq):
            attn = _decode_attn_rolling(cfg, q, kc, vc, pos, ssum)
        else:
            attn = L.decode_attention(cfg, q, kc, vc, pos, window=sub.window,
                                      scores_sum=ssum)
    out = L.out_proj(attn.contiguous(), lp["wo"])
    if by_heads or by_hd:
        out = comm.all_reduce(out, group)
    return DTensor.from_local(out, mesh, hn.placements, shape=hn.shape,
                              stride=L.contiguous_strides(hn.shape)), \
        new_cache


def _local_write(write, b0: int, bl: int, s0: int, sl: int, device):
    """A ``_write_index`` (host tensors, global rows and slots) cut to the
    cache rows [b0, b0 + bl) and slots [s0, s0 + sl) this rank holds, in
    its local numbering, on ``device``. The call rows are the cache rows
    (decode), so they take the same offset."""
    crow, slot, r, j = write
    keep = (crow >= b0) & (crow < b0 + bl) & (slot >= s0) & (slot < s0 + sl)
    return tuple(torch.stack([crow[keep] - b0, slot[keep] - s0,
                              r[keep] - b0, j[keep]]).to(device).unbind(0))


def init_sub_cache(cfg, sub: Sub, n_super: int, batch: int, max_seq: int,
                   dtype, device, policy=None):
    """A sub's zeroed ``{"k", "v"}`` caches, stacked on ``n_super``; under
    a policy DTensors in its placements for ``SUB_CACHE_AXES`` (each rank
    allocates its own part)."""
    shape = (n_super, batch, _cache_len(sub, max_seq), cfg.num_kv_heads,
             cfg.head_dim)
    if policy is not None and torch.device(device).type != "meta":
        pl = policy.placements_for(shape, stack_axes(SUB_CACHE_AXES))
        return {k: sharding.zeros(shape, dtype, device, policy.mesh, pl)
                for k in ("k", "v")}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# logical axes of a sub's K/V cache without the stacked axis (JAX's
# ``init_sub_cache``)
SUB_CACHE_AXES = ("batch", "seq_kv", "kv_heads", "head_dim")


def _sub_cache_axes():
    ax = stack_axes(SUB_CACHE_AXES)
    return {"k": ax, "v": ax}


def _stack(ts):
    """``torch.stack`` of per-layer tensors; of DTensors in one placement,
    their local tensors stacked and placed on the new leading axis."""
    if not isinstance(ts[0], DTensor):
        return torch.stack(ts)
    t = ts[0]
    shape = (len(ts),) + tuple(t.shape)
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in t.placements]
    return DTensor.from_local(torch.stack([x.to_local() for x in ts]),
                              t.device_mesh, pl, shape=shape,
                              stride=L.contiguous_strides(shape))


def _place_caches(per_layer, policy):
    """A sub's prefill ``_LocalCache``s, one a layer, stacked and placed in
    the policy's cache placements (``SUB_CACHE_AXES``): each rank's parts
    as built, then redistributed, which cuts this rank's block of the
    sequence out of a cache that every ``model`` rank built whole (the
    ``"expand"`` mode; no collective)."""
    c = per_layer[0]
    shape = (len(per_layer),) + tuple(c.shape)
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in c.placements]
    out = {}
    for name in ("k", "v"):
        local = torch.stack([getattr(x, name) for x in per_layer])
        t = DTensor.from_local(local, policy.mesh, pl, shape=shape,
                               stride=L.contiguous_strides(shape))
        out[name] = policy.constraint(t, stack_axes(SUB_CACHE_AXES))
    return out


def _local_caches(stacked):
    """A stacked ``{"k", "v"}`` DTensor cache as ``i -> _LocalCache`` of
    layer i: views of the local tensors, which decode writes in place."""
    k, v = stacked["k"].to_local(), stacked["v"].to_local()
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p
               for p in stacked["k"].placements)
    shape = tuple(stacked["k"].shape[1:])
    return lambda i: _LocalCache(k[i], v[i], pl, shape)


# ---------------------------------------------------------------------------
# Remat policies
# ---------------------------------------------------------------------------


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective checkpointing as JAX's ``dots_with_no_batch_dims_saveable``:
    keep the outputs of matmuls without batch dims, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy_name: str):
    """``fn`` under ``policy_name``: "none" as it is, "minimal" saving its
    matmul outputs, "full" recomputing all of it in the backward."""
    if policy_name == "none":
        return fn
    kw = {}
    if policy_name == "minimal":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    # no random ops run inside: no RNG state to stash
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


# ---------------------------------------------------------------------------
# Model builder
# ---------------------------------------------------------------------------


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree: dict, i: int) -> dict:
    """Super-block ``i`` of a stacked param/cache dict (views, no copies),
    or item ``i`` of a list of per-super-block dicts."""
    if isinstance(tree, list):
        return tree[i]
    return {k: _layer(x, i) if isinstance(x, dict) else x[i]
            for k, x in tree.items()}


def _default_generator(device):
    """Seed 0 on ``device``; on ``meta``, a stand-in that makes meta
    tensors."""
    if device.type == "meta":
        return L.MetaGenerator()
    return torch.Generator(device=device).manual_seed(0)


def _embed_inputs(cfg: ModelConfig, embed_params, inputs):
    """The stack's input: token ids (B, S) looked up in the table and
    scaled by sqrt(d); in the ``embeddings`` input mode the (B, S, d)
    embeddings themselves, on the model's device in its dtype, unscaled
    (JAX: ``inputs.astype(dtype)``)."""
    if cfg.input_mode == "embeddings":
        return inputs.to(device=embed_params["tok"].device,
                         dtype=_dtype(cfg))
    return L.embed_apply(embed_params, inputs, cfg.d_model)


def build_model(cfg: ModelConfig, device=None, mesh=None, parallel=None,
                policy=None):
    """The model for ``cfg`` on ``device`` (default: the current CUDA
    device; raises when there is none): JAX's ``build_model(cfg, mesh,
    parallel, policy)``, every family.

    With a ``policy`` (``repro_torch.launch.specs.make_policy``) on
    ``mesh``, a DeviceMesh of this process group whose device type is
    ``device``'s, and its ``parallel``: ``model.distribute`` places full
    params (the same on every rank) as DTensors, and the model runs on
    them. Every family (dense, sliding-window, MoE, SSM, hybrid) runs
    ``forward`` (train; the sharded train step of
    ``training.train_step``), ``prefill``, ``decode`` and ``init_cache``,
    its caches DTensors in the policy's placements for
    ``model.cache_axes()``. A policy fixes its attention mode for one step
    kind (``"heads"``; ``"expand"`` for train and prefill, q heads padded
    to ``h_pad``; ``"head_dim"`` for decode), so run each step under a
    policy of its own kind, as the JAX dry-run does: a model built under a
    prefill-kind policy prefills, one under a decode-kind policy on the
    same mesh decodes, each with the params distributed by its own
    ``distribute``; caches cross from one to the other by
    ``policy.constrain_tree(caches, model.cache_axes())`` (JAX's input
    shardings). A policy in another kind's mode still computes the same
    function, at the cost of gathers. ``prefill_chunk`` and
    ``decode_verify`` refuse a policy, as no JAX code runs them sharded;
    the serving engine takes unsharded models only, as JAX's."""
    if cfg.family in ("dense", "moe"):
        builder = _build_transformer
    elif cfg.family == "ssm":
        builder = _build_ssm
    elif cfg.family == "hybrid":
        builder = _build_hybrid
    else:
        raise ValueError(cfg.family)
    return builder(cfg, resolve_device(device), mesh, parallel, policy)


def _embed(cfg, embed_params, inputs, policy=None, mesh=None,
           parallel=None):
    """``_embed_inputs``; under a policy the residual stream as a DTensor,
    batch-sharded: token ids through ``_sharded_embed``, embeddings (the
    same on every rank) distributed and cast."""
    if policy is None:
        return _embed_inputs(cfg, embed_params, inputs)
    if cfg.input_mode == "embeddings":
        return policy.distribute(inputs, ("batch", "seq", "act")).to(
            _dtype(cfg))
    return _sharded_embed(cfg, embed_params["tok"], inputs, policy, mesh,
                          parallel)


def _constrain_act(policy, h):
    """h (B, S..., d) in the policy's activation sharding (JAX's
    ``_constrainer``); as it is with no policy."""
    if policy is None:
        return h
    return policy.constraint(h, ("batch",) + ("seq",) * (h.ndim - 2)
                             + ("act",))


def _logits(cfg, embed_params, h, policy=None):
    """The tied unembedding; under a policy the logits vocab-sharded."""
    logits = L.unembed_apply(embed_params, cfg, h)
    if policy is not None:
        logits = policy.constraint(logits, ("batch", "seq", "vocab"))
    return logits


def _sharded_embed(cfg, tok, inputs, policy, mesh, parallel):
    """The token lookup on a vocab-sharded table (DTensors): each rank looks
    up the ids in its own rows of the table (gathered over the FSDP axes),
    zeroes the rest, and the ranks of ``model`` sum the rows; scaled by
    sqrt(d) in the table's dtype. Returns the (B, S, d) activations,
    batch-sharded."""
    ids = policy.distribute(inputs, ("batch", "seq"))
    table = comm.local_whole(tok, parallel)
    ids_loc = ids.to_local()
    tp_axis = parallel.tp_axis
    vp = tok.placements[list(mesh.mesh_dim_names).index(tp_axis)] \
        if tp_axis else None
    if vp is not None and vp.is_shard():
        group = comm.axis_group(mesh, tp_axis)
        v0 = comm.group_rank(group) * table.shape[0]
        local = ids_loc.long() - v0
        hit = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)] * \
            hit[..., None].to(table.dtype)
        rows = comm.sum_over(rows, group)
    else:
        rows = table[ids_loc.long()]
    rows = rows * torch.tensor(math.sqrt(cfg.d_model), dtype=table.dtype)
    shape = (*ids.shape, cfg.d_model)
    return DTensor.from_local(
        rows, mesh, policy.placements_for(shape, ("batch", "seq", "act")),
        shape=shape, stride=L.contiguous_strides(shape))


def _build_transformer(cfg: ModelConfig, device: torch.device, mesh=None,
                       parallel=None, policy=None):
    n_super, subs = program(cfg)
    dtype = _dtype(cfg)
    expand = policy is not None and policy.mode == "expand"
    h_pad = policy.h_pad if expand else None

    def init(gen: Optional[torch.Generator] = None):
        """Random params with the JAX package's distributions, drawn from
        ``gen`` (default: seed 0 on the model's device); full tensors, with
        the q heads padded to the policy's ``h_pad`` in ``"expand"``
        mode."""
        if gen is None:
            gen = _default_generator(device)
        return {"embed": L.embed_init(gen, cfg, dtype),
                "blocks": [sub_init(gen, cfg, sub, dtype, n_super, h_pad)
                           for sub in subs],
                "final_norm": L.zeros(gen, (cfg.d_model,), dtype)}

    def axes():
        """The params' logical axes, leaf for leaf (JAX's ``init``'s)."""
        return {"embed": L.embed_axes(),
                "blocks": [stack_axes(sub_axes(cfg, sub)) for sub in subs],
                "final_norm": ("norm",)}

    def grad_masks(params):
        """None, or in ``"expand"`` mode with padded q heads the mask tree
        that zeroes their gradients (JAX's ``grad_masks``)."""
        if not expand or h_pad == cfg.num_heads:
            return None
        return {"embed": {"tok": 1.0},
                "blocks": [sub_masks(cfg, sub, h_pad) for sub in subs],
                "final_norm": 1.0}

    def _constrain_h(h):
        return _constrain_act(policy, h)

    def _run(params, h, positions, mode, caches=None, pos=None,
             max_seq=None, writes=None, rows=None):
        new_caches = [[] for _ in subs]
        if policy is not None and caches is not None:
            caches = [_local_caches(c) for c in caches]
        for i in range(n_super):
            for j, sub in enumerate(subs):
                cs = None
                if caches is not None:
                    cs = caches[j](i) if policy is not None else \
                        _layer(caches[j], i)
                h, nc = sub_apply(_layer(params["blocks"][j], i), cfg, sub, h,
                                  positions, mode, cache=cs, pos=pos,
                                  max_seq=max_seq,
                                  write=None if writes is None else writes[j],
                                  rows=rows, mesh=mesh, parallel=parallel,
                                  policy=policy)
                new_caches[j].append(nc)
            h = _constrain_h(h)
        return L.rms_norm(h, params["final_norm"], cfg.norm_eps), new_caches

    def split_blocks(params):
        """``params`` with each stacked block dict split into a list of its
        ``n_super`` super-blocks (views of the stacked tensors, no copies):
        ``forward`` takes either form, and a train step differentiates the
        split form's leaves, so each super-block's gradient is its own
        tensor rather than a scatter into the whole stack."""
        return {**params, "blocks": [[_layer(bp, i) for i in range(n_super)]
                                     for bp in params["blocks"]]}

    def _train_block(block_params, h, aux, positions):
        for sub, bp in zip(subs, block_params):
            h, a = sub_apply(bp, cfg, sub, h, positions, "train", mesh=mesh,
                             parallel=parallel, policy=policy)
            aux = aux + a
        return _constrain_h(h), aux

    def forward(params, inputs):
        """Train mode. inputs: (B, S) token ids, or (B, S, d) embeddings,
        at positions 0..S-1. Returns (logits (B, S, padded vocab) f32,
        aux): aux the summed MoE load-balance terms (f32 scalar; 0 for a
        dense model), both differentiable. Each super-block runs under
        ``cfg.remat_policy``. ``params`` may be stacked or
        ``split_blocks``'s form.

        Under a policy, params are DTensors (``distribute``) and the full
        inputs (the same on every rank) are batch-sharded here; the
        residual stream is constrained after the embedding and each
        super-block, the logits (vocab-sharded) at the end, as JAX's
        ``_constrainer``; logits and aux come back as DTensors."""
        h = _constrain_h(_embed(cfg, params["embed"], inputs, policy, mesh,
                                parallel))
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        aux = _zero_aux(h)
        block = _remat(_train_block, cfg.remat_policy)
        for i in range(n_super):
            h, aux = block([_layer(bp, i) for bp in params["blocks"]], h, aux,
                           positions)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return _logits(cfg, params["embed"], h, policy), aux

    def _writes(caches, pos0, c: int, rows=None, device=None):
        """(max_seq, each sub's ``_write_index``): one index for the global
        caches, one for the rolling caches of each window length."""
        max_seq = caches[_global_sub_index(subs)]["k"].shape[2]
        index, out = {}, []
        for sub, cache in zip(subs, caches):
            key = (cache["k"].shape[2], _rolling(sub, max_seq))
            if key not in index:
                index[key] = _write_index(pos0, c, key[0], rows, device,
                                          rolling=key[1])
            out.append(index[key])
        return max_seq, out

    def prefill(params, inputs, max_seq: int):
        """inputs: (B, S) token ids or (B, S, d) embeddings. Returns
        (logits of the last position, caches of length ``max_seq``, or of
        the window where rolling). Under a policy the logits and caches
        are DTensors, the caches in the policy's placements for
        ``cache_axes()``."""
        _check_prompt(inputs, max_seq)
        h = _constrain_h(_embed(cfg, params["embed"], inputs, policy, mesh,
                                parallel))
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        h, per_layer = _run(params, h, positions, "prefill", max_seq=max_seq)
        if policy is not None:
            caches = [_place_caches(cs, policy) for cs in per_layer]
        else:
            caches = [{"k": torch.stack([c["k"] for c in cs]),
                       "v": torch.stack([c["v"] for c in cs])}
                      for cs in per_layer]
        return _logits(cfg, params["embed"], h[:, -1:], policy), caches

    def decode(params, caches, inputs, pos):
        """inputs: (B, 1) token ids or (B, 1, d) embeddings at positions
        ``pos`` (B,). Writes their K/V into ``caches`` in place (a row past
        the end writes nothing and attends over the whole cache, as in
        JAX); returns (logits, caches). Under a policy ``caches`` are
        DTensors (``init_cache``, ``prefill`` or placed for this policy's
        ``cache_axes()``) and each rank writes its own parts."""
        h = _constrain_h(_embed(cfg, params["embed"], inputs, policy, mesh,
                                parallel))
        if policy is not None:
            # host indices: each rank keeps the writes to its own parts
            max_seq, writes = _writes(caches, pos, 1)
        else:
            max_seq, writes = _writes(caches, pos, 1, device=h.device)
            pos = pos.to(h.device)
        h, _ = _run(params, h, None if policy is not None else pos[:, None],
                    "decode", caches=caches, pos=pos, max_seq=max_seq,
                    writes=writes)
        return _logits(cfg, params["embed"], h, policy), caches

    def prefill_chunk(params, caches, inputs, pos0, rows=None,
                      logits: bool = True):
        """Chunk-wise prefill: run ``inputs`` (B, C) token ids or (B, C, d)
        embeddings, one chunk of a longer prompt starting at absolute
        positions ``pos0`` (B,), against the full-length ``caches``,
        writing the chunk's K/V in place at (cache row, position);
        positions past the end are dropped. ``rows`` (B,) names the cache
        row of each input row (default: row b is cache row b), so an engine
        runs a few slots' chunks on its own cache with no copy of it.
        Earlier chunks (and any prefix-cache restore) must already occupy
        positions [0, pos0). Exact only for all-global (padding-safe)
        models; the serving engine gates on that, and a rolling cache
        raises ``ValueError``. Returns (logits of every position, or None
        when ``logits`` is false, caches)."""
        h = _embed_inputs(cfg, params["embed"], inputs)
        c, dev = h.shape[1], h.device
        max_seq, writes = _writes(caches, pos0, c, rows, dev)
        rolling = [j for j, s in enumerate(subs) if _rolling(s, max_seq)]
        if rolling:
            raise ValueError(f"{cfg.name}: chunked prefill needs global "
                             f"caches; subs {rolling} are rolling at "
                             f"max_seq={max_seq}")
        positions = pos0.to(dev)[:, None] + torch.arange(c, device=dev)
        h, _ = _run(params, h, positions, "chunk", caches=caches,
                    writes=writes, rows=None if rows is None else rows.to(dev))
        if not logits:
            return None, caches
        return L.unembed_apply(params["embed"], cfg, h), caches

    def decode_verify(params, caches, candidate_tokens, pos):
        """Speculative-decode verify: score ``candidate_tokens`` (B, K+1)
        (or (B, K+1, d) embeddings), the last emitted token followed by K
        draft proposals, in one batched call, returning logits for every
        candidate position. Rides the chunk machinery: candidate K/V is
        written at absolute positions ``pos..pos+K`` and chunk attention
        masks ``kpos <= qpos``, so positions past the accepted prefix hold
        stale K/V that later steps never attend and overwrite in place:
        rejection is a per-slot position rollback, not a cache rollback."""
        return prefill_chunk(params, caches, candidate_tokens, pos)

    def init_cache(batch: int, max_seq: int, cache_device=None):
        """Zeroed caches on ``cache_device`` (default: the model's device);
        real tensors, not broadcast views, since decode writes them in
        place. Under a policy DTensors in its placements for
        ``cache_axes()``; on the meta device whole meta tensors (the
        shapes ``launch.specs.abstract_cache`` gives specs)."""
        return [init_sub_cache(cfg, sub, n_super, batch, max_seq, dtype,
                               cache_device or device, policy)
                for sub in subs]

    def cache_axes():
        """The caches' logical axes, leaf for leaf (JAX's
        ``init_cache``'s)."""
        return [_sub_cache_axes() for _ in subs]

    kernel_ops = (flash_ops,) + ((gmm_ops,) if any(
        s.ffn == "moe" for s in subs) else ())
    unsharded = dict(prefill_chunk=prefill_chunk, decode_verify=decode_verify)
    if policy is not None:
        unsharded = {name: _not_under_policy(cfg, name) for name in unsharded}
    return SimpleNamespace(cfg=cfg, device=device, init=init, axes=axes,
                           forward=forward, split_blocks=split_blocks,
                           grad_masks=grad_masks, n_super=n_super, subs=subs,
                           kernel_ops=kernel_ops, mesh=mesh,
                           parallel=parallel, policy=policy,
                           distribute=_distributor(policy, axes),
                           prefill=prefill, decode=decode,
                           init_cache=init_cache, cache_axes=cache_axes,
                           **unsharded)


def _not_under_policy(cfg, name):
    """Chunked prefill and speculative verify under a policy: neither the
    JAX package's code nor its tests run them sharded, so the port refuses
    them rather than add a feature JAX lacks (ROADMAP C, departures)."""
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{cfg.name}: {name} under a sharding policy is not supported "
            f"(ROADMAP C: the JAX package runs it unsharded only); build "
            f"the model without one to serve it")
    return refuse


def _mamba_prefill(cfg, stacked, h, layers, policy=None):
    """Prefill through the Mamba layers ``layers`` of a stacked {"ln",
    "mamba"} tree: (h, each layer's cache); under a policy the residual
    stream constrained after each layer (``out_proj``'s partial sums
    all-reduced)."""
    caches = []
    for i in layers:
        p = _layer(stacked, i)
        out, cache = M.mamba_prefill(
            p["mamba"], cfg, L.rms_norm(h, p["ln"], cfg.norm_eps), policy)
        h = _constrain_act(policy, h + _constrain_act(policy, out))
        caches.append(cache)
    return h, caches


def _mamba_decode(cfg, stacked, caches, h, layers, policy=None):
    """One decode step through the Mamba layers ``layers``, writing their
    new states into the stacked ``caches`` in place (under a policy each
    rank its own parts)."""
    for i in layers:
        p = _layer(stacked, i)
        cache = _layer(caches, i)
        out, new = M.mamba_decode(
            p["mamba"], cfg, L.rms_norm(h, p["ln"], cfg.norm_eps), cache,
            policy)
        h = _constrain_act(policy, h + _constrain_act(policy, out))
        for k in ("x", "B", "C"):
            cache["conv"][k].copy_(new["conv"][k])
        cache["ssd"].copy_(new["ssd"])
    return h


def _stack_mamba(per_layer, policy=None):
    """Per-layer Mamba caches stacked on the layer axis; under a policy in
    its placements for ``_mamba_cache_axes()``."""
    out = {"conv": {k: _stack([c["conv"][k] for c in per_layer])
                    for k in ("x", "B", "C")},
           "ssd": _stack([c["ssd"] for c in per_layer])}
    if policy is not None:
        out = policy.constrain_tree(out, _mamba_cache_axes())
    return out


def _mamba_cache_axes():
    return stack_axes(M.mamba_cache_axes())


def _init_mamba_cache(cfg, batch, dtype, device, n, policy=None):
    """``M.init_mamba_cache``; under a policy zeroed DTensors in its
    placements (each rank allocates its own parts); on the meta device
    whole meta tensors."""
    if policy is None or torch.device(device).type == "meta":
        return M.init_mamba_cache(cfg, batch, dtype, device, n)
    shapes = M.init_mamba_cache(cfg, batch, dtype, "meta", n)
    return sharding.map_axes(
        lambda t, a: sharding.zeros(tuple(t.shape), t.dtype, device,
                                    policy.mesh,
                                    policy.placements_for(t.shape, a)),
        shapes, _mamba_cache_axes())


def _mamba_axes():
    return stack_axes({"ln": ("norm",), "mamba": M.mamba_axes()})


def _mamba_params(gen, cfg, dtype, n: int):
    return {"ln": L.zeros(gen, (cfg.d_model,), dtype, n),
            "mamba": M.mamba_init(gen, cfg, dtype, n)}


def _mamba_train_layer(cfg, policy=None):
    """One Mamba2 layer of the train path, ``(p, h) -> h + mamba(norm(h))``
    for a layer's ``{"ln", "mamba"}`` params, under ``cfg.remat_policy``
    (JAX remats its scan body, one layer); under a policy on DTensors, the
    output and the residual stream constrained as JAX's ``_constrainer``
    does."""
    def layer(p, h):
        out = M.mamba_block(p["mamba"], cfg,
                            L.rms_norm(h, p["ln"], cfg.norm_eps), policy)
        return _constrain_act(policy, h + _constrain_act(policy, out))
    return _remat(layer, cfg.remat_policy)


def _split_mamba(params, n: int):
    """``params`` with the stacked ``"mamba"`` tree split into a list of its
    ``n`` layers (views of the stacked tensors, no copies): ``forward``
    takes either form, and a train step differentiates the split form's
    leaves, so each layer's gradient is its own tensor rather than a
    scatter into the whole stack."""
    return {**params, "mamba": [_layer(params["mamba"], i) for i in range(n)]}


def _zero_aux(h):
    return L.replicated_like(h, torch.zeros((), dtype=torch.float32,
                                            device=h.device))


def _check_prompt(inputs, max_seq: int):
    if inputs.shape[1] > max_seq:
        raise ValueError(f"prompt of {inputs.shape[1]} tokens exceeds "
                         f"max_seq={max_seq}")


def _build_ssm(cfg: ModelConfig, device: torch.device, mesh=None,
               parallel=None, policy=None):
    """The pure Mamba2 stack: ``num_layers`` x (norm, Mamba2 block), run as
    a Python loop over the stacked layers. Under a ``policy`` on ``mesh``
    (JAX's ``_build_ssm(cfg, mesh, parallel, policy)``): params placed by
    ``distribute``, forward, prefill and decode on DTensors (the Mamba2
    block's sharding in ``models.mamba2``), caches in the policy's
    placements."""
    dtype = _dtype(cfg)
    n = cfg.num_layers

    def init(gen: Optional[torch.Generator] = None):
        """Random params with the JAX package's distributions, drawn from
        ``gen`` (default: seed 0 on the model's device)."""
        if gen is None:
            gen = _default_generator(device)
        return {"embed": L.embed_init(gen, cfg, dtype),
                "mamba": _mamba_params(gen, cfg, dtype, n),
                "final_norm": L.zeros(gen, (cfg.d_model,), dtype)}

    def embed(params, inputs):
        return _constrain_act(policy, _embed(cfg, params["embed"], inputs,
                                             policy, mesh, parallel))

    def prefill(params, inputs, max_seq: int):
        """inputs: (B, S) token ids or (B, S, d) embeddings. Returns
        (logits of the last position, caches)."""
        _check_prompt(inputs, max_seq)
        h = embed(params, inputs)
        h, per_layer = _mamba_prefill(cfg, params["mamba"], h, range(n),
                                      policy)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return (_logits(cfg, params["embed"], h[:, -1:], policy),
                _stack_mamba(per_layer, policy))

    def decode(params, caches, inputs, pos):
        """inputs: (B, 1) token ids or (B, 1, d) embeddings (``pos`` is
        unused: the state carries the position). Writes the new states into
        ``caches`` in place; returns (logits, caches)."""
        h = embed(params, inputs)
        h = _mamba_decode(cfg, params["mamba"], caches, h, range(n), policy)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return _logits(cfg, params["embed"], h, policy), caches

    def init_cache(batch: int, max_seq: int, cache_device=None):
        """Zeroed caches on ``cache_device`` (default: the model's device);
        real tensors, since decode writes them in place; under a policy
        DTensors in its placements (on the meta device whole meta
        tensors)."""
        return _init_mamba_cache(cfg, batch, dtype, cache_device or device,
                                 n, policy)

    layer = _mamba_train_layer(cfg, policy)

    def axes():
        """The params' logical axes, leaf for leaf (JAX's ``init``'s)."""
        return {"embed": L.embed_axes(), "mamba": _mamba_axes(),
                "final_norm": ("norm",)}

    def forward(params, inputs):
        """Train mode. inputs: (B, S) token ids or (B, S, d) embeddings.
        Returns (logits (B, S, padded vocab) f32, a zero f32 aux),
        differentiable. Each layer runs under ``cfg.remat_policy``;
        ``params`` may be stacked or ``split_blocks``'s form. Under a
        policy on DTensors, as the transformer's."""
        h = embed(params, inputs)
        for i in range(n):
            h = layer(_layer(params["mamba"], i), h)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return _logits(cfg, params["embed"], h, policy), _zero_aux(h)

    return SimpleNamespace(cfg=cfg, device=device, init=init, axes=axes,
                           forward=forward, mesh=mesh, parallel=parallel,
                           policy=policy,
                           distribute=_distributor(policy, axes),
                           split_blocks=lambda p: _split_mamba(p, n),
                           prefill=prefill, decode=decode,
                           init_cache=init_cache,
                           cache_axes=_mamba_cache_axes,
                           kernel_ops=(ssd_ops,))


def _distributor(policy, axes):
    """``model.distribute``: full params (the same on every rank) as
    DTensors in the policy's placements, each rank keeping its own slices;
    None with no policy."""
    if policy is None:
        return None
    return lambda params: policy.distribute_tree(params, axes())


def _hybrid_layout(cfg):
    """(layers a segment, shared-block applications, trailing layers)."""
    seg = cfg.shared_attn_every
    n_apps = cfg.num_layers // seg
    return seg, n_apps, cfg.num_layers - n_apps * seg


def _build_hybrid(cfg: ModelConfig, device: torch.device, mesh=None,
                  parallel=None, policy=None):
    """Zamba2: ``n_apps`` segments of ``shared_attn_every`` Mamba2 layers,
    each followed by the one shared attention+MLP sub-layer (global
    attention, its params unstacked as in JAX), then the trailing Mamba2
    layers. Caches: (the Mamba stack on the layer axis, the shared block's
    ``{"k", "v"}`` stacked on its applications). No ``prefill_chunk`` or
    ``decode_verify``, as in JAX. Under a ``policy`` on ``mesh``, as
    ``_build_ssm``'s, the shared block as a transformer sub-layer under
    the policy (its q heads never padded, as in JAX)."""
    dtype = _dtype(cfg)
    n = cfg.num_layers
    seg, n_apps, _ = _hybrid_layout(cfg)
    shared = Sub(0, cfg.rope_theta, "dense")
    segments = [range(a * seg, (a + 1) * seg) for a in range(n_apps)]
    trailing = range(n_apps * seg, n)
    sub_kw = dict(mesh=mesh, parallel=parallel, policy=policy)

    def init(gen: Optional[torch.Generator] = None):
        """Random params with the JAX package's distributions, drawn from
        ``gen`` (default: seed 0 on the model's device)."""
        if gen is None:
            gen = _default_generator(device)
        return {"embed": L.embed_init(gen, cfg, dtype),
                "mamba": _mamba_params(gen, cfg, dtype, n),
                "shared": sub_init(gen, cfg, shared, dtype, 0),
                "final_norm": L.zeros(gen, (cfg.d_model,), dtype)}

    def embed(params, inputs):
        return _constrain_act(policy, _embed(cfg, params["embed"], inputs,
                                             policy, mesh, parallel))

    def prefill(params, inputs, max_seq: int):
        """inputs: (B, S) token ids or (B, S, d) embeddings. Returns
        (logits of the last position, caches)."""
        _check_prompt(inputs, max_seq)
        h = embed(params, inputs)
        positions = torch.arange(h.shape[1], device=h.device)[None]
        m_caches, s_caches = [], []
        for layers in segments:
            h, cs = _mamba_prefill(cfg, params["mamba"], h, layers, policy)
            m_caches += cs
            h, sc = sub_apply(params["shared"], cfg, shared, h, positions,
                              "prefill", max_seq=max_seq, **sub_kw)
            h = _constrain_act(policy, h)
            s_caches.append(sc)
        h, cs = _mamba_prefill(cfg, params["mamba"], h, trailing, policy)
        m_caches += cs
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        if policy is not None:
            s_stacked = _place_caches(s_caches, policy)
        else:
            s_stacked = {k: torch.stack([c[k] for c in s_caches])
                         for k in ("k", "v")}
        caches = (_stack_mamba(m_caches, policy), s_stacked)
        return _logits(cfg, params["embed"], h[:, -1:], policy), caches

    def decode(params, caches, inputs, pos):
        """inputs: (B, 1) token ids or (B, 1, d) embeddings at positions
        ``pos`` (B,). Writes the new states and K/V into ``caches`` in
        place; returns (logits, caches)."""
        m_caches, s_caches = caches
        max_seq = s_caches["k"].shape[2]
        h = embed(params, inputs)
        if policy is not None:
            write = _write_index(pos, 1, max_seq)
            s_local = _local_caches(s_caches)
            positions = None
        else:
            write = _write_index(pos, 1, max_seq, device=h.device)
            pos = pos.to(h.device)
            positions = pos[:, None]
        for a, layers in enumerate(segments):
            h = _mamba_decode(cfg, params["mamba"], m_caches, h, layers,
                              policy)
            sc = s_local(a) if policy is not None else _layer(s_caches, a)
            h, _ = sub_apply(params["shared"], cfg, shared, h, positions,
                             "decode", cache=sc, pos=pos, max_seq=max_seq,
                             write=write, **sub_kw)
            h = _constrain_act(policy, h)
        h = _mamba_decode(cfg, params["mamba"], m_caches, h, trailing, policy)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return _logits(cfg, params["embed"], h, policy), caches

    def init_cache(batch: int, max_seq: int, cache_device=None):
        """Zeroed caches on ``cache_device`` (default: the model's device);
        real tensors, since decode writes them in place; under a policy
        DTensors in its placements (on the meta device whole meta
        tensors)."""
        dev = cache_device or device
        return (_init_mamba_cache(cfg, batch, dtype, dev, n, policy),
                init_sub_cache(cfg, shared, n_apps, batch, max_seq, dtype,
                               dev, policy))

    def cache_axes():
        """The caches' logical axes, leaf for leaf (JAX's
        ``init_cache``'s)."""
        return (_mamba_cache_axes(), _sub_cache_axes())

    layer = _mamba_train_layer(cfg, policy)

    def axes():
        """The params' logical axes, leaf for leaf (JAX's ``init``'s)."""
        return {"embed": L.embed_axes(), "mamba": _mamba_axes(),
                "shared": sub_axes(cfg, shared), "final_norm": ("norm",)}

    def forward(params, inputs):
        """Train mode, as JAX's: each segment's Mamba2 layers (each under
        ``cfg.remat_policy``), then the shared block in ``train`` mode, not
        remat'd (its gradient sums over its applications); the trailing
        layers; the final norm. inputs: (B, S) token ids or (B, S, d)
        embeddings. Returns (logits (B, S, padded vocab) f32, a zero f32
        aux). ``params`` may be stacked or ``split_blocks``'s form. Under a
        policy on DTensors, as the transformer's."""
        h = embed(params, inputs)
        positions = torch.arange(h.shape[1], device=h.device)[None]
        for layers in segments:
            for i in layers:
                h = layer(_layer(params["mamba"], i), h)
            h, _ = sub_apply(params["shared"], cfg, shared, h, positions,
                             "train", **sub_kw)
            h = _constrain_act(policy, h)
        for i in trailing:
            h = layer(_layer(params["mamba"], i), h)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return _logits(cfg, params["embed"], h, policy), _zero_aux(h)

    return SimpleNamespace(cfg=cfg, device=device, init=init, axes=axes,
                           forward=forward, mesh=mesh, parallel=parallel,
                           policy=policy,
                           distribute=_distributor(policy, axes),
                           split_blocks=lambda p: _split_mamba(p, n),
                           prefill=prefill, decode=decode,
                           init_cache=init_cache, cache_axes=cache_axes,
                           kernel_ops=(ssd_ops, flash_ops))
