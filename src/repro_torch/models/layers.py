"""Building blocks of the dense transformer (plain functions on tensors,
params as dicts), ported from the JAX package's ``repro.models.layers``.

Layouts and cast orders follow the JAX functions exactly, so the two agree
in float32 to rounding. Prefill attention runs on the flash attention op
(the CUDA kernel on the card); decode and chunk attention are plain torch
ops, as the reference has no TPU kernel for them.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed import comm
from repro_torch.kernels.flash_attention.ops import flash_attention

# ---------------------------------------------------------------------------
# Param initialisation (same distributions as the JAX package; the numbers
# differ, since torch.Generator is not jax.random)
# ---------------------------------------------------------------------------


class MetaGenerator:
    """Stands for a generator on the ``meta`` device, which torch has not:
    inits drawn from it make meta tensors (shapes and dtypes, no storage),
    the counterpart of JAX's ``eval_shape`` of an init."""
    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None,
               *, stack: int = 0):
    """Normal * scale (default 1/sqrt(fan_in) with fan_in = shape[0]) cast to
    ``dtype``. ``stack`` > 0 adds a leading axis of that many independent
    draws, made one slice at a time to keep f32 temporaries small."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))

    if isinstance(gen, MetaGenerator):
        return torch.empty(((stack,) if stack else ()) + tuple(shape),
                           dtype=dtype, device="meta")

    def one():
        x = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)
    if not stack:
        return one()
    out = torch.empty((stack, *shape), dtype=dtype, device=gen.device)
    for i in range(stack):
        out[i] = one()
    return out


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with a zero-centred weight: f32 mean-square, then
    ``(x * scale.astype(dtype)) * (1 + w).astype(dtype)`` as in the JAX
    function."""
    var = torch.sum(torch.square(x.float()), dim=-1, keepdim=True) / x.shape[-1]
    return rms_norm_from(x, weight, var, eps)


def rms_norm_from(x, weight, var, eps: float):
    """``rms_norm`` from the f32 mean square ``var`` of x's last dim."""
    dtype = x.dtype
    scale = torch.rsqrt(var + eps)
    w = 1.0 + weight.float()
    return (x * scale.to(dtype)) * w.to(dtype)


def head_dim_norms(q, k, q_norm, k_norm, eps: float, group, head_dim: int):
    """``rms_norm`` of q and k over a head dim that the ranks of ``group``
    hold in contiguous blocks (``"head_dim"`` mode; the norms' weights
    sharded alike): each rank's sums of squares, one all-reduce SUM over
    ``group`` of q's and k's together (B, S, H + KV, 1) f32, then each
    rank's block normed by the whole head dim's mean square."""
    ss = torch.cat([torch.sum(torch.square(t.float()), dim=-1, keepdim=True)
                    for t in (q, k)], dim=2)
    var = comm.all_reduce(ss, group) / head_dim
    h = q.shape[2]
    return (rms_norm_from(q, q_norm, var[:, :, :h], eps),
            rms_norm_from(k, k_norm, var[:, :, h:], eps))


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_freqs_f32(head_dim: int, theta: float, device: torch.device):
    # copied to the device once: a host-to-device copy per call would make
    # the host wait for the device twice per layer
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def replicated_like(x, t):
    """``t`` (a plain tensor, the same on every rank) as a replicated
    DTensor on ``x``'s mesh where ``x`` is a DTensor, else ``t``: DTensor
    ops take no plain tensor beside a DTensor."""
    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Frequencies
    in float64 numpy, angles in f32, sin/cos cast to x.dtype, the rotation
    in x.dtype."""
    freqs = _rope_freqs_f32(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    angles = angles[..., None, :]                            # (..., S, 1, D/2)
    sin = replicated_like(x, torch.sin(angles).to(x.dtype))
    cos = replicated_like(x, torch.cos(angles).to(x.dtype))
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope_head_dim(q, k, positions, theta: float, group, head_dim: int):
    """``apply_rope`` of q and k whose head dim the ranks of ``group`` hold
    in contiguous blocks of ``c = head_dim / tp`` (``"head_dim"`` mode). The
    rotation pairs dim i with dim i + head_dim / 2, so a rank of the first
    half (blocks 0 .. tp/2 - 1) needs the block tp/2 ranks on, and a rank
    of the second half the block tp/2 ranks back: one exchange with that
    partner (``comm.send_recv``, q's and k's blocks together) per call.
    Each rank then computes its own block with the unsharded formula's
    operations, so the values are the unsharded ones bit for bit. tp is
    even: the mode needs it to divide the head dim, a power of two."""
    tp, r = comm.group_size(group), comm.group_rank(group)
    if tp % 2:
        raise ValueError(f"head-dim sharding over {tp} ranks: rope pairs "
                         f"the halves of the head dim, which an odd tp "
                         f"does not split at a block edge")
    h = q.shape[2]
    both = torch.cat([q, k], dim=2)
    c = both.shape[-1]
    first = r < tp // 2
    partner = comm.send_recv(both, (r + tp // 2) % tp, (r + tp // 2) % tp,
                             group)
    j0 = r * c if first else r * c - head_dim // 2
    freqs = _rope_freqs_f32(head_dim, theta, both.device)[j0:j0 + c]
    angles = (positions[..., None].float() * freqs)[..., None, :]
    sin = torch.sin(angles).to(both.dtype)
    cos = torch.cos(angles).to(both.dtype)
    out = both * cos - partner * sin if first else both * cos + partner * sin
    return out[:, :, :h], out[:, :, h:]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def zeros(gen, shape, dtype, stack: int = 0):
    """Zeros of ``shape`` on ``gen``'s device, with a leading ``stack`` axis
    when ``stack`` > 0 (as ``dense_init``)."""
    return torch.zeros(((stack,) if stack else ()) + tuple(shape),
                       dtype=dtype, device=gen.device)


def attn_init(gen, cfg, dtype, stack: int, h_pad: Optional[int] = None):
    """wq, wk, wv, wo; with ``qkv_bias`` zero biases bq, bk, bv, and with
    ``qk_norm`` zero-centred norms q_norm, k_norm over the head dim.
    ``h_pad`` > num_heads pads the q heads with zero wq columns and wo rows
    (their gradients masked by ``attn_grad_masks``, so the function is
    unchanged), as JAX's ``attn_init``."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    he = h_pad or h
    p = {
        "wq": dense_init(gen, (d, he, hd), dtype, stack=stack),
        "wk": dense_init(gen, (d, kv, hd), dtype, stack=stack),
        "wv": dense_init(gen, (d, kv, hd), dtype, stack=stack),
        "wo": dense_init(gen, (he, hd, d), dtype,
                         scale=1.0 / math.sqrt(h * hd), stack=stack),
    }
    if he > h:
        p["wq"][..., h:, :] = 0
        p["wo"][..., h:, :, :] = 0
    if cfg.qkv_bias:
        p["bq"] = zeros(gen, (he, hd), dtype, stack)
        p["bk"] = zeros(gen, (kv, hd), dtype, stack)
        p["bv"] = zeros(gen, (kv, hd), dtype, stack)
    if cfg.qk_norm:
        p["q_norm"] = zeros(gen, (hd,), dtype, stack)
        p["k_norm"] = zeros(gen, (hd,), dtype, stack)
    return p


def attn_axes(cfg) -> dict:
    """Logical axes of ``attn_init``'s params (unstacked), as JAX's."""
    ax = {"wq": ("embed", "q_heads", "head_dim"),
          "wk": ("embed", "kv_heads", "head_dim"),
          "wv": ("embed", "kv_heads", "head_dim"),
          "wo": ("q_heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        ax.update(bq=("q_heads", "head_dim"), bk=("kv_heads", "head_dim"),
                  bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        ax.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return ax


def attn_grad_masks(cfg, h_pad: Optional[int] = None) -> dict:
    """Same keys as ``attn_init``'s params: 1.0 where the gradient is kept,
    else a 0/1 f32 tensor broadcastable to the leaf (stacked or not) that
    zeroes the padded q-head slices."""
    h = cfg.num_heads
    he = h_pad or h
    base = dict.fromkeys(attn_axes(cfg), 1.0)
    if he > h:
        m = (torch.arange(he) < h).float()
        base["wq"] = m[None, :, None]
        base["wo"] = m[:, None, None]
        if cfg.qkv_bias:
            base["bq"] = m[:, None]
    return base


def kv_head_map(num_heads: int, num_kv_heads: int, h_pad: int):
    """Per-q-head kv index (padded heads clamp to the last kv head)."""
    g = max(num_heads // num_kv_heads, 1)
    return torch.clamp(torch.arange(h_pad) // g, 0, num_kv_heads - 1)


def expand_kv(k, head_map):
    """(B, S, KV, hd) -> (B, S, H_pad, hd) per-q-head layout."""
    return torch.index_select(k, 2, replicated_like(k, head_map.to(k.device)))


def _proj(x, w):
    """einsum("bsd,dhk->bshk"): one matmul over the flattened (h, k) axes.
    On DTensors whose product DTensor could split inside a head
    (``_cuts_heads``), as a local region (``_proj_whole_heads``)."""
    if isinstance(w, DTensor) and _cuts_heads(w):
        return _proj_whole_heads(x, w)
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def _cuts_heads(w) -> bool:
    """Whether a mesh dim replicates w (D, heads, hd) but does not divide
    its heads (8 kv heads over a 16-rank ``model`` axis in ``"expand"``
    mode). DTensor may shard such a product over the replicated weight's
    columns, a free local slice, and then neither the view into heads nor
    the weight's gradient can take the split."""
    return any(p.is_replicate() and w.shape[1] % w.device_mesh.size(i)
               for i, p in enumerate(w.placements))


def _proj_whole_heads(x, w):
    """``_proj`` as a local region: w gathered whole, each rank's rows of x
    times it, the product placed as x. w's gradient is summed over the mesh
    dims that split x's rows (each rank's rows give their part of it) and
    is the same on the rest."""
    mesh = w.device_mesh
    if any(p.is_shard(x.ndim - 1) or p.is_partial() for p in x.placements):
        raise ValueError(f"x placed {x.placements}: the local projection "
                         f"takes x split by rows only")
    wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate()
                         for p in x.placements])
    xl = x.to_local()
    y = (xl @ wl.reshape(wl.shape[0], -1)).reshape(*xl.shape[:-1],
                                                   *wl.shape[1:])
    shape = (*x.shape[:-1], *w.shape[1:])
    return DTensor.from_local(y, mesh, x.placements, shape=shape,
                              stride=contiguous_strides(shape))


def qkv_proj(p, cfg, x, positions, theta: float, head_dim_group=None):
    """Project, then the bias and the per-head norm where the params hold
    them, then rope. x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd). With
    ``head_dim_group``, ``p`` holds this rank's block of the head dim
    (``"head_dim"`` mode) and the norm and rope take that group's
    collectives (``head_dim_norms``, ``apply_rope_head_dim``)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if head_dim_group is not None:
        if "q_norm" in p:
            q, k = head_dim_norms(q, k, p["q_norm"], p["k_norm"],
                                  cfg.norm_eps, head_dim_group, cfg.head_dim)
        q, k = apply_rope_head_dim(q, k, positions, theta, head_dim_group,
                                   cfg.head_dim)
        return q, k, v
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def out_proj(attn, wo):
    """einsum("bshk,hkd->bsd")."""
    b, s = attn.shape[:2]
    return attn.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def _scale(cfg):
    return 1.0 / math.sqrt(cfg.head_dim)


def _group(q, kv_heads):
    """(B,S,H,hd) -> (B,S,KV,G,hd) grouping q heads over kv heads."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, hd)


def contiguous_strides(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


class _ContiguousGrad(torch.autograd.Function):
    """``x`` made contiguous, and its gradient too: a DTensor reshapes its
    local tensor by a view, which a strided gradient (the plain backward's
    transposes) would not take."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous() if not x.is_contiguous() else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def attention_fused_proxy(cfg, q, k, v, *, window: int = 0):
    """DRY-RUN lowering proxy (JAX's ``attention_fused_proxy``, see
    ``ModelConfig.attn_impl``): the products of flash attention with the
    same dimensions and FLOPs, the score tiles in q's dtype with no softmax
    chain. Not a numerical attention implementation."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = _group(q, kvh)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k) * torch.tensor(
        _scale(cfg), dtype=q.dtype, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask[None, None, None], s,
                    torch.zeros((), dtype=q.dtype, device=q.device))
    out = torch.einsum("bkgst,btkh->bskgh", s, v)
    return out.reshape(b, sq, h, hd)


def _attention_core(cfg, q, k, v, window: int):
    if cfg.attn_impl == "fused_proxy":
        return attention_fused_proxy(cfg, q, k, v, window=window)
    return flash_attention(q, k, v, causal=True, window=window,
                           softcap=cfg.attn_softcap)


def attention(cfg, q, k, v, *, window: int = 0):
    """Full-sequence causal attention (prefill and train): the flash
    attention op, or ``attention_fused_proxy`` where ``cfg.attn_impl`` asks
    for it (JAX's dispatch). On DTensors (batch and heads sharded, as the
    policy's constraints leave them), it runs on each rank's local batch
    rows and heads: contiguous plain tensors, no collective."""
    if isinstance(q, DTensor):
        out = _attention_core(cfg, *(_ContiguousGrad.apply(t.to_local())
                                     for t in (q, k, v)), window)
        # the plain version's output is a strided view; the kernel's is not
        return DTensor.from_local(out.contiguous(), q.device_mesh,
                                  q.placements, shape=q.shape,
                                  stride=contiguous_strides(q.shape))
    return _attention_core(cfg, q, k, v, window)


def masked_attention(cfg, q, k_cache, v_cache, valid, scores_sum=None):
    """Softmax attention of q (B,C,H,hd) over cache slots (B,T,KV,hd) where
    ``valid`` (B,C,T) holds: f32 scores, scale, softcap, masked to -1e30,
    probabilities in q's dtype (the JAX cast order). The plain cores of
    decode (global and rolling) and chunk attention. ``scores_sum`` sums
    the f32 scores over the ranks first where q and the caches hold a
    block of the head dim each (``"head_dim"`` mode: JAX's psum)."""
    b, c, h, hd = q.shape
    qg = _group(q, k_cache.shape[2])
    s = torch.einsum("bskgh,btkh->bkgst", qg, k_cache).float()
    if scores_sum is not None:
        s = scores_sum(s)
    s = softcap(s * _scale(cfg), cfg.attn_softcap)
    s = torch.where(valid[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v_cache)
    return out.reshape(b, c, h, hd)


def chunk_attention(cfg, q, k_cache, v_cache, qpos):
    """Chunked-prefill attention: a multi-token chunk attends over the full
    per-slot cache. q: (B,C,H,hd); caches: (B,T,KV,hd) with the chunk's own
    K/V already written at absolute positions ``qpos``; qpos: (B,C). Global
    attention only (the engine gates chunking to padding-safe models), where
    masking ``kpos <= qpos`` is exact: positions beyond the chunk are unwritten
    scratch or later prompt positions not yet computed, both masked."""
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos[None, None, :] <= qpos[:, :, None]           # (B,C,T)
    return masked_attention(cfg, q, k_cache, v_cache, valid)


def decode_attention(cfg, q, k_cache, v_cache, pos, *, window: int = 0,
                     scores_sum=None):
    """Single-token decode. q: (B,1,H,hd); caches: (B,S,KV,hd); pos: (B,)
    (position of the *current* token, already written into the cache)."""
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos[None, :] <= pos[:, None]
    if window:
        valid &= pos[:, None] - kpos[None, :] < window
    return masked_attention(cfg, q, k_cache, v_cache, valid[:, None],
                            scores_sum)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, d: int, ff: int, dtype, stack: int):
    return {
        "wi": dense_init(gen, (d, ff), dtype, stack=stack),
        "wg": dense_init(gen, (d, ff), dtype, stack=stack),
        "wo": dense_init(gen, (ff, d), dtype, stack=stack),
    }


def mlp_axes() -> dict:
    return {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")}


def mlp_apply(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen, cfg, dtype):
    return {"tok": dense_init(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                              scale=1.0)}


def embed_axes() -> dict:
    return {"tok": ("vocab", "embed")}


def embed_apply(p, tokens, d_model: int):
    # sqrt(d) rounded to the param dtype, as a 0-dim CPU tensor: a scalar
    # operand that needs no host-to-device copy
    tok = p["tok"]
    return tok[tokens] * torch.tensor(math.sqrt(d_model), dtype=tok.dtype)


def unembed_apply(p, cfg, x):
    logits = (x @ p["tok"].T).float()
    return softcap(logits, cfg.final_softcap)
