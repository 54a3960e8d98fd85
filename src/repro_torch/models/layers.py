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

from repro_torch.kernels.flash_attention.ops import flash_attention

# ---------------------------------------------------------------------------
# Param initialisation (same distributions as the JAX package; the numbers
# differ, since torch.Generator is not jax.random)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None,
               *, stack: int = 0):
    """Normal * scale (default 1/sqrt(fan_in) with fan_in = shape[0]) cast to
    ``dtype``. ``stack`` > 0 adds a leading axis of that many independent
    draws, made one slice at a time to keep f32 temporaries small."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))

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
    dtype = x.dtype
    var = torch.sum(torch.square(x.float()), dim=-1, keepdim=True) / x.shape[-1]
    scale = torch.rsqrt(var + eps)
    w = 1.0 + weight.float()
    return (x * scale.to(dtype)) * w.to(dtype)


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


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Frequencies
    in float64 numpy, angles in f32, sin/cos cast to x.dtype, the rotation
    in x.dtype."""
    freqs = _rope_freqs_f32(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    angles = angles[..., None, :]                            # (..., S, 1, D/2)
    sin = torch.sin(angles).to(x.dtype)
    cos = torch.cos(angles).to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def zeros(gen, shape, dtype, stack: int = 0):
    """Zeros of ``shape`` on ``gen``'s device, with a leading ``stack`` axis
    when ``stack`` > 0 (as ``dense_init``)."""
    return torch.zeros(((stack,) if stack else ()) + tuple(shape),
                       dtype=dtype, device=gen.device)


def attn_init(gen, cfg, dtype, stack: int):
    """wq, wk, wv, wo; with ``qkv_bias`` zero biases bq, bk, bv, and with
    ``qk_norm`` zero-centred norms q_norm, k_norm over the head dim."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype, stack=stack),
        "wk": dense_init(gen, (d, kv, hd), dtype, stack=stack),
        "wv": dense_init(gen, (d, kv, hd), dtype, stack=stack),
        "wo": dense_init(gen, (h, hd, d), dtype, scale=1.0 / math.sqrt(h * hd),
                         stack=stack),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros(gen, (h, hd), dtype, stack)
        p["bk"] = zeros(gen, (kv, hd), dtype, stack)
        p["bv"] = zeros(gen, (kv, hd), dtype, stack)
    if cfg.qk_norm:
        p["q_norm"] = zeros(gen, (hd,), dtype, stack)
        p["k_norm"] = zeros(gen, (hd,), dtype, stack)
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk"): one matmul over the flattened (h, k) axes."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def qkv_proj(p, cfg, x, positions, theta: float):
    """Project, then the bias and the per-head norm where the params hold
    them, then rope. x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
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


def attention(cfg, q, k, v, *, window: int = 0):
    """Full-sequence causal attention (prefill): the flash attention op."""
    return flash_attention(q, k, v, causal=True, window=window,
                           softcap=cfg.attn_softcap)


def masked_attention(cfg, q, k_cache, v_cache, valid):
    """Softmax attention of q (B,C,H,hd) over cache slots (B,T,KV,hd) where
    ``valid`` (B,C,T) holds: f32 scores, scale, softcap, masked to -1e30,
    probabilities in q's dtype (the JAX cast order). The plain cores of
    decode (global and rolling) and chunk attention."""
    b, c, h, hd = q.shape
    qg = _group(q, k_cache.shape[2])
    s = torch.einsum("bskgh,btkh->bkgst", qg, k_cache).float()
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


def decode_attention(cfg, q, k_cache, v_cache, pos, *, window: int = 0):
    """Single-token decode. q: (B,1,H,hd); caches: (B,S,KV,hd); pos: (B,)
    (position of the *current* token, already written into the cache)."""
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos[None, :] <= pos[:, None]
    if window:
        valid &= pos[:, None] - kpos[None, :] < window
    return masked_attention(cfg, q, k_cache, v_cache, valid[:, None])


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, d: int, ff: int, dtype, stack: int):
    return {
        "wi": dense_init(gen, (d, ff), dtype, stack=stack),
        "wg": dense_init(gen, (d, ff), dtype, stack=stack),
        "wo": dense_init(gen, (ff, d), dtype, stack=stack),
    }


def mlp_apply(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen, cfg, dtype):
    return {"tok": dense_init(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                              scale=1.0)}


def embed_apply(p, tokens, d_model: int):
    # sqrt(d) rounded to the param dtype, as a 0-dim CPU tensor: a scalar
    # operand that needs no host-to-device copy
    tok = p["tok"]
    return tok[tokens] * torch.tensor(math.sqrt(d_model), dtype=tok.dtype)


def unembed_apply(p, cfg, x):
    logits = (x @ p["tok"].T).float()
    return softcap(logits, cfg.final_softcap)
