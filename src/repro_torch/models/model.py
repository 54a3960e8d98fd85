"""The dense transformer, ported from the JAX package's ``repro.models.model``
(``_build_transformer`` and the sub-layer it scans):

    model = build_model(cfg, device="cuda")
    params = model.init(generator)
    logits, caches = model.prefill(params, tokens, max_seq)
    logits, caches = model.decode(params, caches, tokens, pos)
    caches = model.init_cache(batch, max_seq)

Params keep the JAX pytree and layouts: ``{"embed": {"tok"}, "blocks":
[per-sub dict stacked on a leading n_super axis], "final_norm"}``, so
``repro_torch.models.params`` carries JAX-initialised weights across
unchanged. Caches are a list (one per sub) of ``{"k", "v"}`` tensors of shape
(n_super, B, max_seq, KV, hd). Where JAX returns a new cache, the port writes
the cache in place: decode updates the cache it is given and returns it.

The slice ported so far is the dense, all-global, token-input family
(``yi-9b``); other configs raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

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


def _unsupported(cfg: ModelConfig) -> list:
    """Features of ``cfg`` outside the ported slice."""
    checks = {
        f"family {cfg.family!r}": cfg.family != "dense",
        f"input_mode {cfg.input_mode!r}": cfg.input_mode != "tokens",
        "sliding-window (rolling cache) layers": bool(
            cfg.sliding_window or cfg.local_global_pattern),
        "qkv_bias": cfg.qkv_bias,
        "qk_norm": cfg.qk_norm,
        "post_norm": cfg.post_norm,
    }
    return [name for name, bad in checks.items() if bad]


# ---------------------------------------------------------------------------
# Attention/FFN sub-layer
# ---------------------------------------------------------------------------


def sub_init(gen, cfg: ModelConfig, dtype, n_super: int):
    """One sub-layer's params, stacked on a leading ``n_super`` axis."""
    shape = (n_super, cfg.d_model)
    return {"ln1": torch.zeros(shape, dtype=dtype, device=gen.device),
            "attn": L.attn_init(gen, cfg, dtype, n_super),
            "ln2": torch.zeros(shape, dtype=dtype, device=gen.device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, n_super)}


def _build_prefill_cache(k, v, cache_len: int):
    """k/v: (B, S, KV, hd) -> zero-padded cache of length cache_len (the
    non-rolling case: cache_len >= S)."""
    pad = cache_len - k.shape[1]
    return F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad))


def sub_apply(p, cfg: ModelConfig, sub: Sub, h, positions, mode: str,
              cache=None, pos=None, max_seq: Optional[int] = None):
    """One transformer sub-layer. Returns (h, new_cache).

    ``prefill``: attention over the whole sequence on the flash op; the new
    cache is this layer's K/V padded to ``max_seq``. ``decode``: one token
    per row at ``pos``; its K/V is written into ``cache`` in place (JAX:
    ``cache.at[arange(b), pos].set(k[:, 0])``) and ``cache`` is returned."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, hn, positions, sub.theta)
    if mode == "decode":
        rows = torch.arange(h.shape[0], device=h.device)
        cache["k"][rows, pos] = k[:, 0]
        cache["v"][rows, pos] = v[:, 0]
        attn = L.decode_attention(cfg, q, cache["k"], cache["v"], pos,
                                  window=sub.window)
        new_cache = cache
    elif mode == "prefill":
        kc, vc = _build_prefill_cache(k, v, max_seq)
        new_cache = {"k": kc, "v": vc}
        attn = L.attention(cfg, q, k, v, window=sub.window)
    else:
        raise ValueError(f"mode {mode!r} is not ported (prefill, decode)")
    h = h + L.out_proj(attn, p["attn"]["wo"])
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + L.mlp_apply(p["mlp"], hn), new_cache


def init_sub_cache(cfg, n_super: int, batch: int, max_seq: int, dtype,
                   device):
    shape = (n_super, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Model builder
# ---------------------------------------------------------------------------


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree: dict, i: int) -> dict:
    """Super-block ``i`` of a stacked param/cache dict (views, no copies)."""
    return {k: _layer(x, i) if isinstance(x, dict) else x[i]
            for k, x in tree.items()}


def build_model(cfg: ModelConfig, device=None):
    """The dense transformer for ``cfg`` on ``device`` (default: the current
    CUDA device; raises when there is none)."""
    missing = _unsupported(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port "
            f"covers the dense all-global family)")
    device = resolve_device(device)
    n_super, subs = program(cfg)
    dtype = _dtype(cfg)

    def init(gen: Optional[torch.Generator] = None):
        """Random params with the JAX package's distributions, drawn from
        ``gen`` (default: seed 0 on the model's device)."""
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        return {"embed": L.embed_init(gen, cfg, dtype),
                "blocks": [sub_init(gen, cfg, dtype, n_super) for _ in subs],
                "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                          device=gen.device)}

    def _run(params, h, positions, mode, caches=None, pos=None,
             max_seq=None):
        new_caches = [[] for _ in subs]
        for i in range(n_super):
            for j, sub in enumerate(subs):
                cs = _layer(caches[j], i) if caches is not None else None
                h, nc = sub_apply(_layer(params["blocks"][j], i), cfg, sub, h,
                                  positions, mode, cache=cs, pos=pos,
                                  max_seq=max_seq)
                new_caches[j].append(nc)
        return L.rms_norm(h, params["final_norm"], cfg.norm_eps), new_caches

    def prefill(params, inputs, max_seq: int):
        """inputs: (B, S) token ids. Returns (logits of the last position,
        caches of length ``max_seq``)."""
        s = inputs.shape[1]
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
        positions = torch.arange(s, device=inputs.device)[None, :]
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        h, per_layer = _run(params, h, positions, "prefill", max_seq=max_seq)
        caches = [{"k": torch.stack([c["k"] for c in cs]),
                   "v": torch.stack([c["v"] for c in cs])} for cs in per_layer]
        return L.unembed_apply(params["embed"], cfg, h[:, -1:]), caches

    def decode(params, caches, inputs, pos):
        """inputs: (B, 1) token ids at positions ``pos`` (B,). Writes their
        K/V into ``caches`` in place; returns (logits, caches)."""
        positions = pos[:, None]
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        h, _ = _run(params, h, positions, "decode", caches=caches, pos=pos)
        return L.unembed_apply(params["embed"], cfg, h), caches

    def init_cache(batch: int, max_seq: int, cache_device=None):
        """Zeroed caches on ``cache_device`` (default: the model's device);
        real tensors, not broadcast views, since decode writes them in
        place."""
        return [init_sub_cache(cfg, n_super, batch, max_seq, dtype,
                               cache_device or device) for _ in subs]

    return SimpleNamespace(cfg=cfg, device=device, init=init, prefill=prefill,
                           decode=decode, init_cache=init_cache,
                           n_super=n_super, subs=subs)
