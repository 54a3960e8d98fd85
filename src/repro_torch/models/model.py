"""The port's models, from the JAX package's ``repro.models.model``: the
transformer (``_build_transformer`` and the sub-layer it scans, dense or MoE
FFN) and the pure SSM stack (``_build_ssm``):

    model = build_model(cfg, device="cuda")
    params = model.init(generator)
    logits, caches = model.prefill(params, tokens, max_seq)
    logits, caches = model.decode(params, caches, tokens, pos)
    logits, caches = model.prefill_chunk(params, caches, tokens, pos0)
    logits, caches = model.decode_verify(params, caches, tokens, pos)
    caches = model.init_cache(batch, max_seq)

Params keep the JAX pytrees and layouts, so ``repro_torch.models.params``
carries JAX-initialised weights across unchanged: the transformer's
``{"embed": {"tok"}, "blocks": [per-sub dict stacked on a leading n_super
axis], "final_norm"}`` and the SSM's ``{"embed", "mamba": {"ln", "mamba":
{...}} stacked on a leading layer axis, "final_norm"}``. The transformer's
caches are a list (one per sub) of ``{"k", "v"}`` tensors of shape
(n_super, B, max_seq, KV, hd); the SSM's are ``{"conv": {"x", "B", "C"},
"ssd"}`` stacked on the layer axis. Where JAX returns a new cache, the port
writes the cache in place: decode, ``prefill_chunk`` and ``decode_verify``
update the cache they are given and return it. A write at a position past
the cache's end is dropped, as JAX's scatter drops out-of-range updates
(never clamped onto a real position): the write index is worked out on the
host from the positions, so pass them as CPU tensors to keep the host from
waiting on the device.

Ported so far: the dense and MoE all-global token families (``yi-9b``,
``granite-moe-1b-a400m``, ``llama4`` at reduced size) and the pure SSM
family (``mamba2-370m``); other configs raise ``NotImplementedError``.
``model.kernel_ops`` lists the kernel modules the model's path launches.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
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


def _unsupported(cfg: ModelConfig) -> list:
    """Features of ``cfg`` outside the ported slice."""
    checks = {
        f"family {cfg.family!r}": cfg.family not in ("dense", "moe", "ssm"),
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


def sub_init(gen, cfg: ModelConfig, sub: Sub, dtype, n_super: int):
    """One sub-layer's params, stacked on a leading ``n_super`` axis."""
    shape = (n_super, cfg.d_model)
    p = {"ln1": torch.zeros(shape, dtype=dtype, device=gen.device),
         "attn": L.attn_init(gen, cfg, dtype, n_super),
         "ln2": torch.zeros(shape, dtype=dtype, device=gen.device)}
    if sub.ffn == "dense":
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, n_super)
    else:
        p["moe"] = MOE.moe_init(gen, cfg, dtype, n_super)
    return p


def _build_prefill_cache(k, v, cache_len: int):
    """k/v: (B, S, KV, hd) -> zero-padded cache of length cache_len (the
    non-rolling case: cache_len >= S)."""
    pad = cache_len - k.shape[1]
    return F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad))


def _write_index(pos0, c: int, max_seq: int, rows=None, device=None):
    """Where a call writes K/V for tokens at positions ``pos0[r] + j``
    (j < c): (cache row, cache position, call row, call column) of every
    position below ``max_seq``, on ``device``. Later positions are dropped,
    as JAX's scatter drops out-of-range updates. ``rows`` (B,) maps call
    rows to cache rows (default: the same row). Worked out on the host from
    ``pos0`` (a CPU tensor costs no wait for the device), then one copy."""
    positions = pos0.cpu()[:, None] + torch.arange(c)
    r, j = (positions < max_seq).nonzero(as_tuple=True)
    cache_rows = r if rows is None else rows.cpu()[r]
    return tuple(torch.stack([cache_rows, positions[r, j], r, j])
                 .to(device).unbind(0))


def sub_apply(p, cfg: ModelConfig, sub: Sub, h, positions, mode: str,
              cache=None, pos=None, max_seq: Optional[int] = None,
              write=None, rows=None):
    """One transformer sub-layer. Returns (h, new_cache).

    ``prefill``: attention over the whole sequence on the flash op; the new
    cache is this layer's K/V padded to ``max_seq``. ``decode``: one token
    per row at ``pos``; its K/V is written into ``cache`` in place (JAX:
    ``cache.at[arange(b), pos].set(k[:, 0])``) and ``cache`` is returned.
    ``chunk``: C tokens per row at ``positions``; their K/V is written in
    place (JAX: ``cache.at[arange(b)[:, None], positions].set(k)``) and the
    chunk attends over its rows of the cache, ``rows`` of it when given.
    ``write`` is the call's ``_write_index`` (decode and chunk)."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, hn, positions, sub.theta)
    if mode in ("decode", "chunk"):
        crow, cpos, r, j = write
        cache["k"][crow, cpos] = k[r, j]
        cache["v"][crow, cpos] = v[r, j]
        new_cache = cache
        if mode == "decode":
            attn = L.decode_attention(cfg, q, cache["k"], cache["v"], pos,
                                      window=sub.window)
        else:
            kc, vc = ((cache["k"], cache["v"]) if rows is None
                      else (cache["k"][rows], cache["v"][rows]))
            attn = L.chunk_attention(cfg, q, kc, vc, positions)
    elif mode == "prefill":
        kc, vc = _build_prefill_cache(k, v, max_seq)
        new_cache = {"k": kc, "v": vc}
        attn = L.attention(cfg, q, k, v, window=sub.window)
    else:
        raise ValueError(f"mode {mode!r} is not ported (prefill, decode, "
                         f"chunk)")
    h = h + L.out_proj(attn, p["attn"]["wo"])
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if sub.ffn == "dense":
        mo = L.mlp_apply(p["mlp"], hn)
    else:
        mo, _ = MOE.moe_apply(p["moe"], cfg, hn)
    return h + mo, new_cache


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
    """The model for ``cfg`` on ``device`` (default: the current CUDA
    device; raises when there is none)."""
    missing = _unsupported(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port "
            f"covers the dense and MoE all-global families and pure SSM)")
    device = resolve_device(device)
    if cfg.family == "ssm":
        return _build_ssm(cfg, device)
    return _build_transformer(cfg, device)


def _build_transformer(cfg: ModelConfig, device: torch.device):
    n_super, subs = program(cfg)
    dtype = _dtype(cfg)

    def init(gen: Optional[torch.Generator] = None):
        """Random params with the JAX package's distributions, drawn from
        ``gen`` (default: seed 0 on the model's device)."""
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        return {"embed": L.embed_init(gen, cfg, dtype),
                "blocks": [sub_init(gen, cfg, sub, dtype, n_super)
                           for sub in subs],
                "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                          device=gen.device)}

    def _run(params, h, positions, mode, caches=None, pos=None,
             max_seq=None, write=None, rows=None):
        new_caches = [[] for _ in subs]
        for i in range(n_super):
            for j, sub in enumerate(subs):
                cs = _layer(caches[j], i) if caches is not None else None
                h, nc = sub_apply(_layer(params["blocks"][j], i), cfg, sub, h,
                                  positions, mode, cache=cs, pos=pos,
                                  max_seq=max_seq, write=write, rows=rows)
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
        K/V into ``caches`` in place (a row past the end writes nothing and
        attends over the whole cache, as in JAX); returns (logits,
        caches)."""
        write = _write_index(pos, 1, caches[0]["k"].shape[2],
                            device=inputs.device)
        pos = pos.to(inputs.device)
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        h, _ = _run(params, h, pos[:, None], "decode", caches=caches,
                    pos=pos, write=write)
        return L.unembed_apply(params["embed"], cfg, h), caches

    def prefill_chunk(params, caches, inputs, pos0, rows=None,
                      logits: bool = True):
        """Chunk-wise prefill: run ``inputs`` (B, C), one chunk of a longer
        prompt starting at absolute positions ``pos0`` (B,), against the
        full-length ``caches``, writing the chunk's K/V in place at (cache
        row, position); positions past the end are dropped. ``rows`` (B,)
        names the cache row of each input row (default: row b is cache row
        b), so an engine runs a few slots' chunks on its own cache with no
        copy of it. Earlier chunks (and any prefix-cache restore) must
        already occupy positions [0, pos0). Exact only for all-global
        (padding-safe) models; the serving engine gates on that. Returns
        (logits of every position, or None when ``logits`` is false,
        caches)."""
        c = inputs.shape[1]
        dev = inputs.device
        write = _write_index(pos0, c, caches[0]["k"].shape[2], rows, dev)
        positions = pos0.to(dev)[:, None] + torch.arange(c, device=dev)
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        h, _ = _run(params, h, positions, "chunk", caches=caches,
                    write=write, rows=None if rows is None else rows.to(dev))
        if not logits:
            return None, caches
        return L.unembed_apply(params["embed"], cfg, h), caches

    def decode_verify(params, caches, candidate_tokens, pos):
        """Speculative-decode verify: score ``candidate_tokens`` (B, K+1),
        the last emitted token followed by K draft proposals, in one batched
        call, returning logits for every candidate position. Rides the chunk
        machinery: candidate K/V is written at absolute positions
        ``pos..pos+K`` and chunk attention masks ``kpos <= qpos``, so
        positions past the accepted prefix hold stale K/V that later steps
        never attend and overwrite in place: rejection is a per-slot
        position rollback, not a cache rollback."""
        return prefill_chunk(params, caches, candidate_tokens, pos)

    def init_cache(batch: int, max_seq: int, cache_device=None):
        """Zeroed caches on ``cache_device`` (default: the model's device);
        real tensors, not broadcast views, since decode writes them in
        place."""
        return [init_sub_cache(cfg, n_super, batch, max_seq, dtype,
                               cache_device or device) for _ in subs]

    kernel_ops = (flash_ops,) + ((gmm_ops,) if any(
        s.ffn == "moe" for s in subs) else ())
    return SimpleNamespace(cfg=cfg, device=device, init=init, prefill=prefill,
                           decode=decode, prefill_chunk=prefill_chunk,
                           decode_verify=decode_verify, init_cache=init_cache,
                           n_super=n_super, subs=subs, kernel_ops=kernel_ops)


def _build_ssm(cfg: ModelConfig, device: torch.device):
    """The pure Mamba2 stack: ``num_layers`` x (norm, Mamba2 block), run as
    a Python loop over the stacked layers."""
    dtype = _dtype(cfg)
    n = cfg.num_layers

    def init(gen: Optional[torch.Generator] = None):
        """Random params with the JAX package's distributions, drawn from
        ``gen`` (default: seed 0 on the model's device)."""
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        return {"embed": L.embed_init(gen, cfg, dtype),
                "mamba": {"ln": torch.zeros((n, cfg.d_model), dtype=dtype,
                                            device=gen.device),
                          "mamba": M.mamba_init(gen, cfg, dtype, n)},
                "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                          device=gen.device)}

    def prefill(params, inputs, max_seq: int):
        """inputs: (B, S) token ids. Returns (logits of the last position,
        caches)."""
        if inputs.shape[1] > max_seq:
            raise ValueError(f"prompt of {inputs.shape[1]} tokens exceeds "
                             f"max_seq={max_seq}")
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        per_layer = []
        for i in range(n):
            p = _layer(params["mamba"], i)
            out, cache = M.mamba_prefill(
                p["mamba"], cfg, L.rms_norm(h, p["ln"], cfg.norm_eps))
            h = h + out
            per_layer.append(cache)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        caches = {"conv": {k: torch.stack([c["conv"][k] for c in per_layer])
                           for k in ("x", "B", "C")},
                  "ssd": torch.stack([c["ssd"] for c in per_layer])}
        return L.unembed_apply(params["embed"], cfg, h[:, -1:]), caches

    def decode(params, caches, inputs, pos):
        """inputs: (B, 1) token ids (``pos`` is unused: the state carries
        the position). Writes the new states into ``caches`` in place;
        returns (logits, caches)."""
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        for i in range(n):
            p = _layer(params["mamba"], i)
            cache = _layer(caches, i)
            out, new = M.mamba_decode(
                p["mamba"], cfg, L.rms_norm(h, p["ln"], cfg.norm_eps), cache)
            h = h + out
            for k in ("x", "B", "C"):
                cache["conv"][k].copy_(new["conv"][k])
            cache["ssd"].copy_(new["ssd"])
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return L.unembed_apply(params["embed"], cfg, h), caches

    def init_cache(batch: int, max_seq: int, cache_device=None):
        """Zeroed caches on ``cache_device`` (default: the model's device);
        real tensors, since decode writes them in place."""
        return M.init_mamba_cache(cfg, batch, dtype, cache_device or device,
                                  n)

    return SimpleNamespace(cfg=cfg, device=device, init=init, prefill=prefill,
                           decode=decode, init_cache=init_cache,
                           kernel_ops=(ssd_ops,))
