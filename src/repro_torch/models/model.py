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

Ported: every token-input config: dense and MoE transformers with global
or sliding-window attention, QKV bias, QK norm, post norms and softcaps
(``yi-9b``, ``qwen2-72b``, ``gemma2-27b``, ``gemma3-12b``,
``granite-moe-1b-a400m``, ``llama4``), pure SSM (``mamba2-370m``) and the
hybrid (``zamba2-1.2b``), served and trained. Training (``forward``) runs
each transformer super-block, and each Mamba2 layer, under
``cfg.remat_policy`` (``"full"`` recomputes it in the backward,
``"minimal"`` saves its matmul outputs, ``"none"`` saves everything);
attention through the flash op's forward and backward kernels, MoE through
the grouped matmul's, Mamba2 through the SSD op's. The hybrid's shared
attention+MLP block runs once after each segment, not remat'd, as in JAX.
``split_blocks`` gives the per-layer views a train step differentiates. The
``embeddings`` input mode (``musicgen``, ``internvl2``) raises
``NotImplementedError`` (ROADMAP A.7c). ``model.kernel_ops`` lists the
kernel modules the model's path launches.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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
    """Features of ``cfg`` outside the ported slice (the ``embeddings``
    input mode, ROADMAP A.7c)."""
    checks = {
        f"family {cfg.family!r}": cfg.family not in ("dense", "moe", "ssm",
                                                     "hybrid"),
        f"input_mode {cfg.input_mode!r}": cfg.input_mode != "tokens",
    }
    return [name for name, bad in checks.items() if bad]


# ---------------------------------------------------------------------------
# Attention/FFN sub-layer
# ---------------------------------------------------------------------------


def sub_init(gen, cfg: ModelConfig, sub: Sub, dtype, n_super: int):
    """One sub-layer's params, stacked on a leading ``n_super`` axis (none
    when ``n_super`` is 0, as the hybrid's shared block)."""
    p = {"ln1": L.zeros(gen, (cfg.d_model,), dtype, n_super),
         "attn": L.attn_init(gen, cfg, dtype, n_super),
         "ln2": L.zeros(gen, (cfg.d_model,), dtype, n_super)}
    if sub.ffn == "dense":
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, n_super)
    else:
        p["moe"] = MOE.moe_init(gen, cfg, dtype, n_super)
    if cfg.post_norm:
        p["post_ln1"] = L.zeros(gen, (cfg.d_model,), dtype, n_super)
        p["post_ln2"] = L.zeros(gen, (cfg.d_model,), dtype, n_super)
    return p


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


def _decode_attn_rolling(cfg, q, k_cache, v_cache, pos):
    """Rolling-cache decode attention. Slot s holds absolute position
    pos - ((pos - s) mod W), valid iff >= 0; every valid slot lies inside
    the window."""
    slots = torch.arange(k_cache.shape[1], device=q.device)
    kpos = pos[:, None] - torch.remainder(pos[:, None] - slots[None, :],
                                          k_cache.shape[1])
    return L.masked_attention(cfg, q, k_cache, v_cache, (kpos >= 0)[:, None])


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
              write=None, rows=None):
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
    flash op's forward and backward kernels)."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, hn, positions, sub.theta)
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
    out = L.out_proj(attn, p["attn"]["wo"])
    if cfg.post_norm:
        out = L.rms_norm(out, p["post_ln1"], cfg.norm_eps)
    h = h + out
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    aux = None
    if sub.ffn == "dense":
        mo = L.mlp_apply(p["mlp"], hn)
    else:
        mo, aux = MOE.moe_apply(p["moe"], cfg, hn)
    if cfg.post_norm:
        mo = L.rms_norm(mo, p["post_ln2"], cfg.norm_eps)
    if mode == "train":
        return h + mo, (aux if aux is not None else
                        torch.zeros((), dtype=torch.float32, device=h.device))
    return h + mo, new_cache


def init_sub_cache(cfg, sub: Sub, n_super: int, batch: int, max_seq: int,
                   dtype, device):
    shape = (n_super, batch, _cache_len(sub, max_seq), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def check_trainable(cfg: ModelConfig):
    """Raise ``NotImplementedError`` naming ROADMAP A.7c for what the port
    cannot build or train yet (the ``embeddings`` input mode)."""
    missing = _unsupported(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port "
            f"serves and trains token inputs: dense, MoE, SSM and hybrid; "
            f"ROADMAP A.7c)")


def build_model(cfg: ModelConfig, device=None):
    """The model for ``cfg`` on ``device`` (default: the current CUDA
    device; raises when there is none)."""
    check_trainable(cfg)
    device = resolve_device(device)
    if cfg.family == "ssm":
        return _build_ssm(cfg, device)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg, device)
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
                "final_norm": L.zeros(gen, (cfg.d_model,), dtype)}

    def _run(params, h, positions, mode, caches=None, pos=None,
             max_seq=None, writes=None, rows=None):
        new_caches = [[] for _ in subs]
        for i in range(n_super):
            for j, sub in enumerate(subs):
                cs = _layer(caches[j], i) if caches is not None else None
                h, nc = sub_apply(_layer(params["blocks"][j], i), cfg, sub, h,
                                  positions, mode, cache=cs, pos=pos,
                                  max_seq=max_seq,
                                  write=None if writes is None else writes[j],
                                  rows=rows)
                new_caches[j].append(nc)
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
            h, a = sub_apply(bp, cfg, sub, h, positions, "train")
            aux = aux + a
        return h, aux

    def forward(params, inputs):
        """Train mode. inputs: (B, S) token ids at positions 0..S-1.
        Returns (logits (B, S, padded vocab) f32, aux): aux the summed MoE
        load-balance terms (f32 scalar; 0 for a dense model), both
        differentiable. Each super-block runs under ``cfg.remat_policy``.
        ``params`` may be stacked or ``split_blocks``'s form."""
        s = inputs.shape[1]
        positions = torch.arange(s, device=inputs.device)[None, :]
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        block = _remat(_train_block, cfg.remat_policy)
        for i in range(n_super):
            h, aux = block([_layer(bp, i) for bp in params["blocks"]], h, aux,
                           positions)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return L.unembed_apply(params["embed"], cfg, h), aux

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
        """inputs: (B, S) token ids. Returns (logits of the last position,
        caches of length ``max_seq``, or of the window where rolling)."""
        _check_prompt(inputs, max_seq)
        s = inputs.shape[1]
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
        max_seq, writes = _writes(caches, pos, 1, device=inputs.device)
        pos = pos.to(inputs.device)
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        h, _ = _run(params, h, pos[:, None], "decode", caches=caches,
                    pos=pos, max_seq=max_seq, writes=writes)
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
        (padding-safe) models; the serving engine gates on that, and a
        rolling cache raises ``ValueError``. Returns (logits of every
        position, or None when ``logits`` is false, caches)."""
        c = inputs.shape[1]
        dev = inputs.device
        max_seq, writes = _writes(caches, pos0, c, rows, dev)
        rolling = [j for j, s in enumerate(subs) if _rolling(s, max_seq)]
        if rolling:
            raise ValueError(f"{cfg.name}: chunked prefill needs global "
                             f"caches; subs {rolling} are rolling at "
                             f"max_seq={max_seq}")
        positions = pos0.to(dev)[:, None] + torch.arange(c, device=dev)
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        h, _ = _run(params, h, positions, "chunk", caches=caches,
                    writes=writes, rows=None if rows is None else rows.to(dev))
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
        return [init_sub_cache(cfg, sub, n_super, batch, max_seq, dtype,
                               cache_device or device) for sub in subs]

    kernel_ops = (flash_ops,) + ((gmm_ops,) if any(
        s.ffn == "moe" for s in subs) else ())
    return SimpleNamespace(cfg=cfg, device=device, init=init, forward=forward,
                           split_blocks=split_blocks, prefill=prefill,
                           decode=decode, prefill_chunk=prefill_chunk,
                           decode_verify=decode_verify, init_cache=init_cache,
                           n_super=n_super, subs=subs, kernel_ops=kernel_ops)


def _mamba_prefill(cfg, stacked, h, layers):
    """Prefill through the Mamba layers ``layers`` of a stacked {"ln",
    "mamba"} tree: (h, each layer's cache)."""
    caches = []
    for i in layers:
        p = _layer(stacked, i)
        out, cache = M.mamba_prefill(
            p["mamba"], cfg, L.rms_norm(h, p["ln"], cfg.norm_eps))
        h = h + out
        caches.append(cache)
    return h, caches


def _mamba_decode(cfg, stacked, caches, h, layers):
    """One decode step through the Mamba layers ``layers``, writing their
    new states into the stacked ``caches`` in place."""
    for i in layers:
        p = _layer(stacked, i)
        cache = _layer(caches, i)
        out, new = M.mamba_decode(
            p["mamba"], cfg, L.rms_norm(h, p["ln"], cfg.norm_eps), cache)
        h = h + out
        for k in ("x", "B", "C"):
            cache["conv"][k].copy_(new["conv"][k])
        cache["ssd"].copy_(new["ssd"])
    return h


def _stack_mamba(per_layer):
    return {"conv": {k: torch.stack([c["conv"][k] for c in per_layer])
                     for k in ("x", "B", "C")},
            "ssd": torch.stack([c["ssd"] for c in per_layer])}


def _mamba_params(gen, cfg, dtype, n: int):
    return {"ln": L.zeros(gen, (cfg.d_model,), dtype, n),
            "mamba": M.mamba_init(gen, cfg, dtype, n)}


def _mamba_train_layer(cfg):
    """One Mamba2 layer of the train path, ``(p, h) -> h + mamba(norm(h))``
    for a layer's ``{"ln", "mamba"}`` params, under ``cfg.remat_policy``
    (JAX remats its scan body, one layer)."""
    def layer(p, h):
        return h + M.mamba_block(p["mamba"], cfg,
                                 L.rms_norm(h, p["ln"], cfg.norm_eps))
    return _remat(layer, cfg.remat_policy)


def _split_mamba(params, n: int):
    """``params`` with the stacked ``"mamba"`` tree split into a list of its
    ``n`` layers (views of the stacked tensors, no copies): ``forward``
    takes either form, and a train step differentiates the split form's
    leaves, so each layer's gradient is its own tensor rather than a
    scatter into the whole stack."""
    return {**params, "mamba": [_layer(params["mamba"], i) for i in range(n)]}


def _check_prompt(inputs, max_seq: int):
    if inputs.shape[1] > max_seq:
        raise ValueError(f"prompt of {inputs.shape[1]} tokens exceeds "
                         f"max_seq={max_seq}")


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
                "mamba": _mamba_params(gen, cfg, dtype, n),
                "final_norm": L.zeros(gen, (cfg.d_model,), dtype)}

    def prefill(params, inputs, max_seq: int):
        """inputs: (B, S) token ids. Returns (logits of the last position,
        caches)."""
        _check_prompt(inputs, max_seq)
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        h, per_layer = _mamba_prefill(cfg, params["mamba"], h, range(n))
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return (L.unembed_apply(params["embed"], cfg, h[:, -1:]),
                _stack_mamba(per_layer))

    def decode(params, caches, inputs, pos):
        """inputs: (B, 1) token ids (``pos`` is unused: the state carries
        the position). Writes the new states into ``caches`` in place;
        returns (logits, caches)."""
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        h = _mamba_decode(cfg, params["mamba"], caches, h, range(n))
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return L.unembed_apply(params["embed"], cfg, h), caches

    def init_cache(batch: int, max_seq: int, cache_device=None):
        """Zeroed caches on ``cache_device`` (default: the model's device);
        real tensors, since decode writes them in place."""
        return M.init_mamba_cache(cfg, batch, dtype, cache_device or device,
                                  n)

    layer = _mamba_train_layer(cfg)

    def forward(params, inputs):
        """Train mode. inputs: (B, S) token ids. Returns (logits (B, S,
        padded vocab) f32, a zero f32 aux), differentiable. Each layer runs
        under ``cfg.remat_policy``; ``params`` may be stacked or
        ``split_blocks``'s form."""
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        for i in range(n):
            h = layer(_layer(params["mamba"], i), h)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return (L.unembed_apply(params["embed"], cfg, h),
                torch.zeros((), dtype=torch.float32, device=h.device))

    return SimpleNamespace(cfg=cfg, device=device, init=init, forward=forward,
                           split_blocks=lambda p: _split_mamba(p, n),
                           prefill=prefill, decode=decode,
                           init_cache=init_cache, kernel_ops=(ssd_ops,))


def _hybrid_layout(cfg):
    """(layers a segment, shared-block applications, trailing layers)."""
    seg = cfg.shared_attn_every
    n_apps = cfg.num_layers // seg
    return seg, n_apps, cfg.num_layers - n_apps * seg


def _build_hybrid(cfg: ModelConfig, device: torch.device):
    """Zamba2: ``n_apps`` segments of ``shared_attn_every`` Mamba2 layers,
    each followed by the one shared attention+MLP sub-layer (global
    attention, its params unstacked as in JAX), then the trailing Mamba2
    layers. Caches: (the Mamba stack on the layer axis, the shared block's
    ``{"k", "v"}`` stacked on its applications). No ``prefill_chunk`` or
    ``decode_verify``, as in JAX."""
    dtype = _dtype(cfg)
    n = cfg.num_layers
    seg, n_apps, _ = _hybrid_layout(cfg)
    shared = Sub(0, cfg.rope_theta, "dense")
    segments = [range(a * seg, (a + 1) * seg) for a in range(n_apps)]
    trailing = range(n_apps * seg, n)

    def init(gen: Optional[torch.Generator] = None):
        """Random params with the JAX package's distributions, drawn from
        ``gen`` (default: seed 0 on the model's device)."""
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        return {"embed": L.embed_init(gen, cfg, dtype),
                "mamba": _mamba_params(gen, cfg, dtype, n),
                "shared": sub_init(gen, cfg, shared, dtype, 0),
                "final_norm": L.zeros(gen, (cfg.d_model,), dtype)}

    def prefill(params, inputs, max_seq: int):
        """inputs: (B, S) token ids. Returns (logits of the last position,
        caches)."""
        _check_prompt(inputs, max_seq)
        positions = torch.arange(inputs.shape[1], device=inputs.device)[None]
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        m_caches, s_caches = [], []
        for layers in segments:
            h, cs = _mamba_prefill(cfg, params["mamba"], h, layers)
            m_caches += cs
            h, sc = sub_apply(params["shared"], cfg, shared, h, positions,
                              "prefill", max_seq=max_seq)
            s_caches.append(sc)
        h, cs = _mamba_prefill(cfg, params["mamba"], h, trailing)
        m_caches += cs
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        caches = (_stack_mamba(m_caches),
                  {k: torch.stack([c[k] for c in s_caches])
                   for k in ("k", "v")})
        return L.unembed_apply(params["embed"], cfg, h[:, -1:]), caches

    def decode(params, caches, inputs, pos):
        """inputs: (B, 1) token ids at positions ``pos`` (B,). Writes the
        new states and K/V into ``caches`` in place; returns (logits,
        caches)."""
        m_caches, s_caches = caches
        max_seq = s_caches["k"].shape[2]
        write = _write_index(pos, 1, max_seq, device=inputs.device)
        pos = pos.to(inputs.device)
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        for a, layers in enumerate(segments):
            h = _mamba_decode(cfg, params["mamba"], m_caches, h, layers)
            h, _ = sub_apply(params["shared"], cfg, shared, h, pos[:, None],
                             "decode", cache=_layer(s_caches, a), pos=pos,
                             max_seq=max_seq, write=write)
        h = _mamba_decode(cfg, params["mamba"], m_caches, h, trailing)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return L.unembed_apply(params["embed"], cfg, h), caches

    def init_cache(batch: int, max_seq: int, cache_device=None):
        """Zeroed caches on ``cache_device`` (default: the model's device);
        real tensors, since decode writes them in place."""
        dev = cache_device or device
        return (M.init_mamba_cache(cfg, batch, dtype, dev, n),
                init_sub_cache(cfg, shared, n_apps, batch, max_seq, dtype,
                               dev))

    layer = _mamba_train_layer(cfg)

    def forward(params, inputs):
        """Train mode, as JAX's: each segment's Mamba2 layers (each under
        ``cfg.remat_policy``), then the shared block in ``train`` mode, not
        remat'd (its gradient sums over its applications); the trailing
        layers; the final norm. inputs: (B, S) token ids. Returns (logits
        (B, S, padded vocab) f32, a zero f32 aux). ``params`` may be
        stacked or ``split_blocks``'s form."""
        positions = torch.arange(inputs.shape[1], device=inputs.device)[None]
        h = L.embed_apply(params["embed"], inputs, cfg.d_model)
        for layers in segments:
            for i in layers:
                h = layer(_layer(params["mamba"], i), h)
            h, _ = sub_apply(params["shared"], cfg, shared, h, positions,
                             "train")
        for i in trailing:
            h = layer(_layer(params["mamba"], i), h)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return (L.unembed_apply(params["embed"], cfg, h),
                torch.zeros((), dtype=torch.float32, device=h.device))

    return SimpleNamespace(cfg=cfg, device=device, init=init, forward=forward,
                           split_blocks=lambda p: _split_mamba(p, n),
                           prefill=prefill, decode=decode,
                           init_cache=init_cache,
                           kernel_ops=(ssd_ops, flash_ops))
