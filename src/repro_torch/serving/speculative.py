"""Speculative decoding: draft-model multi-token decode for the slotted loop,
ported from the JAX package's ``repro.serving.speculative``.

A cheap **draft** proposes ``k`` candidate tokens per slot, the target model
scores all of them in a single batched ``decode_verify`` call, and the
engine accepts the longest prefix of candidates that matches the target's
own greedy choices, emitting the accepted tokens plus one corrected (or
bonus) token per step: between 1 and k+1 tokens per verify call, and the
same tokens as non-speculative greedy decode.

``NgramDraft``
    Prompt-lookup decoding: propose the continuation that followed the most
    recent earlier occurrence of the context's trailing n-gram (falling back
    to repeating the last token). No parameters, no device state.

``ModelDraft``
    A small same-tokenizer transformer built with ``build_model`` from a
    shrunken copy of the target config. It keeps its own per-slot KV cache
    on the replica's device and proposes by running k+1 greedy decode steps
    per engine step. The extra step feeds the last proposal back in, so
    after the engine's accept/reject the draft cache is already correct up
    to the newest emitted token.

Rejection needs no cache surgery: verify writes candidate K/V at absolute
positions ``pos..pos+k``, decode/chunk attention masks ``kpos <= pos``, and
the next step's writes land on exactly the positions a rejection
invalidated, so rolling back is just *not advancing* the slot's position.

A draft implements ``propose(items, k) -> np.ndarray (len(items), k)
int32``, where ``items`` lists ``(slot, request)`` for every slot decoding
this step. Proposals are guesses: a bad row costs wasted verify compute,
never correctness. Drafts are per-engine objects; a failed-over request
re-syncs on the successor's draft from its context alone.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import to_device
from repro_torch.serving.engine import _leaf_pairs, _padding_safe


def _context(request) -> np.ndarray:
    toks = np.asarray(request.tokens, np.int64)
    if request.generated:
        return np.concatenate(
            [toks, np.asarray(request.generated, np.int64)])
    return toks


class NgramDraft:
    """Prompt-lookup draft: continuation after the most recent earlier
    occurrence of the trailing n-gram (n = ``max_ngram`` down to 1), padded
    by repeating the last proposed token; repeat-last when nothing matches.
    Stateless and parameter-free."""

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram

    def propose(self, items: List[tuple], k: int) -> np.ndarray:
        out = np.zeros((len(items), k), np.int32)
        for row, (_slot, r) in enumerate(items):
            out[row] = self._lookup(_context(r), k)
        return out

    def _lookup(self, ctx: np.ndarray, k: int) -> np.ndarray:
        n_ctx = len(ctx)
        for n in range(min(self.max_ngram, n_ctx - 1), 0, -1):
            pat = ctx[n_ctx - n:]
            # most recent occurrence strictly before the trailing pattern,
            # one vectorised window comparison per n
            windows = np.lib.stride_tricks.sliding_window_view(
                ctx[:n_ctx - 1], n)                # starts 0 .. L-1-n
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            if len(hits):
                s = int(hits[-1])
                cont = ctx[s + n:s + n + k]        # s+n <= L-1: never empty
                prop = np.empty((k,), np.int64)
                prop[:len(cont)] = cont
                prop[len(cont):] = cont[-1]
                return prop.astype(np.int32)
        return np.full((k,), ctx[-1], np.int32)


class ModelDraft:
    """Small same-tokenizer transformer draft with its own slotted KV cache
    on ``device`` (the replica's). ``syncs`` counts the batch-1 prefills
    that rebuild a slot's cache (each launches the prefill's kernels)."""

    # prompt lengths pad up to a multiple of this in a sync prefill
    prefill_bucket = 16

    def __init__(self, model, params, *, slots: int, max_seq: int,
                 device=None, name: str = "draft"):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.params = to_device(params, self.device)
        self.slots = slots
        self.max_seq = max_seq
        self.name = name
        self.cache = model.init_cache(slots, max_seq, self.device)
        self.syncs = 0
        # per-slot sync state: the request the slot's cache was built for and
        # the token ids written at positions [0, len(written)); the correct-KV
        # prefix at propose time is the longest match between ``written`` and
        # the live context (accepted drafts match; rejected ones diverge and
        # are overwritten in place)
        self._written: List[Optional[np.ndarray]] = [None] * slots
        self._req: List[object] = [None] * slots

    # -- sync --------------------------------------------------------------
    def _bucket_len(self, n: int) -> int:
        b = self.prefill_bucket
        return min(self.max_seq, ((n + b - 1) // b) * b)

    def _sync_slot(self, slot: int, r, ctx: np.ndarray):
        """(Re)build the slot's draft cache from the context: needed on a
        slot's first decode step, after slot reuse, and after failover.
        Padded positions past the context get K/V too, masked (kpos <= pos)
        until real tokens overwrite them."""
        n = len(ctx)
        toks = np.zeros((1, self._bucket_len(n)), np.int64)
        toks[0, :n] = ctx
        _, row = self.model.prefill(
            self.params, torch.as_tensor(toks).to(self.device), self.max_seq)
        for full, new in _leaf_pairs(self.cache, row):
            full[:, slot] = new[:, 0]
        self.syncs += 1
        self._written[slot] = np.asarray(ctx, np.int64)
        self._req[slot] = r

    def _synced_len(self, slot: int, r, ctx: np.ndarray) -> int:
        if self._req[slot] is not r or self._written[slot] is None:
            return -1
        w = self._written[slot]
        n = min(len(w), len(ctx))
        eq = w[:n] == ctx[:n]
        return int(n if eq.all() else np.argmin(eq))

    # -- propose -----------------------------------------------------------
    @torch.inference_mode()
    def propose(self, items: List[tuple], k: int) -> np.ndarray:
        ctxs = {}
        for slot, r in items:
            ctx = ctxs[slot] = _context(r)
            # the draft needs correct KV for every context token but the
            # last (the last is this propose call's first input)
            if self._synced_len(slot, r, ctx) < len(ctx) - 1:
                self._sync_slot(slot, r, ctx)
        # idle rows decode token 0 at max_seq-1 throughout; a slot's row
        # steps one position a step, past the cache's end near the sequence
        # limit (those writes are dropped, as JAX drops them)
        toks = np.zeros((self.slots, 1), np.int64)
        pos = np.full((self.slots,), self.max_seq - 1, np.int64)
        live = np.zeros((self.slots, 1), bool)
        for slot, _r in items:
            toks[slot, 0] = int(ctxs[slot][-1])
            pos[slot] = len(ctxs[slot]) - 1
            live[slot] = True
        toks = torch.as_tensor(toks).to(self.device)
        live = torch.as_tensor(live).to(self.device)
        vocab = self.cfg.vocab_size
        steps = []
        # k+1 greedy steps: the extra step writes the k-th proposal's K/V,
        # so a fully accepted chain leaves the cache already in sync. The
        # greedy tokens stay on the device and feed the next step; one copy
        # to the host at the end
        for j in range(k + 1):
            logits, self.cache = self.model.decode(
                self.params, self.cache, toks, torch.tensor(pos))
            nxt = torch.argmax(logits[:, 0, :vocab], dim=-1)
            if j < k:
                steps.append(nxt)
            toks = torch.where(live, nxt[:, None], toks)
            pos[[slot for slot, _r in items]] += 1
        props = torch.stack(steps, dim=1).cpu().numpy()   # (slots, k)
        out = np.zeros((len(items), k), np.int32)
        for row, (slot, _r) in enumerate(items):
            out[row] = props[slot]
            self._written[slot] = np.concatenate(
                [ctxs[slot], out[row].astype(np.int64)])
        return out


# ---------------------------------------------------------------------------
# Draft construction
# ---------------------------------------------------------------------------


def supports_speculation(model, max_seq: int) -> bool:
    """Whether the engine could speculate on this model at this ``max_seq``
    (the gate ``ServingEngine`` applies: padding-safe, all-global attention,
    and a verify mode). Builders consult it before constructing a draft, so
    an SSM or MoE service allocates no draft the engine would never use."""
    return _padding_safe(model, max_seq) and \
        getattr(model, "decode_verify", None) is not None


def draft_model_config(cfg):
    """A same-tokenizer shrunken transformer config for ``ModelDraft``:
    half the width, two layers, all-global attention, two heads over one KV
    head."""
    head_dim = cfg.head_dim or 16
    d_model = max(32, (cfg.d_model // 2 // head_dim) * head_dim or head_dim)
    return dataclasses.replace(
        cfg, name=cfg.name + "-draft", family="dense",
        num_layers=min(2, max(1, cfg.num_layers // 2)),
        d_model=d_model, num_heads=2, num_kv_heads=1, head_dim=head_dim,
        d_ff=max(64, cfg.d_ff // 2 if cfg.d_ff else 64),
        moe=None, ssm=None, local_global_pattern=None, sliding_window=0,
        shared_attn_every=0, attn_softcap=0.0,
        remat_policy="none", use_pallas=False)


_DRAFT_MODEL_CACHE: dict = {}
_DRAFT_MODEL_LOCK = threading.Lock()


def draft_model_for(cfg, device=None) -> Tuple[object, dict]:
    """(model, params) of the draft for target ``cfg`` on ``device``, built
    once and shared by every replica there. Params are drawn from a
    ``torch.Generator`` seeded with 1. The key is the draft's whole config
    (not only the target's name), so targets of one name at other depths or
    dtypes get their own draft."""
    from repro_torch.models.model import build_model

    device = resolve_device(device)
    dcfg = draft_model_config(cfg)
    key = (dcfg, device)
    with _DRAFT_MODEL_LOCK:
        ent = _DRAFT_MODEL_CACHE.get(key)
        if ent is None:
            model = build_model(dcfg, device=device)
            params = model.init(torch.Generator(device=device).manual_seed(1))
            ent = _DRAFT_MODEL_CACHE[key] = (model, params)
    return ent


def build_draft(kind: str, target_cfg, *, slots: int, max_seq: int,
                device=None, name: str = "draft"):
    """Draft factory for one engine replica. ``kind``: ``"ngram"`` (prompt
    lookup, no params) or ``"model"`` (small transformer on ``device``)."""
    if kind == "ngram":
        return NgramDraft()
    if kind == "model":
        model, params = draft_model_for(target_cfg, device)
        return ModelDraft(model, params, slots=slots, max_seq=max_seq,
                          device=device, name=name)
    raise ValueError(f"unknown draft kind {kind!r} "
                     f"(expected 'model' or 'ngram')")
