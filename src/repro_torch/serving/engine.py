"""Serving engine: KV-cache slots and continuous batching, ported from the
JAX package's ``repro.serving.engine`` (its plain path).

Each ``ServingEngine`` is one replica on one device. ``start()`` runs the
decode loop on a background thread that admits waiting requests and then
runs one fused single-token decode over all active slots per step;
``stop()`` signals it through a ``threading.Event``. Admission is a single
*padded batched prefill* (one ``prefill`` call for every newly admitted
slot) where padding is exact (all-global attention), and one exact
prefill call per prompt length, with no pad rows, for SSM and MoE models.
The synchronous ``run_until_idle`` path is kept for deterministic use
(tests, oracles).

With ``chunk_tokens`` set (padding-safe models only), long prompts are
*chunk-prefilled*: the prompt enters its slot's cache in chunk-sized pieces,
one chunk per step, written in place, so a long admission never stalls
tokens for requests already decoding. Chunk boundaries feed an optional
cross-request ``PrefixCache``: requests sharing a prompt head restore the
deepest cached boundary and compute only their tail. With ``speculate`` = k
and a draft, each step verifies k draft tokens per slot in one
``decode_verify`` call and emits 1..k+1 tokens, the plain path's tokens.
The chunk path computes no logits; verify's greedy argmax runs on the
device, so only (slots, k+1) token ids reach the host.

With a ``recorder`` (the flight recorder), every request carries a
``TraceContext`` from submit to completion and is recorded when it
completes; span times are host times. ``EdgeRouter`` is the least-loaded
dispatch in front of a ``ReplicaSet`` or a list of engines.

Rolling caches (a sliding-window sub whose window is shorter than
``max_seq``) and the hybrid's (Mamba state, shared-block K/V) pair scatter
into slots leaf by leaf like any other cache; both models prefill in exact
per-length groups and decline chunking and speculation, as in JAX.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceShare, resolve_device
from repro_torch.models.params import to_device
from repro_torch.observability.tracing import (NULL_TRACE, TraceContext,
                                               next_rid)
from repro_torch.serving.prefix_cache import _tree_map


@dataclasses.dataclass
class Request:
    tokens: np.ndarray          # prompt (prompt_len,)
    max_new_tokens: int = 16
    eos_id: int = -1            # -1: never stop early
    future: Future = dataclasses.field(default_factory=Future)
    slot: int = -1
    generated: list = dataclasses.field(default_factory=list)
    submit_t: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    rid: int = dataclasses.field(default_factory=next_rid)
    # NULL_TRACE when the flight recorder is off: every trace call site is
    # an unconditional no-op method on the shared singleton
    trace: object = NULL_TRACE

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t

    retries: int = 0

    def reset_for_retry(self):
        """Failover: forget partial progress; greedy decode is deterministic,
        so a fresh run on another replica produces the same tokens."""
        self.slot = -1
        self.generated = []
        self.first_token_t = None
        self.retries += 1
        self.trace.close("prefill")
        self.trace.close("decode")
        self.trace.open("queue_wait", retry=self.retries)


def _leaf_pairs(full, new):
    """(full, new) leaf pairs of two cache trees of one structure."""
    if isinstance(full, dict):
        for k in full:
            yield from _leaf_pairs(full[k], new[k])
    elif isinstance(full, (list, tuple)):
        for f, n in zip(full, new, strict=True):
            yield from _leaf_pairs(f, n)
    else:
        yield full, new


def _padding_safe(model, max_seq: int) -> bool:
    """Right-padded batched prefill is exact only when every sub-layer is
    global attention at this ``max_seq``: decode overwrites cache position
    ``pos`` before attending, so pad garbage beyond the prompt is never read.
    Rolling caches (they keep the last W positions of the padded length, so
    pad rows would evict real ones), recurrent SSM state (it absorbs pad
    tokens; the hybrid has no ``subs``) and MoE capacity routing all need
    exact per-length groups with no pad rows instead."""
    subs = getattr(model, "subs", None)
    if subs is None:
        return False
    if any(s.ffn == "moe" for s in subs):
        return False
    return all(s.window == 0 or s.window >= max_seq for s in subs)


class ServingEngine:
    """Slotted continuous batching over a fixed decode batch on one device.

    ``device`` is this replica's device (default: the current CUDA device;
    raises when there is none), a ``torch.device`` or a ``DeviceShare`` of
    one. Params move there (no copy when they are already there) and the
    KV cache is allocated there. ``devices`` is the slice of the device
    pool the replica holds (default: ``device`` alone)."""

    # prompt lengths pad up to a multiple of this in a batched prefill
    prefill_bucket = 16

    def __init__(self, model, params, *, slots: int = 4, max_seq: int = 256,
                 name: str = "engine0", monitor=None, device=None,
                 devices=(), chunk_tokens: Optional[int] = None,
                 prefix_cache=None, speculate: int = 0, draft=None,
                 recorder=None):
        self.device = resolve_device(device)
        # the pool entries this replica occupies (placements, scale-up)
        self.devices = tuple(devices) or (
            device if isinstance(device, DeviceShare) else self.device,)
        if self.device.type == "cuda":
            # build every kernel of the model's path now: the first prefill
            # must not stall the decode loop past the replica health timeout
            for op in model.kernel_ops:
                op.load_library()
        self._pad_ok = _padding_safe(model, max_seq)
        self.model = model
        self.cfg = model.cfg
        self.params = to_device(params, self.device)
        self.slots = slots
        self.max_seq = max_seq
        self.name = name
        self.monitor = monitor
        # flight recorder: an attached recorder implies tracing — requests
        # get a TraceContext at submit and a JSONL record at completion
        self.recorder = recorder
        self.chunk_tokens = int(chunk_tokens) if chunk_tokens else 0
        self.prefix_cache = prefix_cache
        self.speculate = int(speculate) if speculate else 0
        self.draft = draft
        self.cache = model.init_cache(slots, max_seq, self.device)
        self.pos = np.zeros((slots,), np.int32) - 1    # -1: free slot
        self.active: List[Optional[Request]] = [None] * slots
        # slot -> next prompt position to prefill; a slot present here holds
        # an admitted request still being chunk-prefilled (it is excluded
        # from decode until its prompt is fully in cache)
        self._prefilling: dict = {}
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.metrics = {"requests": 0, "tokens": 0, "prefills": 0,
                        "prefill_requests": 0, "decode_steps": 0,
                        "completed": 0, "prefill_chunks": 0,
                        "prefill_tokens": 0, "prefix_hit_tokens": 0,
                        "prefill_chunk_batches": 0, "spec_steps": 0,
                        "spec_proposed": 0, "spec_accepted": 0,
                        "spec_emitted": 0}
        # chunked prefill is exact only where padded prefill is (all-global
        # attention: chunk K/V writes land at absolute positions and the
        # chunk mask is position-based); SSM/MoE models keep the
        # whole-prompt path
        has_chunk = getattr(model, "prefill_chunk", None) is not None
        self._chunk_ok = bool(self.chunk_tokens) and self._pad_ok and \
            has_chunk
        if self.chunk_tokens and not self._chunk_ok and monitor is not None:
            monitor.log(name, "chunked_prefill_unsupported",
                        reason="model is not padding-safe (rolling/SSM/MoE)"
                        if has_chunk else "model has no prefill_chunk")
        # speculative decode rides the same gate (verify writes candidate
        # K/V at absolute positions and relies on the position-based chunk
        # mask); models without a verify mode degrade to the plain fused
        # decode, and a missing draft means nothing to verify
        has_verify = getattr(model, "decode_verify", None) is not None
        self._spec_ok = bool(self.speculate) and self._pad_ok and \
            self.draft is not None and has_verify
        if self.speculate and not self._spec_ok and monitor is not None:
            if not has_verify:
                reason = "model has no decode_verify (rolling/SSM/hybrid)"
            elif not self._pad_ok:
                reason = "model is not padding-safe (rolling/SSM/MoE)"
            else:
                reason = "no draft engine configured"
            monitor.log(name, "speculative_unsupported", reason=reason,
                        speculate=self.speculate)
        # -- async decode loop state --------------------------------------
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._killed = False
        self.heartbeat = time.monotonic()

    # -- request API ------------------------------------------------------
    def submit_request(self, tokens, max_new_tokens=16, eos_id=-1) -> Request:
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or not len(tokens):
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {tokens.shape}")
        if len(tokens) + 1 > self.max_seq:
            raise ValueError(f"prompt of {len(tokens)} tokens leaves no room "
                             f"to generate within max_seq={self.max_seq}")
        r = Request(tokens, max_new_tokens, eos_id)
        if self.recorder is not None:
            r.trace = TraceContext("request", rid=r.rid,
                                   prompt_len=len(tokens),
                                   max_new_tokens=max_new_tokens)
            r.trace.open("queue_wait")
        self.queue.put(r)
        self.metrics["requests"] += 1
        self._wake.set()
        return r

    def submit(self, tokens, max_new_tokens=16, eos_id=-1) -> Future:
        return self.submit_request(tokens, max_new_tokens, eos_id).future

    # -- batched admission -------------------------------------------------
    def _bucket_len(self, n: int) -> int:
        b = self.prefill_bucket
        return min(self.max_seq, ((n + b - 1) // b) * b)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long).to(self.device)

    @staticmethod
    def _host(a: np.ndarray) -> torch.Tensor:
        """Positions stay on the host: the model works out its write index
        from them there and copies them to the device itself."""
        return torch.tensor(a, dtype=torch.long)

    def _prefill_group(self, grp: List[Request]):
        """One prefill call for a group of newly admitted requests, then a
        scatter into the requests' slots of the engine cache in place, leaf
        by leaf (JAX: ``full.at[:, slots].set(new[:, rows])``; axis 0 is the
        layer or super-block stack, axis 1 the slot). Where padding is safe
        the call is padded to ``slots`` rows and a bucket-multiple length;
        otherwise the group is one prompt length and runs exact, with no pad
        rows: pad tokens would enter SSM state, and pad rows would take MoE
        expert capacity and shift real tokens' routing."""
        maxlen = max(len(r.tokens) for r in grp)
        rows = self.slots if self._pad_ok else len(grp)
        if self._pad_ok:
            maxlen = self._bucket_len(maxlen)
        toks = np.zeros((rows, maxlen), np.int32)
        for j, r in enumerate(grp):
            r.trace.open("prefill", mode="batched", group=len(grp))
            toks[j, :len(r.tokens)] = r.tokens
        _, grp_cache = self.model.prefill(self.params, self._tensor(toks),
                                          self.max_seq)
        slots_idx = self._tensor(np.asarray([r.slot for r in grp]))
        for full, new in _leaf_pairs(self.cache, grp_cache):
            full[:, slots_idx] = new[:, :len(grp)]
        self.metrics["prefills"] += 1
        self.metrics["prefill_requests"] += len(grp)
        for r in grp:
            self.pos[r.slot] = len(r.tokens) - 1
            self.active[r.slot] = r
            r.trace.close("prefill", tokens=len(r.tokens))
            r.trace.open("decode")

    def _admit(self):
        """Fill free slots from the queue: long prompts (and any prompt when
        a prefix cache may hold its head) enter the chunk-wise prefill
        state; the rest take one padded batched prefill, or one exact
        prefill per prompt length where padding is unsafe."""
        batch: List[Request] = []
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            try:
                r = self.queue.get_nowait()
            except queue.Empty:
                break
            r.slot = slot
            r.trace.close("queue_wait", replica=self.name, slot=slot)
            if self.monitor is not None:
                self.monitor.gauge(self.name, "queue_wait_s",
                                   time.perf_counter() - r.submit_t)
            # chunked admission for prompts longer than one chunk, or ones a
            # prefix cache could serve (>= one chunk boundary); sub-chunk
            # prompts can neither hit nor seed the cache, so they keep the
            # padded batched prefill
            if self._chunk_ok and (
                    len(r.tokens) > self.chunk_tokens
                    or (self.prefix_cache is not None
                        and len(r.tokens) >= self.chunk_tokens)):
                self._admit_chunked(r)
            else:
                batch.append(r)
        if not batch:
            return
        if self._pad_ok:
            groups = [batch]
        else:                   # SSM/MoE: exact lengths, no pad rows
            by_len: dict = {}
            for r in batch:
                by_len.setdefault(len(r.tokens), []).append(r)
            groups = list(by_len.values())
        for grp in groups:
            try:
                self._prefill_group(grp)
            except Exception as exc:
                # fail just this group: the requests were already pulled off
                # the queue, so an unhandled raise would strand them
                for r in grp:
                    r.slot = -1
                    if not r.future.done():
                        r.future.set_exception(exc)
                if self.monitor is not None:
                    self.monitor.log(self.name, "prefill_error",
                                     error=repr(exc), requests=len(grp))

    # -- prefix cache: restore and extract, in place ----------------------
    def _pc_restore(self, entry, slot: int):
        """Copy a prefix-cache entry (leaves (n_super, L, KV, hd) on the
        host) into ``slot`` at positions [0, L) of the engine's cache, on
        the engine's device and in its dtype. Raises on an entry of another
        structure or shape."""
        for full, ent in _leaf_pairs(self.cache, entry):
            want = (full.shape[0], ent.shape[1]) + tuple(full.shape[3:])
            if ent.ndim != 4 or tuple(ent.shape) != want \
                    or ent.shape[1] > full.shape[2]:
                raise ValueError(f"prefix entry leaf {tuple(ent.shape)} does "
                                 f"not fit a cache leaf {tuple(full.shape)}")
            full[:, slot, :ent.shape[1]] = ent

    def _pc_extract(self, slot: int, start: int, length: int):
        """Positions [start, start+length) of ``slot``, copied to the host
        (a copy even on a CPU engine: the live cache is written later)."""
        return _tree_map(
            lambda x: x[:, slot, start:start + length].to("cpu", copy=True),
            self.cache)

    # -- chunked prefill ---------------------------------------------------
    def _admit_chunked(self, r: Request):
        """Admit a request into the chunk-wise prefill state, restoring the
        deepest prefix-cache boundary first so only the uncovered tail is
        computed."""
        start = 0
        span = r.trace.open("prefill", mode="chunked")
        if self.prefix_cache is not None:
            covered, entry = self.prefix_cache.lookup(r.tokens)
            if covered:
                try:
                    self._pc_restore(entry, r.slot)
                    start = covered
                    self.metrics["prefix_hit_tokens"] += covered
                    span.annotate(prefix_hit_tokens=covered)
                    r.trace.event("prefix_cache_hit", tokens=covered)
                except Exception as exc:
                    # a bad entry (e.g. adopted from an incompatible pool)
                    # degrades to a miss: an unhandled raise would strand
                    # the already-dequeued request
                    start = 0
                    r.trace.event("prefix_restore_error")
                    if self.monitor is not None:
                        self.monitor.log(self.name, "prefix_restore_error",
                                         error=repr(exc), covered=covered)
        self.active[r.slot] = r
        if start >= len(r.tokens):
            # the whole prompt was cached: straight to decode (the first
            # decode step recomputes the last prompt token at pos len-1,
            # overwriting its cached K/V with identical values)
            self.pos[r.slot] = len(r.tokens) - 1
            self.metrics["prefill_requests"] += 1
            r.trace.close("prefill", tokens=len(r.tokens))
            r.trace.open("decode")
        else:
            self.pos[r.slot] = -1           # not decoding yet
            self._prefilling[r.slot] = start

    def _prefill_step(self):
        """Advance every chunk-prefilling slot by one chunk, in one
        ``prefill_chunk`` call whose rows are those slots (no pad rows: an
        eager call needs no fixed shape). Runs before the decode step, so
        long prompts trickle in between decode steps instead of stalling
        already-admitted requests. ``prefill_chunk_batches`` counts the
        calls that carry two or more slots."""
        c = self.chunk_tokens
        rows = []
        toks = np.zeros((len(self._prefilling), c), np.int32)
        for j, (slot, start) in enumerate(self._prefilling.items()):
            r = self.active[slot]
            end = min(start + c, len(r.tokens))
            # a final partial chunk is padded; its pad K/V lands past the
            # prompt (masked until decode overwrites it) or past the cache's
            # end (dropped)
            toks[j, :end - start] = r.tokens[start:end]
            rows.append((slot, start, end, r))
        try:
            self.model.prefill_chunk(
                self.params, self.cache, self._tensor(toks),
                self._host(np.asarray([s for _, s, _, _ in rows])),
                rows=self._host(np.asarray([slot for slot, *_ in rows])),
                logits=False)
        except Exception as exc:
            # the call failed as a unit: every participating request fails
            for slot, _start, _end, r in rows:
                self._prefilling.pop(slot, None)
                self.active[slot] = None
                self.pos[slot] = -1
                if not r.future.done():
                    r.future.set_exception(exc)
            if self.monitor is not None:
                self.monitor.log(self.name, "prefill_error",
                                 error=repr(exc), requests=len(rows))
            return
        if len(rows) >= 2:
            self.metrics["prefill_chunk_batches"] += 1
        for slot, start, end, r in rows:
            self._after_chunk(slot, start, end, r)

    def _after_chunk(self, slot: int, start: int, end: int, r: Request):
        """Shared post-chunk bookkeeping: metrics, prefix-cache insertion at
        chunk boundaries, and the prefilling -> decoding transition."""
        c = self.chunk_tokens
        self.metrics["prefill_chunks"] += 1
        self.metrics["prefill_tokens"] += end - start
        r.trace.event("chunk", start=start, end=end)
        if self.prefix_cache is not None and end % c == 0 \
                and not self.prefix_cache.contains(r.tokens[:end]):
            # the cache stores per-chunk slices: offer only this chunk's
            # [end-c, end) positions (the trie chain supplies the rest on
            # restore)
            self.prefix_cache.insert(r.tokens[:end],
                                     self._pc_extract(slot, end - c, c))
        if end >= len(r.tokens):
            del self._prefilling[slot]
            self.pos[slot] = len(r.tokens) - 1       # ready for decode
            self.metrics["prefill_requests"] += 1
            r.trace.close("prefill", tokens=len(r.tokens))
            r.trace.open("decode")
        else:
            self._prefilling[slot] = end

    @property
    def prefill_backlog(self) -> int:
        """Prompt tokens admitted-or-queued but not yet in a KV cache: the
        admission pressure signal (queue depth alone under-counts a backlog
        of long prompts). Read from other threads while the decode loop
        mutates: list(deque) / dict(dict) are C-level snapshots, and a
        racing slot reuse only skews the gauge briefly."""
        queued = sum(len(r.tokens) for r in list(self.queue.queue))
        chunking = 0
        for s, p in dict(self._prefilling).items():
            r = self.active[s]
            if r is not None:
                chunking += len(r.tokens) - p
        return queued + chunking

    # -- decode step -------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """Admit waiting requests, advance the chunk-prefilling slots, then
        one fused decode (or speculative verify) step for all decoding
        slots. Returns #active."""
        self._admit()
        if self._prefilling:
            self._prefill_step()
        active = [i for i in range(self.slots)
                  if self.active[i] is not None and i not in self._prefilling]
        if self.monitor is not None and (self._prefilling
                                         or self.queue.qsize()):
            self.monitor.gauge(self.name, "prefill_backlog",
                               self.prefill_backlog)
        if not active:
            return len(self._prefilling)
        if self._spec_ok:
            self._spec_step(active)
        else:
            self._decode_step(active)
        if self.monitor is not None:
            self.monitor.gauge(self.name, "queue_depth", self.load)
        return len(active) + len(self._prefilling)

    def _emit_token(self, i: int, r: Request, tok: int, now: float) -> bool:
        """Record one generated token for slot ``i`` — the single source of
        the stop conditions (budget, EOS, sequence limit), shared by the
        plain decode step and the speculative emission loop so the two
        paths cannot disagree on when a request completes. Returns done."""
        if not r.generated:
            r.first_token_t = now
            if self.monitor is not None:
                self.monitor.gauge(self.name, "ttft_s", r.ttft_s)
        r.generated.append(tok)
        self.metrics["tokens"] += 1
        self.pos[i] += 1
        done = (len(r.generated) >= r.max_new_tokens or tok == r.eos_id
                or self.pos[i] + 1 >= self.max_seq)
        if done:
            r.done_t = now
            self.metrics["completed"] += 1
            if self.monitor is not None:
                self.monitor.gauge(self.name, "latency_s", r.latency_s)
            r.trace.close("decode", tokens=len(r.generated))
            if self.recorder is not None:
                self.recorder.record(r, self)
            if not r.future.done():
                r.future.set_result(np.asarray(r.generated, np.int32))
            self.active[i] = None
            self.pos[i] = -1
        return done

    def _step_inputs(self, active: List[int], width: int):
        """Tokens (slots, width) and positions of a decode or verify step:
        column 0 holds each active slot's last token. Idle and
        still-prefilling rows decode a scratch token at position max_seq-1
        (never written or attended by a real request: admission requires
        len+1 <= max_seq and decode stops at pos+1 >= max_seq), so the fused
        step cannot clobber a half-prefilled slot's cache; an idle row's SSM
        state is overwritten when its slot is next admitted, and idle rows
        route through the MoE experts like real rows, as in JAX."""
        toks = np.zeros((self.slots, width), np.int32)
        pos = np.full((self.slots,), self.max_seq - 1, np.int32)
        for i in active:
            r = self.active[i]
            toks[i, 0] = (r.generated[-1] if r.generated
                          else int(r.tokens[-1]))
            pos[i] = max(int(self.pos[i]), 0)
        return toks, pos

    def _decode_step(self, active: List[int]):
        """One fused single-token decode over ``active``. A request's first
        token comes from decoding its last prompt token at pos len-1, as in
        the JAX engine (prefill returns caches only)."""
        toks, pos = self._step_inputs(active, 1)
        logits, self.cache = self.model.decode(
            self.params, self.cache, self._tensor(toks), self._host(pos))
        # the one host sync of the step
        next_tokens = torch.argmax(logits[:, 0, :self.cfg.vocab_size],
                                   dim=-1).cpu().numpy()
        self.metrics["decode_steps"] += 1
        now = time.perf_counter()
        for i in active:
            self._emit_token(i, self.active[i], int(next_tokens[i]), now)

    def _spec_step(self, active: List[int]):
        """One speculative verify step over ``active``: the draft proposes
        k tokens per slot, ``decode_verify`` scores every candidate
        position in one batched call (greedy argmax on the device), and each
        slot emits the longest matching prefix plus one corrected (or, on
        full acceptance, bonus) token: 1..k+1 tokens per step, the plain
        decode path's tokens. Idle and still-prefilling rows ride along as
        scratch rows at position max_seq-1; candidate positions past the
        cache's end are dropped, as in the JAX engine's scatter."""
        k = self.speculate
        items = [(i, self.active[i]) for i in active]
        props = np.asarray(self.draft.propose(items, k), np.int32)
        toks, pos = self._step_inputs(active, k + 1)
        for row, (i, _r) in enumerate(items):
            toks[i, 1:] = props[row]
        logits, self.cache = self.model.decode_verify(
            self.params, self.cache, self._tensor(toks), self._host(pos))
        greedy = torch.argmax(logits[..., :self.cfg.vocab_size],
                              dim=-1).cpu().numpy()       # (slots, k+1)
        self.metrics["decode_steps"] += 1
        self.metrics["spec_steps"] += 1
        now = time.perf_counter()
        accepted = emitted = 0
        for i in active:
            r = self.active[i]
            m = 0       # accepted draft prefix: d_j must equal the target's
            while m < k and toks[i, m + 1] == greedy[i, m]:   # own greedy
                m += 1                                        # choice g_j
            accepted += m
            r.trace.event("verify", proposed=k, accepted=m)
            # emit g_0..g_m: the m accepted candidates plus the correction
            # (m < k) or bonus (m == k) token; the stop conditions run per
            # token, so EOS / budget / seq-limit truncate mid-chain exactly
            # where the non-speculative loop would stop
            for j in range(m + 1):
                emitted += 1
                if self._emit_token(i, r, int(greedy[i, j]), now):
                    break
        self.metrics["spec_proposed"] += len(active) * k
        self.metrics["spec_accepted"] += accepted
        self.metrics["spec_emitted"] += emitted
        if self.monitor is not None:
            self.monitor.gauge(self.name, "spec_accept_rate",
                               accepted / (len(active) * k))
            self.monitor.gauge(self.name, "spec_tokens_per_step",
                               emitted / len(active))

    # -- synchronous loop (tests / oracles) --------------------------------
    def run_until_idle(self, max_steps: int = 10_000):
        if self.running:
            raise RuntimeError("run_until_idle on a started engine")
        steps = 0
        while (not self.queue.empty() or any(a is not None
                                             for a in self.active)):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop did not drain")
        return steps

    # -- async decode loop -------------------------------------------------
    def start(self):
        if self.running:
            return self
        self._stop.clear()
        self._killed = False
        self.heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.name}-decode",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        # the current CUDA device is per thread: pin this replica's
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            if self._killed:        # simulated container crash: loop dies,
                return              # heartbeat freezes, requests strand
            self.heartbeat = time.monotonic()
            try:
                n = self.step()
            except Exception as exc:
                # a poisoned request must not kill the replica: fail
                # everything currently on this engine and keep serving
                self._fail_inflight(exc)
                n = 0
            self.heartbeat = time.monotonic()
            if n == 0:
                self._wake.wait(timeout=0.005)
                self._wake.clear()

    def _fail_inflight(self, exc: Exception):
        """Fail the requests in active slots (a decode error affects exactly
        those); queued requests keep their chance."""
        reqs = []
        for i in range(self.slots):
            if self.active[i] is not None:
                reqs.append(self.active[i])
            self.active[i] = None
            self.pos[i] = -1
        self._prefilling.clear()
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)
        if self.monitor is not None:
            self.monitor.log(self.name, "step_error", error=repr(exc),
                             failed_requests=len(reqs))

    def stop(self, timeout: float = 10.0) -> bool:
        """Signal the decode loop and join it. Returns False if the thread
        is still running after ``timeout`` — the caller must NOT harvest
        until a later stop() succeeds."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                return False
        self._thread = None
        return True

    def kill(self):
        """Simulate a container crash: the decode loop exits without
        cleanup, health goes red, in-flight requests are stranded until a
        ReplicaSet reschedules them."""
        self._killed = True
        self._wake.set()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def healthy(self) -> bool:
        """True iff the engine can make progress on new work: not killed,
        not stop()ped, and (if started) the decode loop is alive."""
        if self._killed or self._stop.is_set():
            return False
        if self._thread is not None:
            return self._thread.is_alive()
        return True

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until queue+slots are empty (async engines only)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.load == 0:
                return True
            if not self.running and not self._stop.is_set() \
                    and self._thread is not None:
                return False        # loop died with work pending
            time.sleep(0.002)
        return False

    def harvest_requests(self) -> List[Request]:
        """Strip all incomplete requests (queued + in-flight) off this
        engine, resetting their progress so they can be rescheduled. Call
        only after the decode loop has exited."""
        if self.running:
            raise RuntimeError("harvest from a live decode loop")
        out: List[Request] = []
        while True:
            try:
                out.append(self.queue.get_nowait())
            except queue.Empty:
                break
        for i in range(self.slots):
            r = self.active[i]
            if r is not None and not r.future.done():
                out.append(r)
            self.active[i] = None
            self.pos[i] = -1
        self._prefilling.clear()
        for r in out:
            r.reset_for_retry()
        return out

    @property
    def load(self) -> int:
        return self.queue.qsize() + sum(a is not None for a in self.active)


class EdgeRouter:
    """Traefik analogue: least-loaded dispatch over healthy engine replicas.

    Accepts either a plain engine list or a lifecycle-managed
    ``repro_torch.serving.replica.ReplicaSet`` (duck-typed via
    ``.engines``). ``lm-server`` routes over a ReplicaSet, which picks the
    replica itself; the engine-list mode keeps the JAX ``EdgeRouter``'s
    API for callers that hold bare engines."""

    def __init__(self, engines):
        self._source = engines if hasattr(engines, "engines") else None
        self._engines = [] if self._source else list(engines)
        if not (self._engines or self._source):
            raise ValueError("EdgeRouter needs a ReplicaSet or at least one "
                             "engine")

    @property
    def engines(self) -> List[ServingEngine]:
        # always re-read from the ReplicaSet: scale_to/failover rebind its
        # list, so a stored alias would go stale
        return self._source.engines if self._source else self._engines

    def _pool(self) -> List[ServingEngine]:
        healthy = [e for e in self.engines if e.healthy()]
        if not healthy:
            raise RuntimeError("no healthy serving replicas")
        return healthy

    def submit_request(self, tokens, **kw) -> Request:
        if self._source is not None:
            # the ReplicaSet must choose-and-enqueue under its own lock so
            # the request can't land on an engine after its final harvest
            return self._source.submit_request(tokens, **kw)
        eng = min(self._pool(), key=lambda e: e.load)
        return eng.submit_request(tokens, **kw)

    def submit(self, tokens, **kw) -> Future:
        return self.submit_request(tokens, **kw).future

    def drain(self, timeout: float = 120.0):
        if self._source is not None:
            # ReplicaSet: failover may move work between engines mid-drain,
            # so wait on the aggregate instead of per-engine queues
            if not self._source.wait_all(timeout):
                raise RuntimeError("replica set did not drain")
            return
        for e in self.engines:      # every engine — a dead one must not be
            if e.running:           # silently skipped with queued requests
                if not e.wait_idle(timeout):
                    raise RuntimeError(f"{e.name} did not drain")
            elif e.healthy():
                e.run_until_idle()
            elif e.load:
                raise RuntimeError(f"{e.name} is dead with {e.load} "
                                   f"undrained requests")

    def metrics(self):
        return {e.name: dict(e.metrics) for e in self.engines}


@torch.inference_mode()
def greedy_generate(model, params, prompt: np.ndarray, max_new_tokens: int,
                    max_seq: int) -> np.ndarray:
    """Reference generation: prefill + stepwise decode (oracle for tests).
    Runs on the device of ``params``."""
    device = params["embed"]["tok"].device
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                           device=device)[None, :]
    logits, cache = model.prefill(params, toks, max_seq)
    out = []
    last = int(torch.argmax(logits[0, -1, :model.cfg.vocab_size]))
    out.append(last)
    pos = len(prompt)
    for _ in range(max_new_tokens - 1):
        logits, cache = model.decode(
            params, cache, torch.tensor([[last]], device=device),
            torch.tensor([pos], device=device))
        last = int(torch.argmax(logits[0, 0, :model.cfg.vocab_size]))
        out.append(last)
        pos += 1
    return np.asarray(out, np.int32)
