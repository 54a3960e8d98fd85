"""Serving engine: KV-cache slots and continuous batching, ported from the
JAX package's ``repro.serving.engine`` (its plain path).

Each ``ServingEngine`` is one replica on one device. ``start()`` runs the
decode loop on a background thread that admits waiting requests through a
single *padded batched prefill* (one ``prefill`` call for every newly
admitted slot) and then runs one fused single-token decode over all active
slots per step; ``stop()`` signals it through a ``threading.Event``. The
synchronous ``run_until_idle`` path is kept for deterministic use (tests,
oracles).

Not ported yet: chunked prefill, the prefix cache, speculative decoding,
rolling caches and the flight recorder (the JAX engine's ``chunk_tokens``,
``prefix_cache``, ``speculate``/``draft`` and ``recorder`` arguments).
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

from repro_torch.device import resolve_device
from repro_torch.models.params import to_device
from repro_torch.observability.tracing import NULL_TRACE, next_rid


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
    # NULL_TRACE: every trace call site is an unconditional no-op method on
    # the shared singleton (per-request tracing comes with the recorder)
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


def _padding_safe(model, max_seq: int) -> bool:
    """Right-padded batched prefill is exact only when every sub-layer is
    global attention at this ``max_seq``: decode overwrites cache position
    ``pos`` before attending, so pad garbage beyond the prompt is never read.
    Rolling caches, recurrent SSM state and MoE capacity routing all need
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
    raises when there is none). Params move there (no copy when they are
    already there) and the KV cache is allocated there."""

    # prompt lengths pad up to a multiple of this in a batched prefill
    prefill_bucket = 16

    def __init__(self, model, params, *, slots: int = 4, max_seq: int = 256,
                 name: str = "engine0", monitor=None, device=None):
        self.device = resolve_device(device)
        if not _padding_safe(model, max_seq):
            raise NotImplementedError(
                "exact per-length prefill groups (rolling/SSM/MoE models) "
                "are not ported yet")
        if self.device.type == "cuda":
            # build the kernels now: the first prefill must not stall the
            # decode loop past the replica health timeout
            from repro_torch.kernels.flash_attention.ops import load_library
            load_library()
        self.model = model
        self.cfg = model.cfg
        self.params = to_device(params, self.device)
        self.slots = slots
        self.max_seq = max_seq
        self.name = name
        self.monitor = monitor
        self.cache = model.init_cache(slots, max_seq, self.device)
        self.pos = np.zeros((slots,), np.int32) - 1    # -1: free slot
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.metrics = {"requests": 0, "tokens": 0, "prefills": 0,
                        "prefill_requests": 0, "decode_steps": 0,
                        "completed": 0}
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

    def _prefill_group(self, grp: List[Request]):
        """One prefill call for a group of newly admitted requests, padded to
        ``slots`` rows and a bucket-multiple length, then scattered into the
        requests' slots of the engine cache in place (JAX:
        ``full.at[:, slots].set(new[:, rows])``; axis 0 is n_super, axis 1
        the slot)."""
        maxlen = self._bucket_len(max(len(r.tokens) for r in grp))
        toks = np.zeros((self.slots, maxlen), np.int32)
        for j, r in enumerate(grp):
            r.trace.open("prefill", mode="batched", group=len(grp))
            toks[j, :len(r.tokens)] = r.tokens
        _, grp_cache = self.model.prefill(self.params, self._tensor(toks),
                                          self.max_seq)
        slots_idx = self._tensor(np.asarray([r.slot for r in grp]))
        for full, new in zip(self.cache, grp_cache):
            for key in ("k", "v"):
                full[key][:, slots_idx] = new[key][:, :len(grp)]
        self.metrics["prefills"] += 1
        self.metrics["prefill_requests"] += len(grp)
        for r in grp:
            self.pos[r.slot] = len(r.tokens) - 1
            self.active[r.slot] = r
            r.trace.close("prefill", tokens=len(r.tokens))
            r.trace.open("decode")

    def _admit(self):
        """Fill free slots from the queue with one padded batched prefill."""
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
            batch.append(r)
        if not batch:
            return
        try:
            self._prefill_group(batch)
        except Exception as exc:
            # fail just this group: the requests were already pulled off the
            # queue, so an unhandled raise would strand them
            for r in batch:
                r.slot = -1
                if not r.future.done():
                    r.future.set_exception(exc)
            if self.monitor is not None:
                self.monitor.log(self.name, "prefill_error",
                                 error=repr(exc), requests=len(batch))

    # -- decode step -------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """Admit waiting requests, then one fused decode step for all active
        slots. Returns #active."""
        self._admit()
        active = [i for i in range(self.slots) if self.active[i] is not None]
        if not active:
            return 0
        self._decode_step(active)
        if self.monitor is not None:
            self.monitor.gauge(self.name, "queue_depth", self.load)
        return len(active)

    def _emit_token(self, i: int, r: Request, tok: int, now: float) -> bool:
        """Record one generated token for slot ``i`` — the single source of
        the stop conditions (budget, EOS, sequence limit). Returns done."""
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
            if not r.future.done():
                r.future.set_result(np.asarray(r.generated, np.int32))
            self.active[i] = None
            self.pos[i] = -1
        return done

    def _decode_step(self, active: List[int]):
        """One fused single-token decode over ``active``. A request's first
        token comes from decoding its last prompt token at pos len-1, as in
        the JAX engine (prefill returns caches only)."""
        toks = np.zeros((self.slots, 1), np.int32)
        # idle rows decode a scratch token at position max_seq-1 (never
        # written or attended by a real request: admission requires
        # len+1 <= max_seq and decode stops at pos+1 >= max_seq)
        pos = np.full((self.slots,), self.max_seq - 1, np.int32)
        for i in active:
            r = self.active[i]
            toks[i, 0] = (r.generated[-1] if r.generated
                          else int(r.tokens[-1]))
            pos[i] = max(int(self.pos[i]), 0)
        logits, self.cache = self.model.decode(
            self.params, self.cache, self._tensor(toks), self._tensor(pos))
        # the one host sync of the step
        next_tokens = torch.argmax(logits[:, 0, :self.cfg.vocab_size],
                                   dim=-1).cpu().numpy()
        self.metrics["decode_steps"] += 1
        now = time.perf_counter()
        for i in active:
            self._emit_token(i, self.active[i], int(next_tokens[i]), now)

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
        for r in out:
            r.reset_for_retry()
        return out

    @property
    def load(self) -> int:
        return self.queue.qsize() + sum(a is not None for a in self.active)

    @property
    def device_set(self) -> frozenset:
        """Devices this replica's params actually live on (read from the
        tensors, not the requested device)."""
        return frozenset({self.params["embed"]["tok"].device})


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
