"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each: the device; the build of every kernel from the
sources in this checkout (one nvcc per source, all started together,
sm_90a), with each kernel's tensor-core instruction count from
``cuobjdump -sass``; every kernel against its plain PyTorch version on the
card, and the backward kernels (flash attention's, the grouped matmul's dx
and dw, the SSD intra-chunk's four grids) against the plain backward at the
training shapes, in f32 and bf16 (SSD: f32, at the sweep, the tiling
edges, mamba2's decay range and the microbatches of train_mamba2 and
train_zamba2); kernel timings at the serving shapes beside their bound and
a library yardstick (the grouped matmul and SSD also with a cold L2), and
the backward kernels' at the training shapes beside the earlier design's
times, with one profiled call of each (its device kernels by name: the
bf16 grouped-matmul backward may launch only its dx and dw products, the
SSD backward only its four grids, each once, with their device ms at both
training shapes) and the flash backward's run-to-run spread of dQ (summed
by atomics; the SSD backward's two calls equal bit for bit); the build
requires warpgroup products (HGMMA) in the flash, grouped-matmul and SSD
backward kernels; the training path: yi-9b at full
width cut to 16 layers on one fixed 4 x 2048 batch (10 steps: finite and
falling losses, step ms, tokens/s, the model FLOPs' share of the bf16 peak,
peak memory, flash launches 2 x 16 a step under remat and backward
launches 16), yi-9b at depth 2 in f32 on the card against the CPU from the
same params (3 steps: losses and params), ``python -m
repro_torch.launch.train`` for granite-moe-1b-a400m at full width and
depth (10 steps in 2 microbatches, saved every 5, resumed for 5 more; the
restored state equal to the saved one leaf for leaf) and a VRE's
``lm-trainer`` on provider h100 across a destroy and re-instantiation;
mamba2-370m (2 layers) and zamba2-1.2b (one segment of 6 and the shared
block) in f32 on the card against the CPU (3 steps: losses, grad norms and
params); ``python -m repro_torch.launch.train`` for mamba2-370m at full
width and depth (8 x 2048 in 2 microbatches, 10 steps saved every 5,
resumed for 5, the restored state equal leaf for leaf) with one profiled
step; zamba2-1.2b at full width and depth on one fixed 4 x 2048 batch (10
steps) with one profiled step; each with exact forward and backward launch
counts; full-width (depth 2, float32) engine tokens against a reference for
yi-9b and mamba2-370m (the card's greedy oracle) and granite-moe-1b-a400m (the
same engine on the CPU), and for yi-9b with chunked prefill, the prefix
cache, speculative decoding (n-gram and model drafts, and a prompt that runs
into max_seq) and speculation with chunking; then yi-9b, granite-moe-1b-a400m
and mamba2-370m at full depth in bf16, each served through
``build_replicaset`` and ``run_load`` with the kernel launch counts of that
run, yi-9b also with chunked prefill and the prefix cache and with
speculation (n-gram and model drafts), and a breakdown of one prefill and
one decode step (for yi-9b also a batched chunk call, a verify step, a
prefix restore and a chunk extract). For yi-9b also the flight recorder and
the VRE lifecycle: a depth-2 float32 pool recording every request (each
record against the greedy oracle, the file replayed through a pool built
from its header at token parity 1.0); ``python -m repro_torch.cli`` init,
apply, status, serve --record, trace --json and destroy in this process at
full depth in bf16 (flash launches = 48 x the serve command's prefill
calls); the same serve unrecorded, side by side; and the recorded file
replayed in bf16 (its parity printed). Then elastic serving, the autoscaler,
the fleet arbiter and the telemetry plane on yi-9b over shares of the card
(``repro_torch.device.device_pool``): a depth-2 float32 VRE at (1, 1) over
2 shares resized to (2, 1) with requests in flight (carried and new
requests against the greedy oracle, the replicas on disjoint shares);
``cli serve --waves 2 --autoscale --force-resize --telemetry-port 0`` at
full depth in bf16 on the plain traffic, ``/metrics`` validated once a
wave; and ``run_fleet_scenario`` with 2 tenants over 4 shares, arbitrated
(its telemetry scraped throughout; cross-tenant prefix hits) and static,
each served run with its flash launches against 48 x its prefill calls
and its peak memory. Then the sliding-window and hybrid
families at full width: depth-cut float32 token checks against the greedy
oracle (gemma2 and qwen2 at 2 layers, gemma2 also with chunks of 256, the
prefix cache and speculate 4 in one engine; gemma3 at one super-block of 6
layers on prompts past its 1024 window, so the rolling caches wrap; zamba2
at 8 layers, one shared-block application), then gemma2-27b, gemma3-12b
(prompts of 1100-1900 tokens), qwen2-72b at 16 layers and zamba2-1.2b
served in bf16 as above, each freed before the next. Then flash attention
(both dtypes) and the SSD op against their plain versions again at every
shape the engine runs above launched that was not checked before (the
served 4-16 token prompts give flash (4, 16)), one line with every kernel's
numbers and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, and prints no result line, without a card, outside a full
checkout, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12      # dense TF32 tensor-core peak
H100_BYTES_PER_S = 3.35e12

# flash attention: the sweep of tests/test_kernels.py, (B, S, H, KV, D,
# window, softcap), and the serving prefill shapes at full width
SWEEP = [(2, 128, 4, 4, 32, 0, 0.0), (2, 192, 4, 2, 64, 0, 0.0),
         (2, 128, 4, 2, 32, 48, 0.0), (2, 128, 2, 2, 64, 0, 30.0),
         (2, 96, 8, 1, 32, 32, 50.0)]
YI_PREFILL = (4, 1024, 32, 4, 128, 0, 0.0)
GRANITE_ATTN = (1, 1024, 16, 8, 64, 0, 0.0)
# yi-9b's served prefill of 4-16 token prompts: 4 slots, one 16-token bucket
# (less than one q tile); every shape the served runs launch is checked
# again after them (section 7)
SERVED_PREFILL = (4, 16, 32, 4, 128, 0, 0.0)
# the served prefill shapes of the sliding-window and hybrid families, bf16:
# gemma2 (4 slots padded to 1024, softcap 50; its 4096 window is inactive
# at max_seq 2048), gemma3 at its longest served prompt (local subs with
# the 1024 window, the global sub), qwen2 and zamba2 (MHA at head dim 64)
FAMILY_PREFILL = {
    "gemma2-27b": [(4, 1024, 32, 16, 128, 4096, 50.0)],
    "gemma3-12b": [(1, 1900, 16, 8, 256, 1024, 0.0),
                   (1, 1900, 16, 8, 256, 0, 0.0)],
    "qwen2-72b": [(4, 1024, 64, 8, 128, 0, 0.0)],
    "zamba2-1.2b": [(1, 1024, 32, 32, 64, 0, 0.0)]}

# the bf16 kernel's edges: D = 16 and 256 with window and softcap, S off the
# q tile
FLASH_EDGES = [(2, 100, 4, 2, 16, 40, 30.0), (1, 200, 2, 1, 256, 64, 50.0),
               (2, 77, 4, 4, 128, 0, 20.0)]

# grouped matmul, (E, C, d, f): tests/test_kernels.py's sweep, then granite's
# expert products at a 1024-token prefill (C = 320) and a 4-slot decode
# step (C = 2): wi/wg (d -> f) and wo (f -> d)
GMM_SWEEP = [(2, 64, 64, 64), (4, 96, 160, 192), (8, 32, 128, 96)]
# the bf16 dispatch edges at granite's widths: C = 1, 2, 3, the streaming
# threshold (16) and one either side, ragged prefill capacities; and a
# streaming call ragged in d and f
GMM_EDGES = [(32, c, 1024, 512) for c in (1, 2, 3, 15, 16, 17, 80, 157)] + [
    (4, 5, 104, 72)]
L2_BYTES = 50 * 2**20         # H100 L2; cold timing rotates past it
GMM_PREFILL = (32, 320, 1024, 512)
GMM_PREFILL_WO = (32, 320, 512, 1024)
GMM_DECODE = (32, 2, 1024, 512)
GMM_DECODE_WO = (32, 2, 512, 1024)

# SSD, (b, s, nh, hd, ds, chunk): tests/test_kernels.py's sweep, mamba2-370m's
# 1024- and 256-token prefills, and a length off the chunk grid through the
# padded op
SSD_SWEEP = [(2, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
             (2, 128, 4, 32, 16, 64)]
SSD_PREFILL = (1, 1024, 32, 64, 128, 256)
SSD_PREFILL_256 = (1, 256, 32, 64, 128, 256)
# zamba2-1.2b's 1024-token prefill: d_inner 4096 over head dim 64, d_state 64
SSD_ZAMBA2 = (1, 1024, 64, 64, 64, 256)
SSD_RAGGED = (1, 1000, 32, 64, 128, 256)
# the tensor-core kernel's tiling edges: zamba2's d_state 64, a chunk off the
# 64-row tile, head dims 16 and 128 at d_state 128, three batches of 32
# heads, and d_state 7 (4-byte copies)
SSD_EDGES = [(1, 512, 32, 64, 64, 256), (2, 96, 4, 32, 16, 48),
             (1, 256, 4, 16, 128, 256), (1, 256, 4, 128, 128, 256),
             (3, 512, 32, 64, 128, 256), (1, 64, 2, 16, 7, 32)]
# mamba2's initial decay range, A = -linspace(1, 16, nh)
SSD_WIDE_DECAY = [SSD_PREFILL, (2, 96, 4, 32, 16, 48)]

# training: the flash backward at yi-9b's training shapes (train_yi9b's
# batch of 4 and a batch of 2), granite's, gemma2's softcap 50 with its
# 4096 window at S 1024, S off the 64-row tile, a window that bites,
# gemma3-12b's head dim 256 at S 2048 with its 1024 window and without; the
# grouped matmul's backward at granite's training capacity,
# _capacity(4 * 2048, 8, 32, 1.25) = 2560 (wi/wg, then wo), and at a
# capacity off the multiple of 8
YI_TRAIN_ATTN = (4, 2048, 32, 4, 128, 0, 0.0)      # train_yi9b's batch
GRANITE_TRAIN_ATTN = (4, 2048, 16, 8, 64, 0, 0.0)  # train_granite's microbatch
GEMMA3_TRAIN_ATTN = (1, 2048, 16, 8, 256, 1024, 0.0)  # gemma3-12b's local
GEMMA3_UNWINDOWED_ATTN = (1, 2048, 16, 8, 256, 0, 0.0)  # the same, no window
FLASH_BWD = [YI_TRAIN_ATTN, (2, 2048, 32, 4, 128, 0, 0.0), GRANITE_TRAIN_ATTN,
             (1, 1024, 32, 16, 128, 4096, 50.0),
             (2, 1000, 8, 2, 128, 0, 0.0), (1, 1000, 8, 4, 64, 256, 0.0),
             GEMMA3_TRAIN_ATTN, GEMMA3_UNWINDOWED_ATTN]
# q's scale in a softcap case: unit-scale inputs give scaled scores of about
# N(0, 1), where tanh(s / 50) * 50 is s to within 1%; at 8 (a power of two,
# exact in bf16) they reach a sizable share of the cap, and the plain
# backward without the softcap moves dq, dk and dv by several times the bf16
# tolerance
SOFTCAP_Q_SCALE = 8.0
GMM_BWD = [(32, 2560, 1024, 512), (32, 2560, 512, 1024), (32, 157, 1024, 512)]
# the backward kernels that must issue warpgroup products (HGMMA), by
# library: flash attention's one-pass kernel (each instantiation), the
# grouped matmul's dx and dw, and the SSD backward's four grids
SSD_BWD_GRIDS = {"bwd::bwd_prep_kernel": "prep: C.B^T, cumsums",
                 "bwd::bwd_dg_kernel": "over the heads: dG, P's sums, head "
                                       "term parts",
                 "bwd::bwd_head_kernel": "per head: dxdt, da",
                 "bwd::bwd_dbc_kernel": "dB, dC"}
WGMMA_KERNELS = {"flash_attention": ("bwd_wg::bwd_kernel",),
                 "grouped_matmul": ("gmm_dx_kernel", "gmm_dw_kernel"),
                 "ssd": tuple(SSD_BWD_GRIDS)}
# the earlier design's times of the backward kernels (the mma.sync flash
# backward, the grouped matmul on transposed copies, bf16; the SSD
# backward's four grids on the CUDA cores, f32, cold; ms, PERF.md's table,
# H100 80GB HBM3 at 700 W) beside this run's: flash attention's at
# train_yi9b's and train_granite's shapes, the grouped matmul's at
# granite's wi/wg and wo, the SSD backward's at the training microbatches
# of train_mamba2 and train_zamba2
EARLIER_MS = {(4, 2048, 32, 4, 128, 0, 0.0): 3.552,
              (4, 2048, 16, 8, 64, 0, 0.0): 1.073,
              (32, 2560, 1024, 512): 1.248, (32, 2560, 512, 1024): 0.901,
              (4, 2048, 32, 64, 128, 256): 1.353,
              (4, 2048, 64, 64, 64, 256): 2.241}
# train_yi9b: full width cut to 16 of 48 layers (all 48 need ~103 GB of bf16
# params and grads and f32 moments), one fixed 4 x 2048 batch
YI_TRAIN = dict(layers=16, batch=4, seq=2048, steps=10)
# train_granite: launch/train.py at full width and depth
GRANITE_TRAIN = ["--arch", "granite-moe-1b-a400m", "--global-batch", "8",
                 "--seq-len", "2048", "--microbatches", "2"]

# the SSD backward at the training microbatches of train_mamba2 (8 x 2048
# in 2 microbatches) and train_zamba2 (4 x 2048), each gradient within the
# forward's tolerance, its atol taken relative to the gradient's largest
# magnitude
MAMBA2_TRAIN_SSD = (4, 2048, 32, 64, 128, 256)
ZAMBA2_TRAIN_SSD = (4, 2048, 64, 64, 64, 256)
SSD_BWD_TOL = dict(atol_of_max=5e-4, rtol=5e-3)
# train_mamba2: launch/train.py at full width and depth; train_zamba2: full
# width and depth, one fixed batch
MAMBA2_TRAIN = ["--arch", "mamba2-370m", "--global-batch", "8",
                "--seq-len", "2048", "--microbatches", "2"]
ZAMBA2_TRAIN = dict(batch=4, seq=2048, steps=10)

SERVE = dict(replicas=1, slots=4, max_seq=2048)
LOAD = dict(requests=8, rate_rps=4.0, max_new_tokens=32, lo=256, hi=1025)
# yi-9b's chunk + prefix run: 256-token chunks, a 1 GiB prefix cache; four
# short prompts (batched prefill) and four on two shared 512-token heads
CHUNKED = dict(chunk_tokens=256, prefix_cache_mb=1024.0)
SHORT, HEAD, TAIL = (32, 201), 512, (128, 513)
# gemma3's long traffic: prompts past its 1024-token window
LONG = dict(lo=1100, hi=1901)
# events that fail the check wherever they are logged
FAULTS = ("prefix_restore_error", "prefill_error", "step_error")
# the fleet's arrival rate on the card (its driver's default, 400, sends a
# burst at once)
FLEET_RATE = 8.0


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. The
    device first spins (``torch.cuda._sleep``) while the host queues every
    call, so a call whose host side outlasts its kernel is timed by its
    kernel, not by the host; the spin doubles until the queue is ahead, and
    a reading the host still held back is a failure, not a time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 200_000 * iters        # cycles, ~0.1 ms a call at ~2 GHz
    for _ in range(8):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(spin)
        marks[1].record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if queued_ms < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / iters
        spin *= 2
    fail(f"timing: the host took {queued_ms:.3f} ms to queue {iters} calls, "
         f"longer than the device's longest spin")


def cold_ms(fn, sets, iters: int) -> float:
    """``cuda_ms`` of ``fn(s)`` over a rotation of ``sets`` whose total
    exceeds the L2, so each call finds its operand in device memory."""
    i = [0]

    def call():
        i[0] += 1
        return fn(sets[i[0] % len(sets)])
    return cuda_ms(call, iters)


def sass_mma_counts(lib: Path) -> dict:
    """Tensor-core instructions in each kernel of a built library, from
    ``cuobjdump -sass`` of the toolkit that built it: ``{"HMMA": n,
    "HGMMA": m}`` (``mma.sync`` and the warpgroup ``wgmma``) for each kernel,
    named by ``cu++filt`` without its parameters."""
    from repro_torch.kernels import _build
    tools = Path(_build.nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            found = re.search(r"\b(HG?MMA)\b", line)
            if found:
                counts[name][found.group(1)] += 1
    names = subprocess.run([str(tools / "cu++filt"), *counts],
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.splitlines()
    labels = [without_params(re.sub(r"^void |<unnamed>::|\(anonymous "
                                    r"namespace\)::", "", n)) for n in names]
    if len(set(labels)) != len(counts):
        fail(f"cu++filt named {len(set(labels))} of {len(counts)} kernels: "
             f"{labels}")
    return dict(zip(labels, counts.values()))


def without_params(name: str) -> str:
    """A demangled function name without its trailing parameter list (the
    template arguments may hold parentheses too, as in ``(int)128``)."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def host_us(fn, iters: int = 50) -> float:
    """Host time to issue one call of ``fn`` (no wait for the device), in
    microseconds: what a call costs a host-bound step."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def host_ms(fn, iters: int = 3) -> float:
    """Host time of ``fn`` to the end of its device work, after one warm
    call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def step_profile(fn, top: int = 12) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host ms, the summed
    device time of the kernels and copies on the card, and the ``top``
    kernels by device time (ms, calls). "not measured" where the profiler
    records no device activity or fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in events:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    except Exception as exc:          # a measurement aid, not a check
        return {"profile": f"not measured ({type(exc).__name__}: {exc})"}
    busy = sum(ms for ms, _ in by_name.values())
    if busy <= 0:
        return {"profile": "not measured (no device events)"}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"host_ms_profiled": host_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / host_ms),
            "top_kernels": [{"name": n[:120], "ms": ms, "calls": c}
                            for n, (ms, c) in ranked]}


def device_kernels(fn) -> dict:
    """The device kernels of one call of ``fn``, ``{name: (ms, calls)}``,
    from a profile with a warm-up step of its own; fails when the profiler
    records none."""
    from repro_torch.kernels.profiling import device_kernels as recorded
    got = recorded(fn)
    if not got:
        fail("the profiler recorded no device kernel")
    return got


def device_busy_ms(fn) -> float | str:
    """Device time of one call of ``fn`` after a warm one: the summed
    durations of the kernels and copies ``torch.profiler`` records on the
    card (one stream, so they do not overlap). "not measured" where the
    profiler records no device activity or fails."""
    try:
        fn()
    except Exception as exc:          # a measurement aid, not a check
        return f"not measured ({type(exc).__name__}: {exc})"
    prof = step_profile(fn)
    return prof.get("device_busy_ms", prof.get("profile"))


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time for the work: the larger of operations over the peak
    rate for their type and bytes over the memory rate, in ms."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bound_ms(b, s, h, kv, d, window, dtype) -> tuple[float, str]:
    """Causal attention: QK^T and PV on the unmasked (q, k) pairs (2 flops
    per multiply-add each); q, k, v read once and o written once."""
    qpos = np.arange(s)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, int)
    pairs = int(np.sum(qpos - lo + 1))
    flops = 4.0 * d * b * h * pairs
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    nbytes = b * s * (2 * h + 2 * kv) * d * torch.finfo(dtype).bits // 8
    return bound(flops, nbytes, peak)


def attention_pairs(s, window) -> int:
    """Unmasked (q, k) pairs of causal attention over S positions."""
    qpos = np.arange(s)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, int)
    return int(np.sum(qpos - lo + 1))


def attention_bwd_bound_ms(b, s, h, kv, d, window, dtype) -> tuple[float,
                                                                   str]:
    """The flash backward: the five products the gradient needs on the
    unmasked pairs (S = Q.K^T recomputed, dP = dO.V^T, dV, dK, dQ; 2 flops
    a multiply-add); q, k, v, o, dO and the f32 lse read once, dq, dk, dv
    written once."""
    flops = 10.0 * d * b * h * attention_pairs(s, window)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    width = torch.finfo(dtype).bits // 8
    nbytes = b * s * (4 * h + 4 * kv) * d * width + 4 * b * h * s
    return bound(flops, nbytes, peak)


def gmm_bwd_bound_ms(e, c, d, f, dtype) -> tuple[float, str]:
    """The grouped matmul's backward: dx = dy.w^T and dw = x^T.dy, 4 E C d
    f flops; x, w, dy read once, dx, dw written once."""
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    nbytes = (2 * e * c * d + 2 * e * d * f + e * c * f) * \
        torch.finfo(dtype).bits // 8
    return bound(4.0 * e * c * d * f, nbytes, peak)


def gmm_bound_ms(e, c, d, f, dtype) -> tuple[float, str]:
    """Grouped matmul: 2 E C d f flops; x and w read once, out written
    once."""
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    nbytes = (e * c * d + e * d * f + e * c * f) * torch.finfo(dtype).bits // 8
    return bound(2.0 * e * c * d * f, nbytes, peak)


def ssd_bound_ms(b, nh, nc, c, hd, ds, peak=H100_TF32_FLOPS,
                 passes=3) -> tuple[float, str]:
    """SSD intra-chunk, f32: the least work the function needs. C.B^T on
    the causal triangle once per (batch, chunk), since B and C are shared
    by every head; per head, the weighted triangle times xdt and the
    (ds x hd) state. a, xdt, B, C read once; y and S written once. By
    default for the kernel's instruction class, split TF32: three TF32
    products for each f32 one at the TF32 peak; ``peak=H100_F32_FLOPS,
    passes=1`` gives the bound on the CUDA cores."""
    pairs = c * (c + 1) // 2
    flops = (b * nc * 2.0 * pairs * ds
             + b * nh * nc * (2.0 * pairs * hd + 2.0 * c * ds * hd))
    nbytes = 4 * (b * nh * nc * c + 2 * b * nh * nc * c * hd
                  + 2 * b * nc * c * ds + b * nh * nc * ds * hd)
    return bound(passes * flops, nbytes, peak)


def ssd_bwd_bound_ms(b, nh, nc, c, hd, ds) -> tuple[float, str]:
    """The SSD intra-chunk backward, f32: the least work the gradient
    needs. C.B^T on the causal triangle once per (batch, chunk); per head
    dy.xdt^T and M^T.dy on the triangle, B.dS and xdt.dS^T; per (batch,
    chunk) dC = dG.B and dB = dG^T.C on the triangle. a, xdt, B, C, dy and
    dS read once; da, dxdt, dB and dC written once. In split TF32, the
    kernel's instruction class: three TF32 products for each f32 one at
    the TF32 peak."""
    pairs = c * (c + 1) // 2
    flops = (b * nc * 3 * 2.0 * pairs * ds
             + b * nh * nc * (4.0 * pairs * hd + 4.0 * c * ds * hd))
    nbytes = 4 * (2 * b * nh * nc * c + 3 * b * nh * nc * c * hd
                  + 4 * b * nc * c * ds + b * nh * nc * ds * hd)
    return bound(3 * flops, nbytes, H100_TF32_FLOPS)


def ssd_bwd_set_bytes(b, s, nh, hd, ds, ch) -> int:
    """Bytes of one set of the backward's inputs and outputs."""
    nc = s // ch
    return 4 * (2 * b * nh * s + 3 * b * nh * s * hd + 4 * b * s * ds
                + b * nh * nc * ds * hd)


def randn(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32) * scale).to(dtype)


def close(out, ref, tol):
    """(max abs error, within atol = rtol = tol everywhere)."""
    diff = (out.float() - ref.float()).abs()
    return float(diff.max()), bool((diff <= tol + tol * ref.float().abs())
                                   .all())


def ssd_inputs(b, s, nh, hd, ds, gen, wide_decay=False):
    """x, dt, A, B, C as the model forms them; ``wide_decay`` takes
    mamba2's initial A = -linspace(1, 16, nh)."""
    x = randn((b, s, nh, hd), torch.float32, gen, 0.3)
    dt = torch.nn.functional.softplus(randn((b, s, nh), torch.float32, gen))
    A = -(torch.linspace(1.0, 16.0, nh, device="cuda") if wide_decay else
          torch.exp(torch.linspace(0.0, 1.0, nh, device="cuda")))
    B = randn((b, s, ds), torch.float32, gen, 0.3)
    C = randn((b, s, ds), torch.float32, gen, 0.3)
    return x, dt, A, B, C


def ssd_kernel_inputs(x, dt, A, B, C, ch):
    """The intra-chunk kernel's inputs, as ``ssd_chunked`` forms them."""
    b, s, nh, hd = x.shape
    nc, ds = s // ch, B.shape[-1]
    dtc = dt.reshape(b, nc, ch, nh)
    a = (dtc * A).permute(0, 3, 1, 2).contiguous()
    xdt = (x.reshape(b, nc, ch, nh, hd) * dtc[..., None]).permute(
        0, 3, 1, 2, 4).contiguous()
    return a, xdt, B.reshape(b, nc, ch, ds), C.reshape(b, nc, ch, ds)


def ssd_set_bytes(b, s, nh, hd, ds, ch) -> int:
    """Bytes of one set of the kernel's inputs and outputs."""
    nc = s // ch
    return 4 * (b * nh * s + 2 * b * nh * s * hd + 2 * b * s * ds
                + b * nh * nc * ds * hd)


def model_flops(cfg, params, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (no recompute counted): 6 per
    token per weight of every product a token passes through (the tied
    unembedding included, the embedding lookup not; of an MoE layer's
    experts the top_k it is routed to) and three times each layer's causal
    attention products (forward, and the backward's two)."""
    def weights(tree, moe=False):
        n = 0
        for k, v in tree.items():
            if isinstance(v, dict):
                n += weights(v, moe or k == "moe")
            elif v.ndim >= 3:     # stacked matrices, not stacked norms
                active = moe and k in ("wi", "wg", "wo") and v.ndim == 4
                n += v.numel() * (cfg.moe.top_k / cfg.moe.num_experts
                                  if active else 1)
        return n
    w = sum(weights(bp) for bp in params["blocks"])
    w += params["embed"]["tok"].numel()
    attn = 3 * 4.0 * cfg.head_dim * cfg.num_heads * attention_pairs(seq, 0) \
        * cfg.num_layers
    return 6.0 * w * tokens + attn * tokens / seq


def training_phases(smi: str, ops: dict) -> dict:
    """The training path on the card: yi-9b at full width (16 layers) on
    one fixed batch; yi-9b at depth 2 in float32 on the card against the
    CPU (the port's plain versions) from the same params;
    ``repro_torch.launch.train`` for granite-moe-1b-a400m at full width and
    depth, saved and resumed; a VRE's ``lm-trainer`` across a destroy and
    re-instantiation. Each run's launch counts are set to 0 just before it
    and read just after; returns them by run."""
    import shutil

    import repro_torch.core.services  # noqa: F401 (registers the services)
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.monitoring import Monitor
    from repro_torch.core.vre import VirtualResearchEnvironment, VREConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.launch import train as train_driver
    from repro_torch.models.model import build_model
    from repro_torch.models.params import to_device
    from repro_torch.optim.adamw import OptimizerConfig, leaves
    from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                                 make_train_step)
    fa_ops, gmm_ops = ops["flash_attention"], ops["grouped_matmul"]
    ssd_ops = ops["ssd"]
    counts = {}

    def reset():
        for op in ops.values():
            op.launches = 0
        fa_ops.bwd_launches = gmm_ops.bwd_launches = ssd_ops.bwd_launches = 0
        gmm_ops.launches_by_variant.update(
            dict.fromkeys(gmm_ops.launches_by_variant, 0))

    def read():
        return {**{name: op.launches for name, op in ops.items()},
                "flash_attention_bwd": fa_ops.bwd_launches,
                "grouped_matmul_bwd": gmm_ops.bwd_launches,
                "ssd_bwd": ssd_ops.bwd_launches,
                "grouped_matmul_by_variant": dict(
                    gmm_ops.launches_by_variant)}

    def release(label):
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "released", "after": label,
              "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})

    def check_losses(label, losses, norms=None):
        bad = [x for x in losses + (norms or []) if not np.isfinite(x)]
        if bad or not losses[-1] < losses[0]:
            fail(f"{label}: losses {losses}, grad norms {norms}: not finite "
                 f"or not falling")

    # -- train_yi9b: full width, 16 of 48 layers, bf16, f32 moments -------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("yi-9b"),
                              num_layers=YI_TRAIN["layers"],
                              remat_policy="full")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    state = init_state(model, opt_cfg,
                       torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in leaves(state["params"]))
    step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=YI_TRAIN["seq"],
                                      global_batch=YI_TRAIN["batch"]))
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, norms, step_ms = [], [], []
    reset()
    for _ in range(YI_TRAIN["steps"]):
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t1) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    counts["train_yi9b"] = got = read()
    steps, layers = YI_TRAIN["steps"], YI_TRAIN["layers"]
    want = {"flash_attention": 2 * layers * steps,
            "flash_attention_bwd": layers * steps, "grouped_matmul": 0,
            "grouped_matmul_bwd": 0, "ssd": 0}
    tokens = YI_TRAIN["batch"] * YI_TRAIN["seq"]
    median_ms = float(np.median(step_ms[2:]))
    flops = model_flops(cfg, state["params"], tokens, YI_TRAIN["seq"])
    emit({"phase": "train_yi9b", "layers": layers, "d_model": cfg.d_model,
          "params": n_params, "dtype": cfg.dtype, "moments": "float32",
          "remat_policy": cfg.remat_policy, "batch": YI_TRAIN["batch"],
          "seq": YI_TRAIN["seq"], "losses": losses, "grad_norms": norms,
          "step_ms": step_ms, "step_ms_median_3_10": median_ms,
          "tokens_per_s": tokens / median_ms * 1e3,
          "model_flops_per_step": flops,
          "model_flops_share_of_bf16_peak": flops / (median_ms * 1e-3)
          / H100_BF16_FLOPS,
          "launches": got, "expected_launches": want,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "init_seconds": init_s, "card": smi,
          "seconds": time.perf_counter() - t0})
    check_losses("train_yi9b", losses, norms)
    if {k: got[k] for k in want} != want:
        fail(f"train_yi9b: launches {got}, expected {want}")
    holder = [state]

    def one_step():
        holder[0], _ = step_fn(holder[0], batch)
    emit({"phase": "train_yi9b_profile", "step": YI_TRAIN["steps"] + 1,
          **step_profile(one_step), "card": smi})
    del model, state, step_fn, batch, metrics, holder
    release("train_yi9b")

    # -- train_parity_f32: depth 2, f32, the card against the CPU ---------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=2,
                              dtype="float32")
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=10)
    cpu_model = build_model(cfg, device="cpu")
    cpu_state = init_state(cpu_model, opt_cfg,
                           torch.Generator().manual_seed(0))
    card_model = build_model(cfg, device="cuda")
    card_state = to_device(cpu_state, "cuda")     # the same params
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                      global_batch=2))
    runs = {}
    for label, model, st in (("cuda", card_model, card_state),
                             ("cpu", cpu_model, cpu_state)):
        step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
        reset()
        ls = []
        for i in range(3):
            b = {k: torch.as_tensor(v).to(model.device)
                 for k, v in data.batch(i).items()}
            st, m = step_fn(st, b)
            ls.append(float(m["loss"]))
        runs[label] = (ls, st, read())
    (cl, cst, ccounts), (hl, hst, _) = runs["cuda"], runs["cpu"]
    # f32 on both: summation orders (the kernels', the CPU's); params to
    # tests/test_training.py's accumulation tolerance
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cl, hl))
    worst, ok = 0.0, loss_rel <= 1e-4
    for a, b in zip(leaves(cst["params"]), leaves(hst["params"])):
        diff = (a.cpu() - b).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= 5e-5 + 5e-4 * b.abs()).all())
    want = {"flash_attention": 2 * 2 * 3, "flash_attention_bwd": 2 * 3}
    emit({"phase": "train_parity_f32", "layers": 2, "batch": 2, "seq": 128,
          "losses_cuda": cl, "losses_cpu": hl, "loss_max_rel_diff": loss_rel,
          "loss_rtol": 1e-4, "params_max_abs_diff": worst,
          "params_tol": {"atol": 5e-5, "rtol": 5e-4},
          "launches_cuda": ccounts, "ok": ok, "card": smi,
          "seconds": time.perf_counter() - t0})
    if not ok or {k: ccounts[k] for k in want} != want:
        fail(f"train_parity_f32: card and CPU disagree (losses {cl} vs {hl},"
             f" params {worst}) or launches {ccounts} != {want}")
    del cpu_model, cpu_state, card_model, card_state, runs, cst, hst, st
    release("train_parity_f32")

    # -- train_granite: launch/train.py, full width and depth, resumed ----
    t0 = time.perf_counter()
    ckpt = Path(tempfile.mkdtemp(prefix="train_granite_"))
    try:
        args = train_driver.parse_args(GRANITE_TRAIN + [
            "--steps", "10", "--ckpt-every", "5", "--ckpt-dir", str(ckpt)])
        torch.cuda.reset_peak_memory_stats()
        reset()
        t1 = time.perf_counter()
        out = io.StringIO()
        mon = Monitor(name="train")
        with contextlib.redirect_stdout(out):
            losses1, state1 = train_driver.run(args, monitor=mon)
        run1_s = time.perf_counter() - t1
        counts["train_granite"] = got = read()
        peak1 = torch.cuda.max_memory_allocated() / 1e9
        step_ms = [1e3 * e["seconds"] for e in mon.events("train")
                   if e["event"] == "step.done"]
        cfg = get_config("granite-moe-1b-a400m")
        tokens = 8 * 2048
        median_ms = float(np.median(step_ms[2:]))
        flops = model_flops(cfg, state1["params"], tokens, 2048)
        layers, steps, mbs = cfg.num_layers, 10, 2
        # every layer MoE: 3 expert products a forward, run twice under
        # remat, and dx, dw for each in the backward; flash likewise
        want = {"flash_attention": 2 * layers * mbs * steps,
                "flash_attention_bwd": layers * mbs * steps,
                "grouped_matmul": 6 * layers * mbs * steps,
                "grouped_matmul_bwd": 6 * layers * mbs * steps, "ssd": 0}
        # capacity 2560: the tile kernel for the forward, its dx and dw
        # variants for the backward
        want_variants = {"tile": 6 * layers * mbs * steps, "stream": 0,
                         "dx": 3 * layers * mbs * steps,
                         "dw": 3 * layers * mbs * steps, "f32": 0}
        store = CheckpointStore(str(ckpt))
        saved = store.latest_step()
        restored = store.restore(state1, step=saved)
        mismatched = [i for i, (a, b) in enumerate(zip(
            leaves(restored), leaves(state1))) if not torch.equal(a, b)]
        n_leaves = len(leaves(state1))
        del restored, state1
        store.gc(keep_last=1)
        release("train_granite run 1")
        out2 = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out2):
            losses2 = train_driver.main(GRANITE_TRAIN + [
                "--steps", "5", "--ckpt-every", "5", "--resume",
                "--ckpt-dir", str(ckpt)])
        run2_s = time.perf_counter() - t1
        emit({"phase": "train_granite", "layers": layers,
              "argv": GRANITE_TRAIN + ["--steps", "10", "--ckpt-every", "5"],
              "losses": losses1, "resumed_losses": losses2,
              "printed": out.getvalue().splitlines(),
              "printed_resume": out2.getvalue().splitlines(),
              "step_ms": step_ms, "step_ms_median_3_10": median_ms,
              "tokens_per_s": tokens / median_ms * 1e3,
              "model_flops_per_step": flops,
              "model_flops_share_of_bf16_peak": flops / (median_ms * 1e-3)
              / H100_BF16_FLOPS,
              "run_seconds": run1_s, "resume_run_seconds": run2_s,
              "tokens_per_s_with_saves": 10 * tokens / run1_s,
              "saved_step": saved, "leaves": n_leaves,
              "restored_leaves_unequal": mismatched,
              "launches": got, "expected_launches": want,
              "expected_by_variant": want_variants,
              "peak_memory_gb": peak1, "card": smi,
              "seconds": time.perf_counter() - t0})
        check_losses("train_granite", losses1)
        if not all(np.isfinite(losses2)) or \
                "[resume] restored step 10" not in out2.getvalue():
            fail(f"train_granite: the resumed run {losses2} did not restore "
                 f"step 10")
        if saved != 10 or mismatched:
            fail(f"train_granite: step {saved} restored with leaves "
                 f"{mismatched} unequal")
        if {k: got[k] for k in want} != want or \
                got["grouped_matmul_by_variant"] != want_variants:
            fail(f"train_granite: launches {got}, expected {want} and "
                 f"{want_variants}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    release("train_granite")
    # one step of train_granite's shape (8 x 2048 in 2 microbatches) under
    # the profiler, after a warm one
    cfg = get_config("granite-moe-1b-a400m")
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=5, total_steps=10)
    holder = [init_state(model, opt_cfg,
                         torch.Generator(device="cuda").manual_seed(0))]
    step_fn = make_train_step(model, cfg, opt_cfg,
                              TrainStepConfig(microbatches=2))
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=2048, global_batch=8))
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}

    def one_step():
        holder[0], _ = step_fn(holder[0], batch)
    one_step()
    emit({"phase": "train_granite_profile", **step_profile(one_step),
          "card": smi})
    del model, holder, step_fn, batch
    release("train_granite_profile")

    # -- vre_train: lm-trainer across a destroy and re-instantiation ------
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="vre_train_")
    try:
        vcfg = VREConfig(name="train", mesh_shape=(1, 1),
                         services=["volumes", "data", "lm-trainer"],
                         arch="granite-moe-1b-a400m", provider="h100",
                         workdir=workdir,
                         extra={"global_batch": 8, "seq_len": 512})
        vre = VirtualResearchEnvironment(vcfg)
        vre.instantiate()
        trainer = vre.service("lm-trainer")
        reset()
        losses1 = trainer.train_steps(vre.service("data"), 5)
        vre.service("volumes").save(trainer.state, step=5, blocking=True)
        device1 = str(leaves(trainer.state)[0].device)
        del trainer
        vre.destroy()
        del vre
        release("vre_train destroy")
        vre2 = VirtualResearchEnvironment(vcfg)
        vre2.instantiate()
        t2 = vre2.service("lm-trainer")
        t2.state = vre2.service("volumes").restore(t2.state, step=5)
        losses2 = t2.train_steps(vre2.service("data"), 5)
        counts["vre_train"] = got = read()
        healthy = t2.health()
        del t2
        vre2.destroy()
        del vre2
        layers = get_config("granite-moe-1b-a400m").num_layers
        want = {"flash_attention": 2 * layers * 10,
                "flash_attention_bwd": layers * 10,
                "grouped_matmul": 6 * layers * 10,
                "grouped_matmul_bwd": 6 * layers * 10, "ssd": 0}
        # capacity _capacity(8 * 512, 8, 32, 1.25) = 1280: as train_granite
        want_variants = {"tile": 6 * layers * 10, "stream": 0,
                         "dx": 3 * layers * 10, "dw": 3 * layers * 10,
                         "f32": 0}
        emit({"phase": "vre_train", "arch": "granite-moe-1b-a400m",
              "provider": "h100", "state_device": device1,
              "losses_before_destroy": losses1,
              "losses_after_restore": losses2, "healthy": healthy,
              "launches": got, "expected_launches": want,
              "expected_by_variant": want_variants, "card": smi,
              "seconds": time.perf_counter() - t0})
        if not (all(np.isfinite(losses1 + losses2)) and healthy
                and losses2[0] < losses1[0] + 1.0):
            fail(f"vre_train: restore did not continue ({losses1} then "
                 f"{losses2})")
        if not device1.startswith("cuda") or \
                {k: got[k] for k in want} != want or \
                got["grouped_matmul_by_variant"] != want_variants:
            fail(f"vre_train: state on {device1}, launches {got}, expected "
                 f"{want} and {want_variants}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    release("vre_train")

    # -- train_parity_ssm_f32: mamba2 and zamba2 cut to 2 layers (zamba2:
    # one segment of 6 and the shared block), f32, the card against the
    # CPU from the same params: the SSD backward's gradients reach the
    # params (a dropped intra-chunk term shows here)
    for arch, over, batch, seq in (
            ("mamba2-370m", dict(num_layers=2), 2, 512),
            ("zamba2-1.2b", dict(num_layers=6), 1, 512)):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
        opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=10)
        cpu_model = build_model(cfg, device="cpu")
        cpu_state = init_state(cpu_model, opt_cfg,
                               torch.Generator().manual_seed(0))
        card_model = build_model(cfg, device="cuda")
        card_state = to_device(cpu_state, "cuda")     # the same params
        data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=seq, global_batch=batch))
        runs = {}
        for label, model, st in (("cuda", card_model, card_state),
                                 ("cpu", cpu_model, cpu_state)):
            step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
            reset()
            ls, ns = [], []
            for i in range(3):
                b = {k: torch.as_tensor(v).to(model.device)
                     for k, v in data.batch(i).items()}
                st, m = step_fn(st, b)
                ls.append(float(m["loss"]))
                ns.append(float(m["grad_norm"]))
            runs[label] = (ls, ns, st, read())
        (cl, cn, cst, ccounts), (hl, hn, hst, _) = runs["cuda"], runs["cpu"]
        # f32 on both: summation orders (the kernels', the CPU's); params
        # to tests/test_training.py's accumulation tolerance
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cl, hl))
        norm_rel = max(abs(a - b) / abs(b) for a, b in zip(cn, hn))
        worst, ok = 0.0, loss_rel <= 1e-4 and norm_rel <= 1e-3
        for a, b in zip(leaves(cst["params"]), leaves(hst["params"])):
            diff = (a.cpu() - b).abs()
            worst = max(worst, float(diff.max()))
            ok = ok and bool((diff <= 5e-5 + 5e-4 * b.abs()).all())
        n = cfg.num_layers
        apps = n // cfg.shared_attn_every if cfg.shared_attn_every else 0
        # remat "full": each Mamba2 layer's forward twice a step; the
        # shared block once
        want = {"ssd": 2 * n * 3, "ssd_bwd": n * 3,
                "flash_attention": apps * 3, "flash_attention_bwd": apps * 3}
        emit({"phase": "train_parity_ssm_f32", "arch": arch, "layers": n,
              "shared_block_applications": apps, "batch": batch,
              "seq": seq, "losses_cuda": cl, "losses_cpu": hl,
              "grad_norms_cuda": cn, "grad_norms_cpu": hn,
              "loss_max_rel_diff": loss_rel, "loss_rtol": 1e-4,
              "grad_norm_max_rel_diff": norm_rel, "grad_norm_rtol": 1e-3,
              "params_max_abs_diff": worst,
              "params_tol": {"atol": 5e-5, "rtol": 5e-4},
              "launches_cuda": ccounts, "expected_launches": want, "ok": ok,
              "card": smi, "seconds": time.perf_counter() - t0})
        if not ok or {k: ccounts[k] for k in want} != want:
            fail(f"train_parity_ssm_f32 {arch}: card and CPU disagree "
                 f"(losses {cl} vs {hl}, grad norms {cn} vs {hn}, params "
                 f"{worst}) or launches {ccounts} != {want}")
        del cpu_model, cpu_state, card_model, card_state, runs, cst, hst, st
        release(f"train_parity_ssm_f32 {arch}")

    # -- train_mamba2: launch/train.py, full width and depth, resumed -----
    t0 = time.perf_counter()
    ckpt = Path(tempfile.mkdtemp(prefix="train_mamba2_"))
    try:
        args = train_driver.parse_args(MAMBA2_TRAIN + [
            "--steps", "10", "--ckpt-every", "5", "--ckpt-dir", str(ckpt)])
        torch.cuda.reset_peak_memory_stats()
        reset()
        t1 = time.perf_counter()
        out = io.StringIO()
        mon = Monitor(name="train")
        with contextlib.redirect_stdout(out):
            losses1, state1 = train_driver.run(args, monitor=mon)
        run1_s = time.perf_counter() - t1
        counts["train_mamba2"] = got = read()
        peak1 = torch.cuda.max_memory_allocated() / 1e9
        step_ms = [1e3 * e["seconds"] for e in mon.events("train")
                   if e["event"] == "step.done"]
        cfg = get_config("mamba2-370m")
        tokens = 8 * 2048
        median_ms = float(np.median(step_ms[2:]))
        layers, steps, mbs = cfg.num_layers, 10, 2
        n_params = sum(t.numel() for t in leaves(state1["params"]))
        # remat "full": each layer's SSD forward twice a microbatch, its
        # backward once
        want = {"ssd": 2 * layers * mbs * steps,
                "ssd_bwd": layers * mbs * steps, "flash_attention": 0,
                "flash_attention_bwd": 0, "grouped_matmul": 0,
                "grouped_matmul_bwd": 0}
        store = CheckpointStore(str(ckpt))
        saved = store.latest_step()
        restored = store.restore(state1, step=saved)
        mismatched = [i for i, (a, b) in enumerate(zip(
            leaves(restored), leaves(state1))) if not torch.equal(a, b)]
        n_leaves = len(leaves(state1))
        del restored, state1
        store.gc(keep_last=1)
        release("train_mamba2 run 1")
        out2 = io.StringIO()
        reset()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out2):
            losses2 = train_driver.main(MAMBA2_TRAIN + [
                "--steps", "5", "--ckpt-every", "5", "--resume",
                "--ckpt-dir", str(ckpt)])
        run2_s = time.perf_counter() - t1
        got2 = read()
        want2 = {k: v // 2 for k, v in want.items()}
        emit({"phase": "train_mamba2", "layers": layers, "params": n_params,
              "d_model": cfg.d_model, "dtype": cfg.dtype,
              "moments": "float32", "remat_policy": cfg.remat_policy,
              "argv": MAMBA2_TRAIN + ["--steps", "10", "--ckpt-every", "5"],
              "losses": losses1, "resumed_losses": losses2,
              "printed": out.getvalue().splitlines(),
              "printed_resume": out2.getvalue().splitlines(),
              "step_ms": step_ms, "step_ms_median_3_10": median_ms,
              "tokens_per_s": tokens / median_ms * 1e3,
              "run_seconds": run1_s, "resume_run_seconds": run2_s,
              "tokens_per_s_with_saves": 10 * tokens / run1_s,
              "saved_step": saved, "leaves": n_leaves,
              "restored_leaves_unequal": mismatched,
              "launches": got, "expected_launches": want,
              "resume_launches": got2, "expected_resume_launches": want2,
              "peak_memory_gb": peak1, "card": smi,
              "seconds": time.perf_counter() - t0})
        check_losses("train_mamba2", losses1)
        if not all(np.isfinite(losses2)) or \
                "[resume] restored step 10" not in out2.getvalue():
            fail(f"train_mamba2: the resumed run {losses2} did not restore "
                 f"step 10")
        if saved != 10 or mismatched:
            fail(f"train_mamba2: step {saved} restored with leaves "
                 f"{mismatched} unequal")
        if {k: got[k] for k in want} != want or \
                {k: got2[k] for k in want2} != want2:
            fail(f"train_mamba2: launches {got} then {got2}, expected {want} "
                 f"then {want2}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    release("train_mamba2")
    # one step of train_mamba2's shape (8 x 2048 in 2 microbatches) under
    # the profiler, after a warm one
    cfg = get_config("mamba2-370m")
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=5, total_steps=10)
    holder = [init_state(model, opt_cfg,
                         torch.Generator(device="cuda").manual_seed(0))]
    step_fn = make_train_step(model, cfg, opt_cfg,
                              TrainStepConfig(microbatches=2))
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=2048, global_batch=8))
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}

    def one_step():
        holder[0], _ = step_fn(holder[0], batch)
    one_step()
    emit({"phase": "train_mamba2_profile", **step_profile(one_step, top=16),
          "card": smi})
    del model, holder, step_fn, batch
    release("train_mamba2_profile")

    # -- train_zamba2: full width and depth, one fixed 4 x 2048 batch -----
    t0 = time.perf_counter()
    cfg = get_config("zamba2-1.2b")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    state = init_state(model, opt_cfg,
                       torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in leaves(state["params"]))
    step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=ZAMBA2_TRAIN["seq"],
                                      global_batch=ZAMBA2_TRAIN["batch"]))
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, norms, step_ms = [], [], []
    reset()
    for _ in range(ZAMBA2_TRAIN["steps"]):
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t1) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    counts["train_zamba2"] = got = read()
    steps, layers = ZAMBA2_TRAIN["steps"], cfg.num_layers
    apps = layers // cfg.shared_attn_every
    # Mamba2 layers remat'd (SSD forward twice), the shared block not
    want = {"ssd": 2 * layers * steps, "ssd_bwd": layers * steps,
            "flash_attention": apps * steps,
            "flash_attention_bwd": apps * steps, "grouped_matmul": 0,
            "grouped_matmul_bwd": 0}
    tokens = ZAMBA2_TRAIN["batch"] * ZAMBA2_TRAIN["seq"]
    median_ms = float(np.median(step_ms[2:]))
    emit({"phase": "train_zamba2", "layers": layers,
          "shared_block_applications": apps, "d_model": cfg.d_model,
          "params": n_params, "dtype": cfg.dtype, "moments": "float32",
          "remat_policy": cfg.remat_policy, "batch": ZAMBA2_TRAIN["batch"],
          "seq": ZAMBA2_TRAIN["seq"], "losses": losses, "grad_norms": norms,
          "step_ms": step_ms, "step_ms_median_3_10": median_ms,
          "tokens_per_s": tokens / median_ms * 1e3,
          "launches": got, "expected_launches": want,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "init_seconds": init_s, "card": smi,
          "seconds": time.perf_counter() - t0})
    check_losses("train_zamba2", losses, norms)
    if {k: got[k] for k in want} != want:
        fail(f"train_zamba2: launches {got}, expected {want}")
    # one more step under the profiler
    holder = [state]

    def one_step():
        holder[0], _ = step_fn(holder[0], batch)
    emit({"phase": "train_zamba2_profile", **step_profile(one_step, top=16),
          "card": smi})
    del model, state, holder, step_fn, batch, metrics
    release("train_zamba2")
    return counts


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core.monitoring import Monitor
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         attention_ref_bwd)
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import (ssd_intra_chunk_ref,
                                             ssd_intra_chunk_ref_bwd)
    from repro_torch.launch.serve import (build_replicaset, make_prompts,
                                          run_load)
    from repro_torch.models.mamba2 import ssd_ref
    from repro_torch.models.model import build_model
    from repro_torch.models.params import to_device
    from repro_torch.serving.engine import ServingEngine, greedy_generate
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.speculative import NgramDraft, build_draft

    ops = {"flash_attention": fa_ops, "grouped_matmul": gmm_ops,
           "ssd": ssd_ops}
    replaces = {
        "flash_attention": ("src/repro/kernels/flash_attention/kernel.py:68",
                            "flash_attention_kernel"),
        "grouped_matmul": ("src/repro/kernels/grouped_matmul/kernel.py:34",
                           "grouped_matmul_kernel"),
        "ssd": ("src/repro/kernels/ssd/kernel.py:49", "ssd_intra_chunk")}
    kernels = {name: {"name": name, "route": "cuda",
                      "source": str(op.SOURCE.relative_to(ROOT)),
                      "replaces": replaces[name][0],
                      "tpu_kernel": f"{replaces[name][0].rsplit(':', 1)[0]}:"
                                    f"{replaces[name][1]}"}
               for name, op in ops.items()}

    # -- 1. device -------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    nvcc_version = subprocess.run([_build.nvcc(), "--version"],
                                  capture_output=True, text=True,
                                  timeout=60).stdout.strip().splitlines()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    emit({"phase": "device", **device, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_version[-1] if nvcc_version else None,
          "python": sys.version.split()[0],
          "seconds": time.perf_counter() - t0})

    # -- 2. build: one nvcc per source, all started together ---------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(ops)) as pool:
        built = {n: pool.submit(_build.build, op.SOURCE)
                 for n, op in ops.items()}
        built = {n: f.result() for n, f in built.items()}
    for name, (lib, report, secs) in built.items():
        ptxas = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        mma = sass_mma_counts(lib)
        emit({"phase": "build", "kernel": name, "library": lib.name,
              "nvcc_seconds": secs, "ptxas": ptxas,
              "sass_tensor_core_instructions": mma})
        # the bf16 products and the SSD kernel's split-TF32 products must
        # run on the tensor cores; the backward kernels (flash attention's
        # at head dims 64 and 128, the grouped matmul's dx and dw) on the
        # warpgroup ones (HGMMA)
        tc = {k: n["HMMA"] + n["HGMMA"] for k, n in mma.items() if any(
            s in k for s in ("flash_fwd_bf16_kernel", "gmm_tile_kernel",
                             "gmm_stream_kernel", "ssd_first_kernel",
                             "ssd_y_kernel"))}
        if not tc or min(tc.values()) == 0:
            fail(f"{name}: a tensor-core kernel issues no tensor-core "
                 f"instruction ({mma})")
        for needle in WGMMA_KERNELS[name]:
            hgmma = [n["HGMMA"] for k, n in mma.items() if needle in k]
            if not hgmma or min(hgmma) == 0:
                fail(f"{name}: {needle} issues no HGMMA ({mma})")
        kernels[name]["sass_tensor_core_instructions"] = mma
    for op in ops.values():
        op.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    # -- 3. every kernel vs its plain version on the card ------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    misses = []
    flash_checked = set()

    def check_flash(case, dtype, phase="kernel_vs_plain"):
        b, s, h, kv, d, win, cap = case
        q = randn((b, s, h, d), dtype, gen)
        k = randn((b, s, kv, d), dtype, gen)
        v = randn((b, s, kv, d), dtype, gen)
        out = fa_ops.flash_attention(q, k, v, window=win, softcap=cap)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, window=win, softcap=cap)
        # f32: summation order (longer rows at S=1024); bf16: output
        # rounding, and the kernel rounds probabilities to bf16 before
        # P.V (relative error at most 2^-9 each)
        tol = 2e-2 if dtype == torch.bfloat16 else (
            1e-4 if s >= 1024 else 2e-5)
        err, ok = close(out, ref, tol)
        emit({"phase": phase, "kernel": "flash_attention",
              "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": d},
              "window": win, "softcap": cap,
              "dtype": str(dtype).removeprefix("torch."),
              "max_abs_err": err, "tol": tol, "ok": ok})
        flash_checked.add((tuple(case), dtype))
        if not ok:
            misses.append(("flash_attention", case, str(dtype)))
        return err, tol

    family_flash = [c for cases in FAMILY_PREFILL.values() for c in cases]
    for case in SWEEP + FLASH_EDGES + [YI_PREFILL, GRANITE_ATTN,
                                       SERVED_PREFILL] + family_flash:
        for dtype in (torch.float32, torch.bfloat16):
            err, tol = check_flash(case, dtype)
            if case == YI_PREFILL and dtype == torch.bfloat16:
                kernels["flash_attention"].update(
                    max_abs_err=err, max_err=err, tol=tol)
    for case in GMM_SWEEP + [GMM_PREFILL, GMM_PREFILL_WO, GMM_DECODE,
                             GMM_DECODE_WO] + GMM_EDGES:
        e, c, d, f = case
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((e, c, d), dtype, gen, 0.3)
            w = randn((e, d, f), dtype, gen, 0.3)
            variant = ("f32" if dtype == torch.float32
                       else gmm_ops._plan(c, d, f))
            before = dict(gmm_ops.launches_by_variant)
            out = gmm_ops.grouped_matmul(x, w)
            torch.cuda.synchronize()
            went = {k: n - before[k]
                    for k, n in gmm_ops.launches_by_variant.items()}
            # JAX's tolerances: f32 summation order, bf16 one output rounding
            tol = 3e-4 if dtype == torch.float32 else 3e-2
            err, ok = close(out, grouped_matmul_ref(x, w), tol)
            ok = ok and went == {k: int(k == variant) for k in went}
            emit({"phase": "kernel_vs_plain", "kernel": "grouped_matmul",
                  "shape": {"E": e, "C": c, "d": d, "f": f},
                  "dtype": str(dtype).removeprefix("torch."),
                  "variant": variant, "launched": went,
                  "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                misses.append(("grouped_matmul", case, str(dtype)))
            if case == GMM_PREFILL and dtype == torch.bfloat16:
                kernels["grouped_matmul"].update(
                    max_abs_err=err, max_err=err, tol=tol)
    # tests/test_kernels.py's SSD tolerance, f32 throughout
    ssd_tol = dict(atol=5e-4, rtol=5e-3)
    for case, wide in ([(c, False) for c in SSD_SWEEP + [
            SSD_PREFILL, SSD_PREFILL_256, SSD_ZAMBA2] + SSD_EDGES]
            + [(c, True) for c in SSD_WIDE_DECAY + [SSD_ZAMBA2]]):
        b, s, nh, hd, ds, ch = case
        a, xdt, Bc, Cc = ssd_kernel_inputs(
            *ssd_inputs(b, s, nh, hd, ds, gen, wide), ch)
        before = ssd_ops.launches
        y, S = ssd_ops.ssd_intra_chunk(a, xdt, Bc, Cc)
        torch.cuda.synchronize()
        launched = ssd_ops.launches - before
        ry, rS = ssd_intra_chunk_ref(a, xdt, Bc, Cc)
        err = max(float((y - ry).abs().max()), float((S - rS).abs().max()))
        ok = all(torch.allclose(o, r, **ssd_tol) for o, r in ((y, ry),
                                                               (S, rS)))
        ok = ok and launched == 1
        emit({"phase": "kernel_vs_plain", "kernel": "ssd",
              "shape": {"b": b, "nh": nh, "nc": s // ch, "c": ch, "hd": hd,
                        "ds": ds},
              "decay": "A=-linspace(1,16)" if wide else "A=-exp(linspace(0,1))",
              "y_blocks": ssd_ops.y_blocks(b, nh, s // ch, ch),
              "launched": launched,
              "dtype": "float32", "max_abs_err": err, "tol": ssd_tol,
              "ok": ok})
        if not ok:
            misses.append(("ssd", case, "float32", wide))
        if case == SSD_PREFILL and not wide:
            kernels["ssd"].update(max_abs_err=err, max_err=err, tol=ssd_tol)
    # the op at a length off the chunk grid (dt = 0 padding) against the
    # sequential scan
    b, s, nh, hd, ds, ch = SSD_RAGGED
    inputs = ssd_inputs(b, s, nh, hd, ds, gen)
    y, st = ssd_ops.ssd_chunked(*inputs, ch)
    ry, rst = ssd_ref(*inputs)
    err = max(float((y - ry).abs().max()), float((st - rst).abs().max()))
    ok = torch.allclose(y, ry, **ssd_tol) and torch.allclose(st, rst,
                                                             **ssd_tol)
    emit({"phase": "kernel_vs_plain", "kernel": "ssd", "op": "ssd_chunked",
          "against": "sequential ssd_ref", "shape": {
              "b": b, "S": s, "nh": nh, "hd": hd, "ds": ds, "chunk": ch},
          "dtype": "float32", "max_abs_err": err, "tol": ssd_tol, "ok": ok})
    if not ok:
        misses.append(("ssd_chunked", SSD_RAGGED, "float32"))

    # the backward kernels against the plain backward (autograd through the
    # plain version) on f32 copies of the same inputs and output gradient;
    # each error relative to the gradient's largest magnitude: f32 the
    # summation order, bf16 the gradients' rounding and the bf16 forward's
    # output (its probabilities rounded before P.V) in rowsum(dO * O)
    def check_flash_bwd(case, dtype):
        b, s, h, kv, d, win, cap = case
        q, k, v = (randn((b, s, n, d), dtype, gen,
                         SOFTCAP_Q_SCALE if cap and n == h else 1.0)
                   .requires_grad_() for n in (h, kv, kv))
        dout = randn((b, s, h, d), dtype, gen)
        before = (fa_ops.launches, fa_ops.bwd_launches)
        out = fa_ops.flash_attention(q, k, v, window=win, softcap=cap)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        launched = (fa_ops.launches - before[0],
                    fa_ops.bwd_launches - before[1])
        refs = attention_ref_bwd(*(t.detach().float() for t in (q, k, v)),
                                 dout.float(), window=win, softcap=cap)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        errs, ok = {}, launched == (1, 1)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            errs[name] = float((g.float() - r).abs().max())
            ok = ok and bool(torch.isfinite(g).all()) and g.dtype == dtype \
                and errs[name] <= tol * float(r.abs().max())
        # a softcap case must tell the softcap apart: the kernel's gradients
        # lie further than the tolerance from the plain backward without it
        apart = {}
        if cap:
            nocap = attention_ref_bwd(*(t.detach().float() for t in (q, k, v)),
                                      dout.float(), window=win)
            for name, g, r in zip(("dq", "dk", "dv"), grads, nocap):
                apart[name] = float((g.float() - r).abs().max()) \
                    / float(r.abs().max())
                ok = ok and apart[name] > tol
        emit({"phase": "kernel_vs_plain_bwd", "kernel": "flash_attention_bwd",
              "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": d},
              "window": win, "softcap": cap,
              "q_scale": SOFTCAP_Q_SCALE if cap else 1.0,
              "dtype": str(dtype).removeprefix("torch."),
              "launched_fwd_bwd": list(launched), "max_abs_err": errs,
              "grad_max": [float(r.abs().max()) for r in refs],
              "tol_of_max": tol, "from_no_softcap_of_max": apart or None,
              "ok": ok})
        if not ok:
            misses.append(("flash_attention_bwd", case, str(dtype)))
        return max(errs.values()), tol

    def check_gmm_bwd(case, dtype):
        e, c, d, f = case
        x, w = (randn(shape, dtype, gen, 0.3).requires_grad_()
                for shape in ((e, c, d), (e, d, f)))
        dy = randn((e, c, f), dtype, gen, 0.3)
        before = (gmm_ops.launches, gmm_ops.bwd_launches,
                  dict(gmm_ops.launches_by_variant))
        dx, dw = torch.autograd.grad(gmm_ops.grouped_matmul(x, w), (x, w), dy)
        torch.cuda.synchronize()
        launched = (gmm_ops.launches - before[0],
                    gmm_ops.bwd_launches - before[1])
        went = {k: n - before[2][k]
                for k, n in gmm_ops.launches_by_variant.items()}
        xr, wr = (t.detach().float().requires_grad_() for t in (x, w))
        rx, rw = torch.autograd.grad(grouped_matmul_ref(xr, wr), (xr, wr),
                                     dy.float())
        # f32: summation order over up to 2560 terms; bf16: one rounding
        tol = 3e-2 if dtype == torch.bfloat16 else 3e-4
        # the forward's kernel, then dx and dw: the tile kernel's variants
        # (read in place) in bf16, the f32 kernel (on copies) in f32
        want = ({gmm_ops._plan(c, d, f): 1, "dx": 1, "dw": 1}
                if dtype == torch.bfloat16 else {"f32": 3})
        errs, ok = {}, launched == (1, 2) and \
            went == {k: want.get(k, 0) for k in went}
        for name, g, r in (("dx", dx, rx), ("dw", dw, rw)):
            errs[name] = float((g.float() - r).abs().max())
            ok = ok and g.dtype == dtype and \
                errs[name] <= tol * float(r.abs().max())
        emit({"phase": "kernel_vs_plain_bwd", "kernel": "grouped_matmul_bwd",
              "shape": {"E": e, "C": c, "d": d, "f": f},
              "dtype": str(dtype).removeprefix("torch."),
              "launched_fwd_bwd": list(launched), "by_variant": went,
              "max_abs_err": errs, "tol_of_max": tol, "ok": ok})
        if not ok:
            misses.append(("grouped_matmul_bwd", case, str(dtype)))
        return max(errs.values()), tol

    kernels["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": kernels["flash_attention"]["source"],
        "replaces": kernels["flash_attention"]["replaces"],
        "gradient_of": "flash_attention (the Pallas kernel has no backward)"}
    kernels["grouped_matmul_bwd"] = {
        "name": "grouped_matmul_bwd", "route": "cuda",
        "source": kernels["grouped_matmul"]["source"],
        "replaces": kernels["grouped_matmul"]["replaces"],
        "gradient_of": "grouped_matmul (dx, dw on the tile kernel's "
                       "gmm_dx_kernel and gmm_dw_kernel, read in place)"}
    for case in FLASH_BWD:
        for dtype in (torch.float32, torch.bfloat16):
            err, tol = check_flash_bwd(case, dtype)
            if case == FLASH_BWD[0] and dtype == torch.bfloat16:
                kernels["flash_attention_bwd"].update(max_abs_err=err,
                                                      tol_of_max=tol)
    for case in GMM_BWD:
        for dtype in (torch.float32, torch.bfloat16):
            err, tol = check_gmm_bwd(case, dtype)
            if case == GMM_BWD[0] and dtype == torch.bfloat16:
                kernels["grouped_matmul_bwd"].update(max_abs_err=err,
                                                     tol_of_max=tol)

    def check_ssd_bwd(case, wide):
        """The op's gradients through ``SSDIntraChunk`` (one forward and
        one backward launch) against the plain backward on the same inputs
        and output gradients, f32."""
        b, s, nh, hd, ds, ch = case
        ins = [t.requires_grad_() for t in ssd_kernel_inputs(
            *ssd_inputs(b, s, nh, hd, ds, gen, wide), ch)]
        dy = randn(ins[1].shape, torch.float32, gen)
        dS = randn((b, nh, s // ch, ds, hd), torch.float32, gen)
        before = (ssd_ops.launches, ssd_ops.bwd_launches)
        y, S = ssd_ops.ssd_intra_chunk(*ins)
        tracked = y.grad_fn is not None and S.grad_fn is not None
        grads = torch.autograd.grad((y, S), ins, (dy, dS))
        torch.cuda.synchronize()
        launched = (ssd_ops.launches - before[0],
                    ssd_ops.bwd_launches - before[1])
        refs = ssd_intra_chunk_ref_bwd(*(t.detach() for t in ins), dy, dS)
        errs, tops, ok = {}, {}, launched == (1, 1) and tracked
        for name, g, r in zip(("da", "dxdt", "dB", "dC"), grads, refs):
            errs[name] = float((g - r).abs().max())
            tops[name] = float(r.abs().max())
            ok = ok and bool(torch.isfinite(g).all()) and bool((
                (g - r).abs() <= SSD_BWD_TOL["atol_of_max"] * tops[name]
                + SSD_BWD_TOL["rtol"] * r.abs()).all())
        emit({"phase": "kernel_vs_plain_bwd", "kernel": "ssd_bwd",
              "shape": {"b": b, "nh": nh, "nc": s // ch, "c": ch, "hd": hd,
                        "ds": ds},
              "decay": "A=-linspace(1,16)" if wide else "A=-exp(linspace(0,1))",
              "dtype": "float32", "launched_fwd_bwd": list(launched),
              "outputs_tracked": tracked, "max_abs_err": errs,
              "grad_max": tops, "tol": SSD_BWD_TOL, "ok": ok})
        if not ok:
            misses.append(("ssd_bwd", case, "float32", wide))
        return (max(errs.values()),
                max(e / tops[n] for n, e in errs.items()))

    kernels["ssd_bwd"] = {
        "name": "ssd_bwd", "route": "cuda",
        "source": kernels["ssd"]["source"],
        "replaces": kernels["ssd"]["replaces"],
        "gradient_of": "ssd_intra_chunk (the Pallas kernel has no backward; "
                       "four grids in split TF32 on wgmma, the heads' dG "
                       "summed on chip, every sum in a fixed order)"}
    for case, wide in ([(c, False) for c in SSD_SWEEP + SSD_EDGES
                        + [MAMBA2_TRAIN_SSD, ZAMBA2_TRAIN_SSD]]
                       + [(c, True) for c in SSD_WIDE_DECAY
                          + [MAMBA2_TRAIN_SSD, ZAMBA2_TRAIN_SSD]]):
        err, err_of_max = check_ssd_bwd(case, wide)
        if case == MAMBA2_TRAIN_SSD and not wide:
            kernels["ssd_bwd"].update(max_abs_err=err,
                                      max_abs_err_of_max=err_of_max,
                                      tol=SSD_BWD_TOL)
    if misses:
        fail(f"kernels disagree with their plain versions: {misses}")

    # every flash shape the engine runs below (sections 5 and 6), to hold
    # the kernel against its plain version at each of them in section 7;
    # the wrapper still counts its own launches
    import repro_torch.models.layers as layers
    flash_served = set()
    flash_wrapper = layers.flash_attention

    def flash_logged(q, k, v, *, causal=True, window=0, softcap=0.0):
        b, s, h, d = q.shape
        flash_served.add(((b, s, h, k.shape[2], d, window, float(softcap)),
                          q.dtype))
        return flash_wrapper(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    layers.flash_attention = flash_logged
    # and every SSD op shape, (b, s, nh, hd, ds, chunk), likewise
    import repro_torch.models.mamba2 as mamba2
    ssd_served = set()
    ssd_wrapper = mamba2.ssd_chunked

    def ssd_logged(x, dt, A, B, C, chunk):
        ssd_served.add((*x.shape, B.shape[-1], chunk))
        return ssd_wrapper(x, dt, A, B, C, chunk)
    mamba2.ssd_chunked = ssd_logged
    emit({"phase": "kernel_vs_plain", "seconds": time.perf_counter() - t0})

    # -- 4. timing at the serving shapes ------------------------------------
    t0 = time.perf_counter()
    timings = {}
    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def time_flash(case) -> dict:
        """bf16 kernel ms at ``case`` beside its bound, the plain version
        and SDPA, the library call: causal, with an explicit mask where the
        window bites; none where a softcap applies (no one PyTorch call
        caps scores)."""
        b, s, h, kv, d, win, cap = case
        q, k, v = (randn((b, s, n, d), dtype, gen) for n in (h, kv, kv))

        def call():
            return fa_ops.flash_attention(q, k, v, window=win, softcap=cap)
        t = {"kernel_ms": cuda_ms(call, 20)}
        t["ms"] = t["kernel_ms"]
        t["plain_ms"] = cuda_ms(lambda: attention_ref(
            q, k, v, window=win, softcap=cap), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if cap:
            t["library_ms"] = None
        elif win and win < s:
            pos = torch.arange(s, device="cuda")
            mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None]
                                                  < win)
            t["library_ms"] = cuda_ms(lambda: sdpa(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        else:
            t["library_ms"] = cuda_ms(lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        t["bound_ms"], t["bound_by"] = attention_bound_ms(b, s, h, kv, d,
                                                          win, dtype)
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        t["host_us_per_call"] = host_us(call)
        lo = np.maximum(np.arange(s) - win + 1, 0) if win else 0
        pairs = int(np.sum(np.arange(s) - lo + 1))
        emit({"phase": "timing", "kernel": "flash_attention",
              "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": d},
              "window": win, "softcap": cap, "dtype": "bfloat16", **t,
              "kernel_tflops": 4.0 * d * b * h * pairs
              / (t["kernel_ms"] * 1e-3) / 1e12, "card": smi})
        return t

    timings["flash_attention"] = time_flash(YI_PREFILL)
    kernel_ms = timings["flash_attention"]["kernel_ms"]
    # the served shapes of the sliding-window and hybrid families
    flash_family = {arch: [dict(time_flash(c), arch=arch, shape=c)
                           for c in cases]
                    for arch, cases in FAMILY_PREFILL.items()}
    flash_family_ms = {arch: [t["kernel_ms"] for t in ts]
                       for arch, ts in flash_family.items()}
    b, s, h, kv, d, win, cap = GRANITE_ATTN
    q, k, v = (randn((b, s, n, d), dtype, gen) for n in (h, kv, kv))
    granite_flash_ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v), 20)
    emit({"phase": "timing", "kernel": "flash_attention",
          "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": d},
          "dtype": "bfloat16", "kernel_ms": granite_flash_ms,
          "bound_ms": attention_bound_ms(b, s, h, kv, d, win, dtype)[0],
          "card": smi})
    del q, k, v

    gmm_ms = {}
    for label, (e, c, d, f) in (("prefill_wi", GMM_PREFILL),
                                ("prefill_wo", GMM_PREFILL_WO),
                                ("decode_wi", GMM_DECODE),
                                ("decode_wo", GMM_DECODE_WO)):
        x = randn((e, c, d), dtype, gen, 0.3)
        # weight sets past the L2: the served path's 24 layers each hold
        # their own experts, so a call finds its weights in device memory
        nbytes_w = e * d * f * 2
        ws = [randn((e, d, f), dtype, gen, 0.3)
              for _ in range(2 + 2 * L2_BYTES // nbytes_w)]
        w = ws[0]
        t = {"kernel_ms": cold_ms(lambda w: gmm_ops.grouped_matmul(x, w), ws,
                                  40),
             "kernel_warm_ms": cuda_ms(lambda: gmm_ops.grouped_matmul(x, w),
                                       40),
             "plain_ms": cuda_ms(lambda: grouped_matmul_ref(x, w), 10),
             "library_ms": cold_ms(lambda w: torch.bmm(x, w), ws, 40),
             "library_warm_ms": cuda_ms(lambda: torch.bmm(x, w), 40),
             "weight_sets": len(ws), "variant": gmm_ops._plan(c, d, f)}
        t["bound_ms"], t["bound_by"] = gmm_bound_ms(e, c, d, f, dtype)
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        t["share_of_bound_warm"] = t["bound_ms"] / t["kernel_warm_ms"]
        # above 1 the reading came from the L2: not a result
        t["warm_l2_reading"] = t["share_of_bound"] > 1
        t["host_us_per_call"] = host_us(lambda: gmm_ops.grouped_matmul(x, w))
        gmm_ms[label] = t["kernel_ms"]
        emit({"phase": "timing", "kernel": "grouped_matmul", "call": label,
              "shape": {"E": e, "C": c, "d": d, "f": f}, "dtype": "bfloat16",
              **t, "kernel_tflops": 2.0 * e * c * d * f
              / (t["kernel_ms"] * 1e-3) / 1e12,
              "kernel_tb_per_s": (e * c * d + e * d * f + e * c * f) * 2
              / (t["kernel_ms"] * 1e-3) / 1e12, "card": smi})
        if label == "prefill_wi":
            timings["grouped_matmul"] = dict(t, ms=t["kernel_ms"])
        del x, w, ws

    ssd_family_ms = {}
    for case in (SSD_PREFILL, SSD_PREFILL_256, SSD_ZAMBA2):
        b, s, nh, hd, ds, ch = case
        nc = s // ch
        # input sets past the L2: each of the served path's 48 layers calls
        # the kernel on its own inputs
        sets = [ssd_kernel_inputs(*ssd_inputs(b, s, nh, hd, ds, gen), ch)
                for _ in range(2 + 2 * L2_BYTES
                               // ssd_set_bytes(b, s, nh, hd, ds, ch))]
        a, xdt, Bc, Cc = sets[0]
        t = {"kernel_ms": cold_ms(lambda st: ssd_ops.ssd_intra_chunk(*st),
                                  sets, 40),
             "kernel_warm_ms": cuda_ms(
                 lambda: ssd_ops.ssd_intra_chunk(a, xdt, Bc, Cc), 40),
             "plain_ms": cuda_ms(lambda: ssd_intra_chunk_ref(a, xdt, Bc, Cc),
                                 10),
             "library_ms": None,     # no one PyTorch call computes it
             "input_sets": len(sets),
             "y_blocks": ssd_ops.y_blocks(b, nh, nc, ch)}
        t["bound_ms"], t["bound_by"] = ssd_bound_ms(b, nh, nc, ch, hd, ds)
        t["bound_f32_simt_ms"], t["bound_f32_simt_by"] = ssd_bound_ms(
            b, nh, nc, ch, hd, ds, peak=H100_F32_FLOPS, passes=1)
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        t["share_of_f32_simt_bound"] = t["bound_f32_simt_ms"] / t["kernel_ms"]
        t["host_us_per_call"] = host_us(
            lambda: ssd_ops.ssd_intra_chunk(a, xdt, Bc, Cc))
        emit({"phase": "timing", "kernel": "ssd",
              "shape": {"b": b, "nh": nh, "nc": nc, "c": ch, "hd": hd,
                        "ds": ds}, "dtype": "float32", **t, "card": smi,
              "seconds": time.perf_counter() - t0})
        if case == SSD_PREFILL:
            timings["ssd"] = dict(t, ms=t["kernel_ms"])
        ssd_family_ms[case] = t["kernel_ms"]
        kernels["ssd"].setdefault("by_shape", []).append(dict(t, shape=case))
        del a, xdt, Bc, Cc, sets

    # the backward kernels at the training path's shapes: the kernel, the
    # plain backward and the library's backward (autograd through SDPA, no
    # softcap, a window as a band mask; through torch.bmm), each with its forward recorded once
    def time_flash_bwd(case) -> dict:
        b, s, h, kv, d, win, cap = case
        q, k, v = (randn((b, s, n, d), dtype, gen) for n in (h, kv, kv))
        dout = randn((b, s, h, d), dtype, gen)
        out, lse = fa_ops._forward(q, k, v, True, win, cap, with_lse=True)
        t = {"kernel_ms": cuda_ms(lambda: fa_ops.flash_attention_bwd(
            q, k, v, out, dout, lse, window=win, softcap=cap), 10)}
        t["ms"] = t["kernel_ms"]
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        ref = attention_ref(qr, kr, vr, window=win, softcap=cap)
        t["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
            ref, (qr, kr, vr), dout, retain_graph=True), 3)
        del ref
        t["library_ms"] = None
        if not cap:
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            if win and win < s:     # the causal band as an explicit mask
                pos = torch.arange(s, device="cuda")
                band = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None]
                                                      < win)
                lib = sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)
            else:
                lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            dt = dout.transpose(1, 2)
            t["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                lib, (qt, kt, vt), dt, retain_graph=True), 10)
            del lib
        t["bound_ms"], t["bound_by"] = attention_bwd_bound_ms(
            b, s, h, kv, d, win, dtype)
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        t["kernel_tflops"] = 10.0 * d * b * h * attention_pairs(s, win) \
            / (t["kernel_ms"] * 1e-3) / 1e12
        emit({"phase": "timing", "kernel": "flash_attention_bwd",
              "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": d},
              "window": win, "softcap": cap, "dtype": "bfloat16", **t,
              "earlier_ms": EARLIER_MS.get(tuple(case)), "card": smi})
        return t

    def time_gmm_bwd(case) -> dict:
        e, c, d, f = case
        x, w = (randn(shape, dtype, gen, 0.3) for shape in ((e, c, d),
                                                            (e, d, f)))
        dy = randn((e, c, f), dtype, gen, 0.3)
        t = {"kernel_ms": cuda_ms(lambda: gmm_ops.grouped_matmul_bwd(
            x, w, dy), 20)}
        t["ms"] = t["kernel_ms"]
        xr, wr = (a.detach().requires_grad_() for a in (x, w))
        for key, fn in (("plain_ms", grouped_matmul_ref),
                        ("library_ms", torch.bmm)):
            y = fn(xr, wr)
            t[key] = cuda_ms(lambda: torch.autograd.grad(
                y, (xr, wr), dy, retain_graph=True), 10)
        t["bound_ms"], t["bound_by"] = gmm_bwd_bound_ms(e, c, d, f, dtype)
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        emit({"phase": "timing", "kernel": "grouped_matmul_bwd",
              "shape": {"E": e, "C": c, "d": d, "f": f}, "dtype": "bfloat16",
              **t, "earlier_ms": EARLIER_MS.get(tuple(case)), "card": smi})
        return t

    timings["flash_attention_bwd"] = time_flash_bwd(YI_TRAIN_ATTN)
    kernels["flash_attention_bwd"]["by_shape"] = [
        dict(time_flash_bwd(case), shape=case) for case in (
            GRANITE_TRAIN_ATTN, GEMMA3_TRAIN_ATTN, GEMMA3_UNWINDOWED_ATTN)]
    timings["grouped_matmul_bwd"] = time_gmm_bwd(GMM_BWD[0])
    kernels["grouped_matmul_bwd"]["by_shape"] = [
        dict(time_gmm_bwd(GMM_BWD[1]), shape=GMM_BWD[1])]

    # one profiled call of each backward, its device work by name: the bf16
    # grouped-matmul backward launches its two products and nothing else
    # (no transposed copy, pad or cast); the flash backward D = rowsum(dO *
    # O), the main kernel, the dQ cast and the zeroing of its f32 dQ buffer
    e, c, d, f = GMM_BWD[0]
    x, w = (randn(shape, dtype, gen, 0.3) for shape in ((e, c, d), (e, d, f)))
    dy = randn((e, c, f), dtype, gen, 0.3)
    names = {n: calls for n, (_, calls) in device_kernels(
        lambda: gmm_ops.grouped_matmul_bwd(x, w, dy)).items()}
    roles = {n: "dx" if "gmm_dx_kernel" in n else
             "dw" if "gmm_dw_kernel" in n else None for n in names}
    ok = sorted(map(str, roles.values())) == ["dw", "dx"] and \
        set(names.values()) == {1}
    emit({"phase": "profiled_bwd", "kernel": "grouped_matmul_bwd",
          "shape": {"E": e, "C": c, "d": d, "f": f}, "dtype": "bfloat16",
          "device_kernels": names, "ok": ok})
    if not ok:
        fail(f"grouped_matmul_bwd launched more than its two products: "
             f"{names}")
    del x, w, dy
    b, s, h, kv, d, win, cap = YI_TRAIN_ATTN
    q, k, v = (randn((b, s, n, d), dtype, gen) for n in (h, kv, kv))
    dout = randn((b, s, h, d), dtype, gen)
    out, lse = fa_ops._forward(q, k, v, True, win, cap, with_lse=True)
    names = {n: calls for n, (_, calls) in device_kernels(
        lambda: fa_ops.flash_attention_bwd(
            q, k, v, out, dout, lse, window=win, softcap=cap)).items()}
    roles = {n: "D" if "delta_kernel" in n else
             "main" if "bwd_wg::bwd_kernel" in n else
             "dQ cast" if "dq_cast_kernel" in n else
             "dQ buffer zeroed" if "Memset" in n or "FillFunctor" in n
             else None for n in names}
    ok = sorted(map(str, roles.values())) == sorted(
        ["D", "main", "dQ cast", "dQ buffer zeroed"])
    emit({"phase": "profiled_bwd", "kernel": "flash_attention_bwd",
          "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": d},
          "dtype": "bfloat16", "device_kernels": names,
          "roles": list(roles.values()), "ok": ok})
    if not ok:
        fail(f"flash_attention_bwd launched {names}")
    # dQ is summed by f32 atomics, in an order that varies from run to
    # run: two calls on the same inputs, dK and dV equal bit for bit, dQ
    # within the bf16 tolerance of the checks (0.02 of its largest
    # magnitude)
    spread = {}
    for case in (YI_TRAIN_ATTN, GRANITE_TRAIN_ATTN):
        if case != YI_TRAIN_ATTN:
            b, s, h, kv, d, win, cap = case
            q, k, v = (randn((b, s, n, d), dtype, gen) for n in (h, kv, kv))
            dout = randn((b, s, h, d), dtype, gen)
            out, lse = fa_ops._forward(q, k, v, True, win, cap, with_lse=True)
        one, two = (fa_ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                               window=win, softcap=cap)
                    for _ in range(2))
        top = float(one[0].float().abs().max())
        rel = float((one[0].float() - two[0].float()).abs().max()) / top
        same = torch.equal(one[1], two[1]) and torch.equal(one[2], two[2])
        spread[str(case)] = rel
        emit({"phase": "flash_bwd_spread", "shape": {"B": b, "S": s, "H": h,
                                                      "KV": kv, "D": d},
              "dtype": "bfloat16", "dq_max_diff_of_max": rel,
              "dq_elements_unequal": int((one[0] != two[0]).sum()),
              "dk_dv_equal": same, "tol_of_max": 2e-2, "card": smi})
        if not same or rel > 2e-2:
            fail(f"flash_attention_bwd: two calls differ (dq {rel} of its "
                 f"max, dk and dv equal: {same})")
    kernels["flash_attention_bwd"]["dq_run_to_run_of_max"] = spread
    del q, k, v, dout, out, lse, one, two

    # the SSD backward at the training microbatches: cold (input sets past
    # the L2, as each of a step's layers finds its own), warm, the plain
    # backward; no one PyTorch call computes it. Then one profiled call:
    # the four grids of the kernel, each once, and nothing else (the wrapper
    # only allocates); a second call gives the same bits
    def time_ssd_bwd(case) -> dict:
        b, s, nh, hd, ds, ch = case
        nc = s // ch

        def one_set():
            a, xdt, Bc, Cc = ssd_kernel_inputs(
                *ssd_inputs(b, s, nh, hd, ds, gen, wide_decay=True), ch)
            return (a, xdt, Bc.contiguous(), Cc.contiguous(),
                    randn(xdt.shape, torch.float32, gen),
                    randn((b, nh, nc, ds, hd), torch.float32, gen))
        sets = [one_set() for _ in range(
            2 + 2 * L2_BYTES // ssd_bwd_set_bytes(b, s, nh, hd, ds, ch))]
        first = sets[0]
        t = {"kernel_ms": cold_ms(lambda st: ssd_ops.ssd_intra_chunk_bwd(
            *st), sets, 10),
             "kernel_warm_ms": cuda_ms(
                 lambda: ssd_ops.ssd_intra_chunk_bwd(*first), 10),
             "input_sets": len(sets)}
        t["ms"] = t["kernel_ms"]
        ins = [x.detach().requires_grad_() for x in first[:4]]
        ref = ssd_intra_chunk_ref(*ins)
        t["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
            ref, ins, first[4:], retain_graph=True), 3)
        del ref
        t["library_ms"] = None
        t["bound_ms"], t["bound_by"] = ssd_bwd_bound_ms(b, nh, nc, ch, hd,
                                                        ds)
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        t["host_us_per_call"] = host_us(
            lambda: ssd_ops.ssd_intra_chunk_bwd(*first))
        shape = {"b": b, "nh": nh, "nc": nc, "c": ch, "hd": hd, "ds": ds}
        # the wrapper's workspace bytes, from its shapes, on this line only
        emit({"phase": "timing", "kernel": "ssd_bwd", "shape": shape,
              "dtype": "float32", **t,
              "workspace_bytes": ssd_ops.bwd_workspace_bytes(b, nh, nc, ch,
                                                             ds),
              "earlier_ms": EARLIER_MS.get(tuple(case)), "card": smi})
        grids = device_kernels(lambda: ssd_ops.ssd_intra_chunk_bwd(*first))
        roles = {n: next((r for g, r in SSD_BWD_GRIDS.items() if g in n),
                         None) for n in grids}
        whole = sorted(map(str, roles.values())) == sorted(
            SSD_BWD_GRIDS.values()) and \
            all(calls == 1 for _, calls in grids.values())
        one, two = (ssd_ops.ssd_intra_chunk_bwd(*first) for _ in range(2))
        same = all(torch.equal(g, h) for g, h in zip(one, two))
        ok = whole and same
        emit({"phase": "profiled_bwd", "kernel": "ssd_bwd", "shape": shape,
              "dtype": "float32",
              "device_ms_by_grid": {roles[n]: ms
                                    for n, (ms, _) in grids.items()},
              "device_kernels": {n: calls for n, (_, calls) in grids.items()},
              "run_to_run_equal": same,
              "ok": ok, "card": smi})
        if not ok:
            fail(f"ssd_bwd at {case} launched {grids} (two calls equal: "
                 f"{same})")
        t["device_ms_by_grid"] = {roles[n]: ms
                                  for n, (ms, _) in grids.items()}
        t["run_to_run_equal"] = same
        return t

    timings["ssd_bwd"] = time_ssd_bwd(MAMBA2_TRAIN_SSD)
    kernels["ssd_bwd"]["by_shape"] = [
        dict(time_ssd_bwd(ZAMBA2_TRAIN_SSD), shape=ZAMBA2_TRAIN_SSD)]
    emit({"phase": "timing", "seconds": time.perf_counter() - t0})
    for name, t in timings.items():
        kernels[name].update(t)
    kernels["flash_attention"]["by_served_shape"] = [
        t for ts in flash_family.values() for t in ts]

    # -- 4b. training on the card -----------------------------------------
    train_counts = training_phases(smi, ops)

    # -- 5. full width, depth 2, float32: engine tokens == a reference -----
    def faults(monitor) -> list:
        return [e for e in monitor.events() if e["event"] in FAULTS]

    def parity_model(arch, layers=2):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        model = build_model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(1))
        return cfg, model, params

    def margin(model, params, prompt, want, got):
        """Where tokens differ: the oracle's logit margin between its token
        and the engine's at the first differing position (a near tie shows
        as a margin near 0)."""
        i = int(np.argmax(want[:len(got)] != got[:len(want)]))
        ctx = np.concatenate([prompt, want[:i]])
        with torch.inference_mode():
            logits, _ = model.prefill(params, torch.as_tensor(
                ctx, dtype=torch.long, device="cuda")[None], len(ctx))
        lg = logits[0, -1]
        return {"position": i, "oracle": int(want[i]), "engine": int(got[i]),
                "margin": float(lg[int(want[i])] - lg[int(got[i])])}

    def check_tokens(phase, model, params, prompts, got, want, **info):
        mismatched = [{"prompt_len": len(p), "engine": g.tolist(),
                       "reference": w.tolist(),
                       **(margin(model, params, p, w, g)
                          if len(g) and len(w) else {})}
                      for p, g, w in zip(prompts, got, want)
                      if g.shape != w.shape or not np.array_equal(g, w)]
        emit({"phase": phase, **info, "prompt_lens": [len(p) for p in prompts],
              "identical": not mismatched, "mismatched": mismatched})
        if mismatched:
            fail(f"{phase} {info}: engine tokens differ from the reference")

    def parity(arch, lens, against, built=None, max_seq=640):
        t0 = time.perf_counter()
        cfg, model, params = built or parity_model(arch)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in lens]

        def engine_tokens(m, p, dev):
            eng = ServingEngine(m, p, slots=4, max_seq=max_seq, device=dev)
            futs = [eng.submit(x, max_new_tokens=16) for x in prompts]
            eng.run_until_idle()
            return [f.result() for f in futs], eng.metrics["prefills"]

        got, prefills = engine_tokens(model, params, "cuda")
        if against == "cpu_engine":
            cpu_model = build_model(cfg, device="cpu")
            want, cpu_prefills = engine_tokens(
                cpu_model, to_device(params, "cpu"), "cpu")
            if cpu_prefills != prefills:
                fail(f"{arch}: {prefills} prefill calls on the card, "
                     f"{cpu_prefills} on the CPU")
        else:
            want = [greedy_generate(model, params, x, 16, max_seq)
                    for x in prompts]
        check_tokens("parity_full_width_f32", model, params, prompts, got,
                     want, arch=arch, layers=cfg.num_layers,
                     d_model=cfg.d_model, max_seq=max_seq, against=against,
                     prefill_calls=prefills, new_tokens=16,
                     seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()

    def feature_parity(cfg, model, params):
        """yi-9b's chunked prefill, prefix cache and speculation at full
        width: (a) chunks of 128, (b) a 384-token shared head then the head
        alone twice (whole-prompt hits), (c) speculate 4 with each draft and
        a prompt that runs into max_seq, (d) speculation with chunking."""
        rng = np.random.default_rng(2)
        lens = (64, 200, 377, 512)
        prompts = [rng.integers(1, cfg.vocab_size, size=n)
                   for n in lens + (600,)]
        oracle = {}

        def want(p, n=16):
            key = (len(p), int(p[0]), n)
            if key not in oracle:
                oracle[key] = greedy_generate(model, params, p, n, 640)
            return oracle[key]

        def run(case, ps, against=None, n=16, **kw):
            t0 = time.perf_counter()
            mon = Monitor()
            eng = ServingEngine(model, params, slots=4, max_seq=640,
                                device="cuda", monitor=mon, **kw)
            futs = [eng.submit(p, max_new_tokens=n) for p in ps]
            eng.run_until_idle()
            got = [f.result() for f in futs]
            ref = against or [want(p, n) for p in ps]
            m = {k: v for k, v in eng.metrics.items() if v}
            check_tokens("parity_full_width_f32", model, params, ps, got, ref,
                         arch=cfg.name, case=case, layers=cfg.num_layers,
                         against="plain engine" if against else
                         "greedy_oracle", new_tokens=n, metrics=m,
                         faults=faults(mon),
                         seconds=time.perf_counter() - t0)
            if faults(mon):
                fail(f"{case}: {faults(mon)}")
            return eng, got

        # the logits themselves: a 512-token prompt in four chunks against
        # the whole-prompt prefill (flash kernel) at its last position, then
        # a 5-token verify against 5 decode steps; error relative to the
        # reference's largest logit (f32 summation order)
        toks = torch.as_tensor(prompts[3], device="cuda")[None]
        with torch.inference_mode():
            ref, _ = model.prefill(params, toks, 640)
            cache = model.init_cache(1, 640)
            for s in range(0, 512, 128):
                got, _ = model.prefill_chunk(params, cache,
                                             toks[:, s:s + 128],
                                             torch.tensor([s]))
            stepped = [{k: x.clone() for k, x in c.items()} for c in cache]
            cand = toks[:, 100:105]
            verify, _ = model.decode_verify(params, cache, cand,
                                            torch.tensor([512]))
            steps = torch.cat([model.decode(params, stepped,
                                            cand[:, j:j + 1],
                                            torch.tensor([512 + j]))[0]
                               for j in range(5)], dim=1)

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())
        errs = {"chunks_vs_prefill": rel(got[:, -1:], ref),
                "verify_vs_decode_steps": rel(verify, steps)}
        emit({"phase": "parity_full_width_f32", "arch": cfg.name,
              "case": "chunk_and_verify_logits", "relative_errors": errs,
              "tol": 1e-4})
        if max(errs.values()) > 1e-4:
            fail(f"chunk/verify logits: {errs}")
        del cache, stepped

        eng, _ = run("chunk_128", prompts, chunk_tokens=128)
        if eng.metrics["prefill_chunks"] != 2 + 3 + 4 + 5:
            fail(f"chunk_128: {eng.metrics['prefill_chunks']} chunks")
        # (b) two prompts on one 384-token head, one after the other; then
        # the head alone twice: whole-prompt hits, no chunk computed
        head = rng.integers(1, cfg.vocab_size, size=384)
        shared = [np.concatenate([head, rng.integers(1, cfg.vocab_size,
                                                     size=n)])
                  for n in (100, 150)]
        pc = PrefixCache(128, budget_bytes=1 << 30)
        eng, _ = run("prefix_first", shared[:1], chunk_tokens=128,
                     prefix_cache=pc)
        hits = []
        for p, case in ((shared[1], "prefix_shared_head"),
                        (head, "prefix_whole_prompt"),
                        (head, "prefix_whole_prompt_again")):
            before = dict(eng.metrics)
            fut = eng.submit(p, max_new_tokens=16)
            eng.run_until_idle()
            check_tokens("parity_full_width_f32", model, params, [p],
                         [fut.result()], [want(p)], arch=cfg.name, case=case,
                         against="greedy_oracle", prefix_cache=pc.stats(),
                         faults=faults(eng.monitor))
            if faults(eng.monitor):
                fail(f"{case}: {faults(eng.monitor)}")
            hits.append((eng.metrics["prefix_hit_tokens"]
                         - before["prefix_hit_tokens"],
                         eng.metrics["prefill_chunks"]
                         - before["prefill_chunks"]))
        # the shared head's 150-token tail takes two chunks; the bare head
        # is covered whole and computes none
        if hits != [(384, 2), (384, 0), (384, 0)]:
            fail(f"prefix cache: (hit tokens, chunks) per request {hits}")
        # (c) speculation, each draft; the 620-token prompt runs into
        # max_seq (640 - 620 = 20 tokens of its 32), against the plain engine
        near_end = rng.integers(1, cfg.vocab_size, size=620)
        plain_eng = ServingEngine(model, params, slots=4, max_seq=640,
                                  device="cuda")
        f = plain_eng.submit(near_end, max_new_tokens=32)
        plain_eng.run_until_idle()
        plain = f.result()
        if len(plain) != 20:
            fail(f"the plain engine emitted {len(plain)} tokens near max_seq")
        del plain_eng
        for kind in ("ngram", "model"):
            eng, _ = run(f"speculate_4_{kind}", prompts[:4], speculate=4,
                         draft=build_draft(kind, cfg, slots=4, max_seq=640,
                                           device="cuda"))
            if not eng.metrics["spec_steps"]:
                fail(f"speculate_4_{kind}: no verify step")
            run(f"speculate_4_{kind}_seq_limit", [near_end], against=[plain],
                n=32, speculate=4, draft=build_draft(
                    kind, cfg, slots=4, max_seq=640, device="cuda"))
        # (d) speculation and chunking in one engine
        eng, _ = run("speculate_4_ngram_chunk_128", prompts[:4], speculate=4,
                     draft=build_draft("ngram", cfg, slots=4, max_seq=640),
                     chunk_tokens=128)
        if not (eng.metrics["spec_steps"] and eng.metrics["prefill_chunks"]):
            fail(f"speculation with chunking: {eng.metrics}")
        torch.cuda.empty_cache()

    def padding_safe_features(cfg, model, params):
        """gemma2 is padding-safe at max_seq 2048 (its window is 4096):
        chunks of 256, a 1 GiB prefix cache and speculate 4 (n-gram) in one
        engine, against the greedy oracle. A prompt on a 512-token head,
        then a second on the same head, the head alone (a whole-prompt hit)
        and a short prompt (the padded batched prefill)."""
        t0 = time.perf_counter()
        rng = np.random.default_rng(4)
        head = rng.integers(1, cfg.vocab_size, size=HEAD)
        prompts = [np.concatenate([head, rng.integers(1, cfg.vocab_size,
                                                      size=n)])
                   for n in (300, 133)] + [head, rng.integers(
                       1, cfg.vocab_size, size=100)]
        pc = PrefixCache(CHUNKED["chunk_tokens"], budget_bytes=1 << 30)
        mon = Monitor()
        eng = ServingEngine(model, params, slots=4, max_seq=2048,
                            device="cuda", monitor=mon, prefix_cache=pc,
                            chunk_tokens=CHUNKED["chunk_tokens"],
                            speculate=4, draft=NgramDraft())
        got = []
        for wave in (prompts[:1], prompts[1:]):    # the head cached first
            futs = [eng.submit(p, max_new_tokens=16) for p in wave]
            eng.run_until_idle()
            got += [f.result() for f in futs]
        m = {k: v for k, v in eng.metrics.items() if v}
        check_tokens("parity_full_width_f32", model, params, prompts, got,
                     [greedy_generate(model, params, p, 16, 2048)
                      for p in prompts],
                     arch=cfg.name, case="chunk_256_prefix_speculate_4_ngram",
                     layers=cfg.num_layers, max_seq=2048,
                     against="greedy_oracle", metrics=m,
                     prefix_cache=pc.stats(), faults=faults(mon),
                     seconds=time.perf_counter() - t0)
        # the second prompt and the bare head each restore the head
        if faults(mon) or not m.get("prefill_chunks") or \
                not m.get("spec_steps") or \
                m.get("prefix_hit_tokens") != 2 * HEAD:
            fail(f"gemma2 chunk + prefix + speculate: {m}, {faults(mon)}")
        torch.cuda.empty_cache()

    built = parity_model("yi-9b")
    parity("yi-9b", (64, 200, 377, 512), "greedy_oracle", built)
    feature_parity(*built)
    del built
    # one repeated length: granite admits one exact group per length
    parity("granite-moe-1b-a400m", (64, 200, 200, 377), "cpu_engine")
    parity("mamba2-370m", (64, 200, 377, 512), "greedy_oracle")
    # the sliding-window and hybrid families: gemma2 (2 layers, local and
    # global) with its capacity features; gemma3 at one super-block (5
    # local + 1 global) on prompts past the 1024 window, so its rolling
    # caches wrap in prefill and decode; qwen2 (2 layers); zamba2 at 8
    # layers (one segment of 6, one shared-block application, 2 trailing)
    built = parity_model("gemma2-27b")
    parity("gemma2-27b", (64, 200, 377, 512), "greedy_oracle", built)
    padding_safe_features(*built)
    del built
    parity("gemma3-12b", (300, 1100, 1500, 1900), "greedy_oracle",
           parity_model("gemma3-12b", 6), max_seq=2048)
    parity("qwen2-72b", (64, 200, 377, 512), "greedy_oracle")
    parity("zamba2-1.2b", (64, 200, 377, 512), "greedy_oracle",
           parity_model("zamba2-1.2b", 8))

    # -- 6. serve each model at full depth, bf16, through the entry points --
    variant_counts = {}      # grouped matmul kernels of each served run

    def serve(arch, expect, label=None, prompts=None, **knobs):
        """Drive the served path of ``arch`` (a name, or a config such as
        a depth cut) with every launch count set to 0 just before and read
        just after; fail unless every request completes, no fault is
        logged, and the counts are ``expect(prefill calls, decode steps,
        draft syncs)``. ``knobs`` go to ``build_replicaset`` (chunking,
        prefix cache, speculation, params to reuse)."""
        t0 = time.perf_counter()
        cfg = get_config(arch) if isinstance(arch, str) else arch
        torch.cuda.reset_peak_memory_stats()
        monitor = Monitor()
        rs = build_replicaset(cfg, monitor=monitor, **SERVE, **knobs)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        # drawn even when ``prompts`` replaces them, so every run's
        # arrivals follow one Poisson schedule
        load = make_prompts(LOAD["requests"], cfg.vocab_size, rng,
                            lo=LOAD["lo"], hi=LOAD["hi"])
        prompts = load if prompts is None else prompts
        for op in ops.values():
            op.launches = 0
        gmm_ops.launches_by_variant.update(
            dict.fromkeys(gmm_ops.launches_by_variant, 0))
        rs.start()
        try:
            report = run_load(rs, prompts, rate_rps=LOAD["rate_rps"],
                              max_new_tokens=LOAD["max_new_tokens"], rng=rng,
                              timeout_s=600.0)
        finally:
            rs.stop()
        launches = {name: op.launches for name, op in ops.items()}
        by_variant = variant_counts[cfg.name] = dict(
            gmm_ops.launches_by_variant)
        metrics = rs.metrics()
        total = metrics["total"]
        prefills, steps = total["prefills"], total["decode_steps"]
        syncs = sum(getattr(e.draft, "syncs", 0) for e in rs.engines)
        want = expect(prefills, steps, syncs)
        logged = [e for e in monitor.events() if e["event"] in FAULTS]
        emit({"phase": "serve", "arch": cfg.name, "run": label or cfg.name,
              "layers": cfg.num_layers, "dtype": cfg.dtype, **SERVE,
              **{k: v for k, v in knobs.items() if k != "params"},
              "prompt_lens": [len(p) for p in prompts],
              "rate_rps": LOAD["rate_rps"],
              "max_new_tokens": LOAD["max_new_tokens"], "report": report,
              "totals_with_warmup": total,
              "prefill_calls": prefills,
              "prefill_requests": total["prefill_requests"],
              "decode_steps": steps,
              "draft_syncs": syncs,
              "launches": launches, "expected_launches": want,
              "grouped_matmul_launches_by_variant": by_variant,
              "faults_logged": logged,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "init_seconds": init_s, "card": smi,
              "seconds": time.perf_counter() - t0})
        n = len(prompts)
        if report["completed"] != n or \
                report["tokens"] != n * LOAD["max_new_tokens"]:
            fail(f"{label or cfg.name}: served {report['completed']}/{n} "
                 f"requests, {report['tokens']}/"
                 f"{n * LOAD['max_new_tokens']} tokens")
        if logged:
            fail(f"{label or cfg.name}: faults logged: {logged}")
        if prefills <= 0 or launches != want:
            fail(f"{label or cfg.name}: kernel launches {launches}, expected "
                 f"{want} for {prefills} prefill calls, {steps} decode steps "
                 f"and {syncs} draft syncs")
        # bf16 MoE: every prefill group's capacity (>= 80 at 256 tokens)
        # takes the tile kernel, every 4-slot decode step's (2) the
        # streaming kernel; serving runs no backward
        per_call = want["grouped_matmul"] // max(prefills + steps, 1)
        want_variants = {"tile": per_call * prefills,
                         "stream": per_call * steps, "dx": 0, "dw": 0,
                         "f32": 0}
        if by_variant != want_variants:
            fail(f"{cfg.name}: grouped matmul kernels {by_variant}, expected "
                 f"{want_variants}")
        return rs, cfg, launches

    def breakdown(rs, cfg, rows, shares, serving_features=False,
                  length=1024):
        """Where a step's time goes (after the counted run): one prefill of
        ``rows`` x ``length`` tokens and one fused 4-slot decode step
        (positions on the host, as the engine passes them), host clock to
        the end of the device work, beside the device's busy time in a
        profiled call and so its idle share; ``shares`` maps a kernel to its
        measured time per prefill. ``serving_features`` adds one batched
        chunk call of 4 x 256 at position 1024 (no logits, as the engine
        calls it), one verify step of 4 slots x 5 tokens, one prefix
        restore of a 512-token entry into a slot and one 256-token chunk
        extract."""
        t0 = time.perf_counter()
        eng = rs.engines[0]
        times = {}
        with torch.inference_mode():
            toks = torch.randint(1, cfg.vocab_size, (4, length),
                                 device="cuda",
                                 generator=torch.Generator("cuda")
                                 .manual_seed(2))
            steps = [(f"prefill_{rows}x{length}",
                      lambda: eng.model.prefill(eng.params, toks[:rows],
                                                2048)),
                     ("decode_step_4_slots",
                      lambda: eng.model.decode(eng.params, eng.cache,
                                               toks[:, :1],
                                               torch.full((4,), 1500)))]
            if serving_features:
                entry = eng._pc_extract(0, 0, 512)
                steps += [
                    ("chunk_call_4x256_at_1024",
                     lambda: eng.model.prefill_chunk(
                         eng.params, eng.cache, toks[:, :256],
                         torch.full((4,), 1024), rows=torch.arange(4),
                         logits=False)),
                    ("verify_step_4_slots_x5",
                     lambda: eng.model.decode_verify(
                         eng.params, eng.cache, toks[:, :5],
                         torch.full((4,), 1500))),
                    ("prefix_restore_512", lambda: eng._pc_restore(entry, 1)),
                    ("chunk_extract_256",
                     lambda: eng._pc_extract(0, 256, 256))]
            for label, fn in steps:
                wall = times[f"{label}_ms"] = host_ms(fn)
                busy = times[f"{label}_device_busy_ms"] = device_busy_ms(fn)
                if isinstance(busy, float):
                    times[f"{label}_device_idle_share"] = 1 - busy / wall
        prefill_ms = times[f"prefill_{rows}x{length}_ms"]
        for name, ms in shares.items():
            times[f"{name}_share_of_prefill"] = ms / prefill_ms
        emit({"phase": "serve_breakdown", "arch": cfg.name, **times,
              "card": smi, "seconds": time.perf_counter() - t0})
        return times

    def prefill_calls_in(records) -> float:
        """Batched prefill calls, counted from the records' spans: a call
        of g requests leaves a prefill span with ``group=g`` in each of
        their records."""
        return sum(1.0 / c["attrs"]["group"] for r in records
                   for c in r["trace"].get("children", ())
                   if c["name"] == "prefill"
                   and c.get("attrs", {}).get("mode") == "batched")

    def run_cli(*argv):
        """``python -m repro_torch.cli`` in this process: (its return
        value, its standard output, seconds)."""
        from repro_torch import cli
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ret = cli.main([str(a) for a in argv])
        return ret, out.getvalue(), time.perf_counter() - t0

    def recorder_host_us(path, n: int = 2000) -> dict:
        """Host time a recorded request adds, in microseconds: its trace
        (the engine's spans: queue wait, a batched prefill, a 32-token
        decode) and its record built and queued, as the decode thread pays
        them; the writer thread runs beside, as in serving."""
        from types import SimpleNamespace
        from repro_torch.observability import Recorder, TraceContext

        rec = Recorder(path, tenant="cost", meta={"arch": "yi-9b"})
        engine = SimpleNamespace(name="replica0", device=torch.device("cuda"))
        prompt = np.arange(1, 17, dtype=np.int32)
        t0 = time.perf_counter()
        for _ in range(n):
            r = SimpleNamespace(
                rid=0, tokens=prompt, max_new_tokens=32, eos_id=-1,
                generated=list(range(32)), retries=0,
                submit_t=time.perf_counter(), ttft_s=0.1, latency_s=2.0)
            r.trace = TraceContext("request", rid=0, prompt_len=16,
                                   max_new_tokens=32)
            r.trace.open("queue_wait")
            r.trace.close("queue_wait", replica="replica0", slot=0)
            r.trace.open("prefill", mode="batched", group=1)
            r.trace.close("prefill", tokens=16)
            r.trace.open("decode")
            r.trace.close("decode", tokens=32)
            rec.record(r, engine)
        us = (time.perf_counter() - t0) / n * 1e6
        rec.stop()
        if rec.drops or rec.written != n + 1:
            fail(f"recorder cost: {rec.written} written, {rec.drops} dropped")
        return {"requests": n, "us_per_request": us}

    def recorder_phases(yi, yi_model, yi_params):
        """The flight recorder, replay and the VRE lifecycle on yi-9b:
        (1) a depth-2 float32 pool with a recorder, every record against the
        card's greedy oracle, the file replayed through a pool built from
        its header; (2) ``python -m repro_torch.cli`` init, apply, status,
        serve --record, trace --json and destroy in this process, full
        depth bf16, with the flash launches of the serve command; (3) the
        same serve unrecorded; (4) the recorded file replayed in bf16.
        yi-9b's params reach the CLI through its served-model cache.
        Returns the kernel launches of each ``cli serve`` run."""
        from repro_torch.core import services
        from repro_torch.launch.serve import replicaset_from_meta, replay_file
        from repro_torch.observability import (RecordStore, load_replay,
                                               replay_records)

        tmp = tempfile.TemporaryDirectory()
        work = Path(tmp.name)
        plain = make_prompts(LOAD["requests"], yi.vocab_size,
                             np.random.default_rng(0), lo=LOAD["lo"],
                             hi=LOAD["hi"])

        # (1) record_replay_f32: tokens of every record against the oracle,
        # then a replay through a pool built from the header alone
        t0 = time.perf_counter()
        cfg = dataclasses.replace(yi, num_layers=2, dtype="float32")
        path = work / "f32.jsonl"
        mon = Monitor()
        rs = build_replicaset(cfg, monitor=mon, record_path=str(path),
                              **SERVE)
        rs.start()
        try:
            report = run_load(rs, plain, rate_rps=LOAD["rate_rps"],
                              max_new_tokens=LOAD["max_new_tokens"],
                              rng=np.random.default_rng(0), timeout_s=600.0)
        finally:
            rs.stop()
        recorder, model, params = rs.recorder, rs.engines[0].model, \
            rs.engines[0].params
        del rs
        store = RecordStore.load(path)
        recs = store.records
        budgets = [(r["new_tokens"], r["max_new_tokens"]) for r in recs]
        if len(recs) != LOAD["requests"] + 1 or recorder.drops \
                or any(n != m for n, m in budgets):
            fail(f"record_replay_f32: {len(recs)} records, "
                 f"{recorder.drops} dropped, (tokens, budget) {budgets}")
        prompts = [np.asarray(r["prompt_tokens"]) for r in recs]
        check_tokens("record_replay_f32", model, params, prompts,
                     [np.asarray(r["generated_tokens"], np.int32)
                      for r in recs],
                     [greedy_generate(model, params, p, r["max_new_tokens"],
                                      SERVE["max_seq"])
                      for p, r in zip(prompts, recs)],
                     arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
                     against="greedy_oracle", records=len(recs))
        del model, params
        t1 = time.perf_counter()
        replay = replay_file(path, monitor=mon, timeout_s=600.0)
        emit({"phase": "record_replay_f32", "arch": cfg.name,
              "layers": cfg.num_layers, "dtype": cfg.dtype, **SERVE,
              "report": report, "records": len(recs),
              "recorder": recorder.summary(), "meta": store.meta,
              "replay": replay, "replay_seconds": time.perf_counter() - t1,
              "faults_logged": faults(mon), "card": smi,
              "seconds": time.perf_counter() - t0})
        if replay["token_parity"] != 1.0 or replay["mismatches"] \
                or replay["requests"] != len(recs) or faults(mon):
            fail(f"record_replay_f32: replay {replay}, faults {faults(mon)}")
        torch.cuda.empty_cache()

        # (2) vre_cli: the VRE lifecycle through the CLI, full depth bf16;
        # the served-model cache holds yi-9b's params already on the card
        services._SERVED_MODEL_CACHE[("yi-9b", "h100")] = (
            yi, yi_model, yi_params)
        d, rec = work / "vre", work / "served.jsonl"
        secs = {}
        _, out, secs["init"] = run_cli("init", "h100", d)
        raw = json.loads((d / "vre.json").read_text())
        raw["extra"].update(replicas=1, slots=4, max_seq=2048)
        (d / "vre.json").write_text(json.dumps(raw, indent=2))
        _, out, secs["apply"] = run_cli("apply", "--dir", d)
        applied = json.JSONDecoder().raw_decode(out)[0]
        _, out, secs["status"] = run_cli("status", "--dir", d)
        status = json.loads(out)["status"]
        unhealthy = [n for n, v in status["services"].items()
                     if not v["healthy"]]
        if raw["provider"] != "h100" or unhealthy \
                or set(status["services"]) != set(raw["services"]):
            fail(f"vre_cli: provider {raw['provider']}, services "
                 f"{status['services']}")

        def cli_serve(*extra):
            """``cli serve`` of the measured wave, with the launch counts
            set to 0 just before and read just after."""
            for op in ops.values():
                op.launches = 0
            torch.cuda.reset_peak_memory_stats()
            _, out, sec = run_cli(
                "serve", "--dir", d, "--requests", LOAD["requests"],
                "--rate", LOAD["rate_rps"], "--max-new",
                LOAD["max_new_tokens"], "--seed", 0, *extra)
            launches = {name: op.launches for name, op in ops.items()}
            return json.loads(out), launches, sec, \
                torch.cuda.max_memory_allocated() / 1e9

        events = d / ".vre" / raw["name"] / "events.jsonl"

        def logged_faults():
            return [e for e in map(json.loads, events.read_text()
                                   .splitlines()) if e["event"] in FAULTS]

        # recorded and unrecorded in turns (R, U, U, R), one seed: the same
        # prompts and arrivals in every run
        runs = {}
        for label, extra in (
                ("vre_cli", ("--record", rec)), ("vre_cli_unrecorded", ()),
                ("vre_cli_unrecorded_again", ()),
                ("vre_cli_again", ("--record", work / "again.jsonl"))):
            report, launches, secs[label], peak = cli_serve(*extra)
            # run_load's warmup request is prefilled alone, before the wave
            calls = report["prefills"] + 1
            info = {"report": report, "launches": launches,
                    "prefill_calls_with_warmup": calls,
                    "expected_flash_launches": yi.num_layers * calls,
                    "decode_steps": report["decode_steps"],
                    "wall_s": report["wall_s"],
                    "wall_ms_per_decode_step": report["wall_s"] * 1e3
                    / report["decode_steps"],
                    "peak_memory_gb": peak, "faults_logged": logged_faults()}
            n = LOAD["requests"]
            if report["completed"] != n or \
                    report["tokens"] != n * LOAD["max_new_tokens"] or \
                    launches != {"flash_attention": yi.num_layers * calls,
                                 "grouped_matmul": 0, "ssd": 0} or \
                    info["faults_logged"]:
                emit({"phase": label, **info})
                fail(f"{label}: {report['completed']}/{n} requests, "
                     f"{report['tokens']} tokens, launches {launches} for "
                     f"{calls} prefill calls, faults {info['faults_logged']}")
            runs[label] = info
        _, out, secs["trace"] = run_cli("trace", "--records", rec, "--json")
        traced = json.loads(out)
        recs = RecordStore.load(rec).records
        from_records = prefill_calls_in(recs)
        _, _, secs["destroy"] = run_cli("destroy", "--dir", d)
        emit({"phase": "vre_cli", "deployment": applied, "status": status,
              **runs["vre_cli"], "records": len(recs),
              "prefill_calls_from_records": from_records,
              "trace_summary": traced["summary"],
              "trace_matched": traced["matched"],
              "manifest_after_destroy": (d / "manifest.json").exists(),
              "seconds_per_command": secs, "card": smi})
        want_calls = runs["vre_cli"]["prefill_calls_with_warmup"]
        if len(recs) != LOAD["requests"] + 1 \
                or traced["matched"] != len(recs) \
                or abs(from_records - want_calls) > 1e-9 \
                or (d / "manifest.json").exists():
            fail(f"vre_cli: {len(recs)} records, trace matched "
                 f"{traced['matched']}, {from_records} prefill calls in the "
                 f"records against {want_calls}")
        # (3) vre_cli_unrecorded beside the recorded runs: the recorder's
        # cost lands on the decode thread; its host time per request
        # measured alone
        keys = ("tok_per_s", "ttft_p50_s", "latency_p95_s")
        emit({"phase": "vre_cli_unrecorded", **runs["vre_cli_unrecorded"],
              "side_by_side": {k: {lb: runs[lb]["report"][k] for lb in runs}
                               for k in keys} | {
                  k: {lb: runs[lb][k] for lb in runs}
                  for k in ("decode_steps", "wall_s",
                            "wall_ms_per_decode_step")},
              "recorder_host_us_per_request": recorder_host_us(
                  work / "cost.jsonl"),
              "card": smi})
        services._SERVED_MODEL_CACHE.clear()

        # (4) replay_bf16: the served file re-served through a fresh pool
        # built from its header (yi-9b's params reused); a replay may batch
        # requests otherwise, so bf16 products of other shapes may round
        # otherwise: parity is printed, not held
        t0 = time.perf_counter()
        meta, records = load_replay(rec)
        mon = Monitor()
        rs = replicaset_from_meta(meta, params=yi_params, monitor=mon)
        replayed = []

        def submit(tokens, **kw):
            replayed.append(rs.submit_request(tokens, **kw))
            return replayed[-1]
        rs.start()
        try:
            replay = replay_records(records, submit, timeout_s=600.0)
        finally:
            rs.stop()
        first_diff = None
        for r, q in zip(records, replayed):
            got = [int(t) for t in q.generated]
            if got != r["generated_tokens"]:
                i = next((j for j, (a, b) in enumerate(
                    zip(got, r["generated_tokens"])) if a != b),
                    min(len(got), len(r["generated_tokens"])))
                first_diff = {"rid": r["rid"], "prompt_len": r["prompt_len"],
                              "token_index": i,
                              "recorded": r["generated_tokens"][i:i + 1],
                              "replayed": got[i:i + 1]}
                break
        emit({"phase": "replay_bf16", "meta": meta, "replay": replay,
              "token_parity": replay["token_parity"],
              "mismatches": replay["mismatches"],
              "first_difference": first_diff,
              "faults_logged": faults(mon),
              "wall_s": time.perf_counter() - t0, "card": smi})
        if replay["completed"] != len(records) or faults(mon):
            fail(f"replay_bf16: {replay}, faults {faults(mon)}")
        del rs
        tmp.cleanup()
        return {"yi-9b cli serve --record": runs["vre_cli"]["launches"],
                "yi-9b cli serve": runs["vre_cli_unrecorded"]["launches"]}

    @contextlib.contextmanager
    def patched(obj, name, value):
        """``obj.name`` replaced by ``value`` for the block."""
        old = getattr(obj, name)
        setattr(obj, name, value)
        try:
            yield
        finally:
            setattr(obj, name, old)

    @contextlib.contextmanager
    def counting_prefill(model):
        """Counts the served model's prefill calls (every call launches the
        flash kernel once per layer); the wrapped call is unchanged."""
        calls = [0]
        inner = model.prefill

        def prefill(*a, **kw):
            calls[0] += 1
            return inner(*a, **kw)
        with patched(model, "prefill", prefill):
            yield calls

    def elastic_phases(yi, yi_model, yi_params):
        """Elastic serving, the autoscaler, the fleet arbiter and the
        telemetry plane on yi-9b over shares of the card: (1) elastic_f32, a
        depth-2 float32 VRE at (1, 1) over a pool of 2 shares resized to
        (2, 1) by ``elastic.resize_serving`` with requests in flight, every
        carried and new request against the greedy oracle; (2)
        elastic_serve, ``python -m repro_torch.cli serve --waves 2
        --autoscale --force-resize --telemetry-port 0`` in this process at
        full depth in bf16 on the plain traffic, ``/metrics`` scraped and
        validated once a wave; (3) fleet, ``run_fleet_scenario`` with 2
        tenants over 4 shares, arbitrated (``fleet_telemetry`` scraped
        throughout) and static. Returns the kernel launches of each run."""
        import urllib.request

        from repro_torch import observability
        from repro_torch.core import elastic, services
        from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment
        from repro_torch.device import SHARES_ENV, device_pool
        from repro_torch.fleet import driver as fleet_driver
        from repro_torch.launch import serve as serve_mod
        from repro_torch.observability import validate_exposition

        tmp = tempfile.TemporaryDirectory()
        work = Path(tmp.name)
        out = {}

        def reset_counts():
            for op in ops.values():
                op.launches = 0
            torch.cuda.reset_peak_memory_stats()

        def read_counts():
            return {name: op.launches for name, op in ops.items()}

        def want_flash(layers, calls):
            return {"flash_attention": layers * calls, "grouped_matmul": 0,
                    "ssd": 0}

        def scrape(url) -> dict:
            t0 = time.perf_counter()
            with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
                body = r.read().decode()
                status = r.status
            ms = (time.perf_counter() - t0) * 1e3
            return {"status": status, "ms": ms, "bytes": len(body),
                    "samples": sum(1 for ln in body.splitlines()
                                   if ln and not ln.startswith("#")),
                    "errors": validate_exposition(body)}

        # (1) elastic_f32: the resize with requests in flight, depth 2 f32
        t0 = time.perf_counter()
        cfg = dataclasses.replace(yi, num_layers=2, dtype="float32")
        model = build_model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        services._SERVED_MODEL_CACHE[("yi-9b", "h100")] = (cfg, model, params)
        prompts = make_prompts(5, yi.vocab_size, np.random.default_rng(1),
                               lo=LOAD["lo"], hi=LOAD["hi"])
        n_new = LOAD["max_new_tokens"]
        oracle = [greedy_generate(model, params, p, n_new, SERVE["max_seq"])
                  for p in prompts]
        pool = device_pool("h100", 2)
        vre = VirtualResearchEnvironment(VREConfig(
            name="elastic", mesh_shape=(1, 1), services=["lm-server"],
            arch="yi-9b", provider="h100", workdir=str(work / "elastic"),
            extra={"replicas": "auto", "slots": SERVE["slots"],
                   "max_seq": SERVE["max_seq"]}))
        vre.device_pool = pool
        reset_counts()
        with counting_prefill(model) as calls:
            vre.instantiate()
            rs = vre.service("lm-server").replicaset
            before = rs.placements()
            reqs = [rs.submit_request(p, max_new_tokens=n_new)
                    for p in prompts]
            rs = None
            asked = vre.request_resize((2, 1))
            ev = elastic.resize_serving(vre)
            carried = [r.future.result(timeout=600) for r in reqs]
            rs = vre.service("lm-server").replicaset
            after = rs.placements()
            fresh = [rs.submit_request(p, max_new_tokens=n_new)
                     for p in prompts]
            fresh = [r.future.result(timeout=600) for r in fresh]
            rs = None
            status = vre.status()
            events = [e for e in vre.monitor.events()
                      if e["event"] in ("resize_requested", "resize_applied")
                      or e["event"] in FAULTS]
            vre.destroy()
        launches = read_counts()
        check_tokens("elastic_f32_tokens", model, params, prompts + prompts,
                     [np.asarray(t) for t in carried + fresh],
                     oracle + oracle, arch=cfg.name, layers=cfg.num_layers,
                     dtype=cfg.dtype, against="greedy_oracle",
                     carried_then_new=True)
        shares = [set(v) for v in after.values()]
        disjoint = len(shares) == 2 and all(shares) and \
            shares[0].isdisjoint(shares[1])
        info = {"phase": "elastic_f32", "arch": cfg.name,
                "layers": cfg.num_layers, "dtype": cfg.dtype,
                "pool_shares": [str(d) for d in pool],
                "pool_cards": sorted({str(d.device) for d in pool}),
                "requested": list(asked),
                "placements_before": {n: [str(d) for d in v]
                                      for n, v in before.items()},
                "placements_after": {n: [str(d) for d in v]
                                     for n, v in after.items()},
                "disjoint_shares": disjoint,
                "carried_requests": ev["carried_requests"],
                "downtime_s": ev["downtime_s"],
                "reinstantiate_s": ev["report"].reinstantiate_s,
                "status_after": {k: status[k] for k in (
                    "mesh", "pending_resize", "granted_devices",
                    "generation")},
                "prefill_calls": calls[0], "launches": launches,
                "events": events,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "card": smi, "seconds": time.perf_counter() - t0}
        emit(info)
        if not disjoint or status["pending_resize"] is not None \
                or status["mesh"] != [2, 1] \
                or launches != want_flash(cfg.num_layers, calls[0]) \
                or any(e["event"] in FAULTS for e in events):
            fail(f"elastic_f32: placements {info['placements_after']}, "
                 f"status {info['status_after']}, launches {launches} for "
                 f"{calls[0]} prefill calls")
        out["yi-9b elastic_f32 (2 layers)"] = launches
        del model, params
        services._SERVED_MODEL_CACHE.clear()
        gc.collect()
        torch.cuda.empty_cache()

        # (2) elastic_serve: the CLI's elastic waves, full depth bf16, the
        # plain traffic (the driver's prompt maker gets LOAD's lengths), a
        # pool of 2 shares from the environment, /metrics scraped after
        # every wave
        t0 = time.perf_counter()
        services._SERVED_MODEL_CACHE[("yi-9b", "h100")] = (
            yi, yi_model, yi_params)
        d = work / "dep"
        run_cli("init", "h100", d)
        raw = json.loads((d / "vre.json").read_text())
        raw["extra"].update(replicas="auto", slots=SERVE["slots"],
                            max_seq=SERVE["max_seq"])
        (d / "vre.json").write_text(json.dumps(raw, indent=2))
        servers, scrapes = [], []
        plain_prompts = serve_mod.make_prompts
        plain_load = serve_mod.run_load
        plain_vre_telemetry = observability.vre_telemetry

        def load_prompts(n, vocab, rng, lo=4, hi=17):
            return plain_prompts(n, vocab, rng, lo=LOAD["lo"], hi=LOAD["hi"])

        def load_then_scrape(*a, **kw):
            rep = plain_load(*a, **kw)
            scrapes.append(scrape(servers[-1].url))
            return rep

        def vre_telemetry(*a, **kw):
            servers.append(plain_vre_telemetry(*a, **kw))
            return servers[-1]
        reset_counts()
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(serve_mod, "make_prompts",
                                        load_prompts))
            stack.enter_context(patched(serve_mod, "run_load",
                                        load_then_scrape))
            stack.enter_context(patched(observability, "vre_telemetry",
                                        vre_telemetry))
            calls = stack.enter_context(counting_prefill(yi_model))
            stack.enter_context(contextlib.redirect_stderr(io.StringIO()))
            stack.callback(os.environ.pop, SHARES_ENV, None)
            os.environ[SHARES_ENV] = "2"
            report, _, secs = run_cli(
                "serve", "--dir", d, "--requests", LOAD["requests"],
                "--rate", LOAD["rate_rps"], "--max-new",
                LOAD["max_new_tokens"], "--seed", 0, "--waves", 2,
                "--autoscale", "--force-resize", "--telemetry-port", 0)
        launches = read_counts()
        events = [json.loads(ln) for ln in (
            d / ".vre" / raw["name"] / "events.jsonl").read_text()
            .splitlines()]
        logged = [e for e in events if e["event"] in FAULTS]
        autoscaled = [e for e in events
                      if e["event"].startswith("autoscale.")]
        waves = report["waves"]
        info = {"phase": "elastic_serve", "arch": yi.name,
                "layers": yi.num_layers, "dtype": yi.dtype,
                "command": "cli serve --waves 2 --autoscale --force-resize "
                           "--telemetry-port 0",
                "shares": 2, "traffic": LOAD,
                "tok_per_s_by_wave": [w["tok_per_s"] for w in waves],
                "mesh_by_wave": [w["mesh"] for w in waves],
                "placements_by_wave": [w["placements"] for w in waves],
                "resizes": report["resizes"],
                "completion_rate": report["completion_rate"],
                "final_mesh": report["final_mesh"],
                "autoscaler_actions": [e["event"] for e in autoscaled],
                "scrapes": scrapes, "telemetry": report.get("telemetry"),
                "prefill_calls": calls[0], "launches": launches,
                "faults_logged": logged,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "report": report, "card": smi, "seconds": secs}
        emit(info)
        want = want_flash(yi.num_layers, calls[0])
        if report["completion_rate"] != 1.0 or len(report["resizes"]) != 1 \
                or len(scrapes) != 2 or any(s["errors"] for s in scrapes) \
                or launches != want or logged or calls[0] <= 0:
            fail(f"elastic_serve: completion {report['completion_rate']}, "
                 f"resizes {report['resizes']}, scrape errors "
                 f"{[s['errors'][:3] for s in scrapes]}, launches "
                 f"{launches} against {want}, faults {logged}")
        out["yi-9b cli serve --waves 2"] = launches
        gc.collect()
        torch.cuda.empty_cache()

        # (3) fleet: two tenants over 4 shares of the card, arbitrated with
        # the fleet's telemetry scraped throughout, then static
        fleets = {}
        plain_fleet_telemetry = observability.fleet_telemetry
        for mode in ("arbitrated", "static"):
            t0 = time.perf_counter()
            fleet_scrapes = []
            stop = threading.Event()

            def fleet_telemetry(*a, **kw):
                """The fleet's telemetry server, scraped every 0.5 s until
                the driver stops it."""
                srv = plain_fleet_telemetry(*a, **kw)

                def scraper():
                    while not stop.wait(0.5):
                        try:
                            fleet_scrapes.append(scrape(srv.url))
                        except Exception as exc:
                            fleet_scrapes.append({"errors": [repr(exc)]})
                th = threading.Thread(target=scraper, daemon=True)
                th.start()
                stop_server = srv.stop

                def stop_scraping(*a, **kw):
                    stop.set()
                    th.join(60)
                    return stop_server(*a, **kw)
                srv.stop = stop_scraping
                return srv
            pool = device_pool("h100", 4)
            reset_counts()
            with contextlib.ExitStack() as stack:
                stack.enter_context(patched(observability, "fleet_telemetry",
                                            fleet_telemetry))
                calls = stack.enter_context(counting_prefill(yi_model))
                try:
                    rep = fleet_driver.run_fleet_scenario(
                        2, devices=pool, arch="yi-9b", provider="h100",
                        workdir=str(work / f"fleet-{mode}"),
                        requests_per_phase=16, rate_rps=FLEET_RATE,
                        max_new_tokens=16, slots_per_device=2,
                        wave_repeats=1, max_seq=SERVE["max_seq"],
                        chunk_tokens=256, prefix_cache_mb=1024.0,
                        shared_prefix_len=512, static=mode == "static",
                        tick_interval_s=0.05,
                        telemetry_port=0 if mode == "arbitrated" else None,
                        rng=np.random.default_rng(0))
                finally:
                    stop.set()
            launches = read_counts()
            hits = [{n: p["prefix_hit_tokens"] for n, p in ph.items()}
                    for ph in rep["phases"]]
            fleets[mode] = rep
            info = {"phase": "fleet", "mode": mode, "arch": yi.name,
                    "layers": yi.num_layers, "dtype": yi.dtype,
                    "pool_shares": [str(d) for d in pool],
                    "pool_cards": sorted({str(d.device) for d in pool}),
                    "requests_per_phase": 16, "max_new_tokens": 16,
                    "rate_rps": FLEET_RATE, "slots_per_device": 2,
                    "shared_prefix_len": 512,
                    "completion_rate": rep["completion_rate"],
                    "tok_per_s": rep["tok_per_s"], "arbiter": rep["arbiter"],
                    "admissions": rep["admissions"],
                    "carried": rep["carried"],
                    "prefix_hit_tokens_by_phase": hits,
                    "meshes_by_phase": [{n: p["mesh"] for n, p in ph.items()}
                                        for ph in rep["phases"]],
                    "scrapes": len(fleet_scrapes),
                    "scrape_ms": [s.get("ms") for s in fleet_scrapes],
                    "scrape_errors": [s["errors"][:3] for s in fleet_scrapes
                                      if s["errors"]],
                    "telemetry": rep.get("telemetry"),
                    "prefill_calls": calls[0], "launches": launches,
                    "peak_memory_gb":
                        torch.cuda.max_memory_allocated() / 1e9,
                    "card": smi, "seconds": time.perf_counter() - t0}
            emit(info)
            cross = hits[1].get("vre1", 0) if mode == "arbitrated" else None
            if rep["completion_rate"] != 1.0 \
                    or rep["carried"]["completed"] != \
                    rep["carried"]["requests"] \
                    or launches != want_flash(yi.num_layers, calls[0]) \
                    or (mode == "arbitrated" and (
                        not cross or not fleet_scrapes
                        or info["scrape_errors"])):
                fail(f"fleet {mode}: completion {rep['completion_rate']}, "
                     f"carried {rep['carried']}, hits {hits}, launches "
                     f"{launches} for {calls[0]} prefill calls, "
                     f"{len(fleet_scrapes)} scrapes")
            out[f"yi-9b fleet {mode}"] = launches
            gc.collect()
            torch.cuda.empty_cache()
        emit({"phase": "fleet_side_by_side", "claimed": None,
              "tok_per_s": {m: r["tok_per_s"] for m, r in fleets.items()},
              "preemptions": {m: r["arbiter"]["preemptions"]
                              for m, r in fleets.items()},
              "card": smi})
        services._SERVED_MODEL_CACHE.clear()
        tmp.cleanup()
        return out

    counts = {}
    yi = get_config("yi-9b")
    rs, cfg, counts["yi-9b"] = serve(
        "yi-9b", lambda p, s, d: {"flash_attention": yi.num_layers * p,
                                  "grouped_matmul": 0, "ssd": 0})
    breakdown(rs, cfg, 4, {"flash_attention": cfg.num_layers * kernel_ms},
              serving_features=True)
    yi_model = rs.engines[0].model          # reused by the runs below
    yi_params = rs.engines[0].params
    del rs
    torch.cuda.empty_cache()

    # chunked prefill and the prefix cache: four short prompts (padded
    # batched prefill on the flash kernel, 48 launches a call) and four on
    # two shared 512-token heads (chunked, in place, no flash kernel); the
    # first prompt is a long one, so run_load's second warmup request hits
    rng = np.random.default_rng(3)
    heads = [rng.integers(1, yi.vocab_size, size=HEAD) for _ in range(2)]
    mixed = []
    for i in range(4):
        mixed.append(np.concatenate([heads[i % 2], rng.integers(
            1, yi.vocab_size, size=int(rng.integers(*TAIL)))]))
        mixed.append(rng.integers(1, yi.vocab_size,
                                  size=int(rng.integers(*SHORT))))
    rs, _, counts["yi-9b chunk+prefix"] = serve(
        "yi-9b", lambda p, s, d: {"flash_attention": yi.num_layers * p,
                                  "grouped_matmul": 0, "ssd": 0},
        label="yi-9b chunk+prefix", prompts=mixed, params=yi_params,
        **CHUNKED)
    total = rs.metrics()["total"]
    hit = total["prefix_hit_tokens"]
    if not total["prefill_chunks"] or not hit or hit % CHUNKED["chunk_tokens"]:
        fail(f"chunk+prefix run: {total['prefill_chunks']} chunks, {hit} "
             f"prefix hit tokens")
    del rs
    # speculation, each draft, on the plain traffic; the model draft's sync
    # prefills launch the flash kernel once per draft layer (2)
    for kind in ("ngram", "model"):
        label = f"yi-9b speculate 4 {kind}"
        rs, _, counts[label] = serve(
            "yi-9b", lambda p, s, d: {
                "flash_attention": yi.num_layers * p + 2 * d,
                "grouped_matmul": 0, "ssd": 0},
            label=label, params=yi_params, speculate=4, draft=kind)
        if not rs.metrics()["total"]["spec_steps"]:
            fail(f"{label}: no verify step")
        del rs
    counts.update(recorder_phases(yi, yi_model, yi_params))
    counts.update(elastic_phases(yi, yi_model, yi_params))
    del yi_model, yi_params
    torch.cuda.empty_cache()

    granite = get_config("granite-moe-1b-a400m")
    rs, cfg, counts["granite-moe-1b-a400m"] = serve(
        "granite-moe-1b-a400m", lambda p, s, d: {
            "flash_attention": granite.num_layers * p,
            "grouped_matmul": 3 * granite.num_layers * (p + s), "ssd": 0})
    breakdown(rs, cfg, 1, {
        "flash_attention": cfg.num_layers * granite_flash_ms,
        "grouped_matmul": cfg.num_layers * (2 * gmm_ms["prefill_wi"]
                                            + gmm_ms["prefill_wo"])})
    del rs
    torch.cuda.empty_cache()

    mamba = get_config("mamba2-370m")
    rs, cfg, counts["mamba2-370m"] = serve(
        "mamba2-370m", lambda p, s, d: {"flash_attention": 0,
                                        "grouped_matmul": 0,
                                        "ssd": mamba.num_layers * p})
    breakdown(rs, cfg, 1, {"ssd": cfg.num_layers * timings["ssd"]["ms"]})
    del rs
    torch.cuda.empty_cache()

    # the sliding-window and hybrid families at full width, bf16, each
    # freed before the next (no two fit the card together): flash attention
    # in every prefill of every run, SSD in every zamba2 prefill
    def release(label):
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "released", "after": label,
              "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})

    gemma2 = get_config("gemma2-27b")
    rs, cfg, counts[gemma2.name] = serve(
        gemma2, lambda p, s, d: {"flash_attention": gemma2.num_layers * p,
                                 "grouped_matmul": 0, "ssd": 0},
        label="serve_gemma2")
    breakdown(rs, cfg, 4, {"flash_attention": cfg.num_layers
                           * flash_family_ms[cfg.name][0]})
    del rs
    release("serve_gemma2")

    # gemma3's long traffic: every prompt past the window, so the local
    # subs' flash launches mask by window, their prefill caches roll and
    # decode wraps from its first step; exact per-length groups
    gemma3 = get_config("gemma3-12b")
    long_prompts = make_prompts(LOAD["requests"], gemma3.vocab_size,
                                np.random.default_rng(0), **LONG)
    rs, cfg, counts[gemma3.name] = serve(
        gemma3, lambda p, s, d: {"flash_attention": gemma3.num_layers * p,
                                 "grouped_matmul": 0, "ssd": 0},
        label="serve_gemma3", prompts=long_prompts)
    local_ms, global_ms = flash_family_ms[cfg.name]
    breakdown(rs, cfg, 1, {"flash_attention": cfg.num_layers // 6 * (
        5 * local_ms + global_ms)}, length=1900)
    del rs
    release("serve_gemma3")

    # qwen2-72b at full width cut to 16 of its 80 layers (80 need ~146 GB
    # in bf16)
    qwen2 = dataclasses.replace(get_config("qwen2-72b"), num_layers=16)
    rs, cfg, counts[f"{qwen2.name} (16 layers)"] = serve(
        qwen2, lambda p, s, d: {"flash_attention": qwen2.num_layers * p,
                                "grouped_matmul": 0, "ssd": 0},
        label="serve_qwen2")
    breakdown(rs, cfg, 4, {"flash_attention": cfg.num_layers
                           * flash_family_ms[cfg.name][0]})
    del rs
    release("serve_qwen2")

    # zamba2: 38 Mamba2 layers on SSD, 6 applications of the shared block
    # on flash attention
    zamba2 = get_config("zamba2-1.2b")
    apps = zamba2.num_layers // zamba2.shared_attn_every
    rs, cfg, counts[zamba2.name] = serve(
        zamba2, lambda p, s, d: {"flash_attention": apps * p,
                                 "grouped_matmul": 0,
                                 "ssd": zamba2.num_layers * p},
        label="serve_zamba2")
    breakdown(rs, cfg, 1, {
        "flash_attention": apps * flash_family_ms[cfg.name][0],
        "ssd": cfg.num_layers * ssd_family_ms[SSD_ZAMBA2]})
    del rs
    release("serve_zamba2")

    # -- 7. kernels, 8. result -------------------------------------------
    layers.flash_attention = flash_wrapper
    mamba2.ssd_chunked = ssd_wrapper
    # the kernel against its plain version at every served flash shape not
    # checked in section 3, in both dtypes
    for case, _ in sorted(flash_served, key=str):
        for dtype in (torch.float32, torch.bfloat16):
            if (case, dtype) not in flash_checked:
                check_flash(case, dtype, phase="kernel_vs_plain_served")
    emit({"phase": "kernel_vs_plain_served", "kernel": "flash_attention",
          "served_shapes": sorted(
              [list(c) + [str(t).removeprefix("torch.")]
               for c, t in flash_served], key=str)})
    # the SSD op at every served shape, with the models' decay range
    # (A = -linspace(1, 16, nh)), against the sequential scan: one launch
    # each
    for case in sorted(ssd_served):
        b, s, nh, hd, ds, ch = case
        inputs = ssd_inputs(b, s, nh, hd, ds, gen, wide_decay=True)
        before = ssd_ops.launches
        y, st = ssd_ops.ssd_chunked(*inputs, ch)
        torch.cuda.synchronize()
        launched = ssd_ops.launches - before
        ry, rst = ssd_ref(*inputs)
        err = max(float((y - ry).abs().max()), float((st - rst).abs().max()))
        ok = launched == 1 and torch.allclose(y, ry, **ssd_tol) and \
            torch.allclose(st, rst, **ssd_tol)
        emit({"phase": "kernel_vs_plain_served", "kernel": "ssd",
              "op": "ssd_chunked", "against": "sequential ssd_ref",
              "shape": {"b": b, "S": s, "nh": nh, "hd": hd, "ds": ds,
                        "chunk": ch}, "launched": launched,
              "dtype": "float32", "max_abs_err": err, "tol": ssd_tol,
              "ok": ok})
        if not ok:
            misses.append(("ssd_chunked", case, "float32"))
    emit({"phase": "kernel_vs_plain_served", "kernel": "ssd",
          "served_shapes": sorted(list(c) for c in ssd_served)})
    if misses:
        fail(f"a kernel disagrees with its plain version at a served "
             f"shape: {misses}")
    # each kernel's launches on its own path's served run; the backward
    # kernels' on the training runs (train_yi9b's 10 steps, train_granite's
    # first 10), beside the forward kernels' there
    own_path = {"flash_attention": "yi-9b",
                "grouped_matmul": "granite-moe-1b-a400m", "ssd": "mamba2-370m"}
    for name, arch in own_path.items():
        kernels[name]["launches"] = counts[arch][name]
        kernels[name]["launches_path"] = arch
        kernels[name]["launches_by_path"] = {a: c[name]
                                             for a, c in counts.items()}
        kernels[name]["launches_by_path"].update(
            {run: c[name] for run, c in train_counts.items()})
    for name, run in (("flash_attention_bwd", "train_yi9b"),
                      ("grouped_matmul_bwd", "train_granite"),
                      ("ssd_bwd", "train_mamba2")):
        kernels[name]["launches"] = train_counts[run][name]
        kernels[name]["launches_path"] = run
        kernels[name]["launches_by_path"] = {r: c[name] for r, c in
                                             train_counts.items()}
    kernels["grouped_matmul"]["launches_by_variant"] = variant_counts[
        "granite-moe-1b-a400m"]
    kernels["grouped_matmul_bwd"]["launches_by_variant"] = {
        k: train_counts["train_granite"]["grouped_matmul_by_variant"][k]
        for k in ("dx", "dw")}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    short = {k["name"]: [n for n in keys if n not in k]
             for k in kernels.values() if any(n not in k for n in keys)}
    if short:
        fail(f"the kernels line lacks {short}")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": device})


if __name__ == "__main__":
    main()
