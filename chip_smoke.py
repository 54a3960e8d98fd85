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
requires warpgroup products (HGMMA) in the flash (at every head dim),
grouped-matmul and SSD backward kernels; the training path: yi-9b at full
width cut to 16 layers on one fixed 4 x 2048 batch (10 steps: finite and
falling losses, step ms, tokens/s, the model FLOPs' share of the bf16 peak,
peak memory, flash launches 2 x 16 a step under remat and backward
launches 16), gemma3-12b at full width cut to 12 of 48 layers (10 layers
with its 1024 window, 2 global; the flash backward at head dim 256) on one
fixed 2 x 2048 batch (6 steps, the same gates and numbers, flash launches
2 x 12 a step and backward launches 12, one profiled step with the flash
backward's share of the busy time), yi-9b at depth 2 in f32 on the card
against the CPU from the same params (3 steps: losses and params; the CPU
halves of these f32 runs go on in a process of their own from the start,
beside the build and the kernel checks), ``repro_torch.launch.train``'s
``run`` for granite-moe-1b-a400m at full width cut to 8 of 24 layers (10
steps in 2 microbatches, saved at the 10th, resumed for 5 more; the
restored state equal to the saved one leaf for leaf) and a VRE's
``lm-trainer`` on provider h100 across a destroy and re-instantiation;
mamba2-370m (2 layers) and zamba2-1.2b (one segment of 6 and the shared
block) in f32 on the card against the CPU (3 steps: losses, grad norms and
params); ``launch.train`` for mamba2-370m at full width cut to 16 of 48
layers (8 x 2048 in 2 microbatches, 10 steps saved at the 10th, resumed
for 5, the restored state equal leaf for leaf) with one profiled step;
zamba2-1.2b at full width and depth on one fixed 4 x 2048 batch (10
steps) with one profiled step; then the ``embeddings`` input mode
(musicgen-medium and internvl2-26b, fed (B, S, d) embeddings): the flash
kernels forward and backward against their plain versions and timed at
their shapes (musicgen's 24 heads of 64, internvl2's 48/8 heads of 128),
musicgen-medium at 2 layers in f32 on the card against the CPU (logits,
prefill + decode against the forward, 3 steps), ``launch.train`` for
musicgen-medium at full width cut to 12 of 48 layers
(8 x 2048 in 2 microbatches, 10 steps saved at the 10th, resumed for 5,
the restored state equal leaf for leaf) with one profiled step,
internvl2-26b at full width and depth (prefill + decode against its
forward), internvl2-26b at full width cut to 4 layers (3 steps) and a
VRE's ``data`` and ``lm-trainer`` on musicgen-medium (3 steps); then the
distributed layer (``distributed_granite``; one spawn of two ranks runs it
and the two-rank sharded phases after it): two ranks share the card over
gloo (``repro_torch.distributed.spawn``; every collective staged through
pinned host memory, counted by op) on a (data 1, model 2) mesh, granite at
full width and 12 of 24 layers in bf16 ("heads" mode: 8 of 16 q heads, 4
of 8 kv heads and 16 of 32 experts a rank, the MoE expert-parallel) for two
sharded train steps against the same steps unsharded (losses, every param
gathered), then at 2 layers in f32 at the CPU tests' tolerances, with each
rank's kernel launches, ms a step and peak memory, and each local kernel
shape against its plain version; then prefill and decode under a policy
(``sharded_phases``): two ranks serve yi-9b (bf16, "heads"),
granite-moe-1b-a400m (bf16, the MoE expert-parallel in prefill and
decode), mamba2-370m (bf16, 16 of 32 SSM heads a rank) and zamba2-1.2b,
each at full width cut to 8 layers (the logit tolerance scaled to that
depth), each prefilling and decoding 16 steps fed
the unsharded model's greedy tokens, logits held to the unsharded ones in
the same run, mamba2 and zamba2 also taking 2 sharded train steps against
unsharded ones; eight ranks run yi-9b at 2 layers in f32 with an "expand"
prefill (4 of 32 q heads a rank, the cache's sequence over model) and a
"head_dim" decode (16 of 128 a rank), greedy tokens equal; each phase with
its exact launches, staged collectives, peak memory and host ms a call a
rank, and each local kernel shape against its plain version; then the
dry-run held to the card (``dryrun_phases``): yi-9b's prefill of 1 x 2048
at 8 layers, a granite-moe-1b-a400m train step of 2 x 2048 at 4 layers
and mamba2-370m's prefill of 1 x 2048 at full depth, each counted by
``repro_torch.launch.op_analysis`` on meta tensors and around the real
step on the card (FLOPs and kernel calls equal, the card's launches equal
to the meta calls, the meta peak within 10% of the rise in
``max_memory_allocated``, the step's ms beside the counted roofline's
dominant term), and ``python -m repro_torch.launch.dryrun --arch yi-9b
--shape prefill_32k --mesh single`` on meta under a fake process group in
a process of its own, off the card, started before the training phases,
its ``[ok]`` line printed; each with
exact forward and backward launch counts; full-width (depth 2, float32)
engine tokens against a reference for yi-9b and mamba2-370m (the card's greedy oracle) and granite-moe-1b-a400m (the
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
served 4-16 token prompts give flash (4, 16)); then the port's five
examples (``examples/torch_*.py``) through their ``main`` at their card
defaults: the workflow pipeline through a straggler and a dead worker, the
quickstart VRE training granite-moe-1b-a400m, the elastic restart of
mamba2-370m at 4 x 32 (the SSD kernels on one padded 256-token chunk),
batched serving of gemma2-27b at 8 layers in float32 held to the greedy
oracle, and ``torch_train_e2e``'s card default, its ``--full`` config (a
137.8M-param model, 300 steps of 8 x 512, saved every 100: tokens/s and the
model FLOPs' share of the bf16 peak over the 300 steps, the median ms a
step, the checkpoint bytes written, one profiled step), each with its exact launches
and peak memory, then every kernel against its plain version at the
examples' shapes, forward and backward; one line with every kernel's
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
import math
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

# each kernel's analytic cost, shared with the dry-run's count
from repro_torch.kernels.costs import (attention_bound_ms,  # noqa: E402
                                       attention_bwd_bound_ms,
                                       attention_pairs, gmm_bound_ms,
                                       gmm_bwd_bound_ms, model_flops,
                                       ssd_bound_ms, ssd_bwd_bound_ms)
# the H100 SXM data sheet's rates, one place for the port and this check
from repro_torch.launch.mesh import (H100_BF16_FLOPS,  # noqa: E402
                                     H100_F32_FLOPS)

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
# train_gemma3's batch of 2, its local layers' and its global layers'
GEMMA3_BATCH_ATTN = [(2, 2048, 16, 8, 256, 1024, 0.0),
                     (2, 2048, 16, 8, 256, 0, 0.0)]
FLASH_BWD = [YI_TRAIN_ATTN, (2, 2048, 32, 4, 128, 0, 0.0), GRANITE_TRAIN_ATTN,
             (1, 1024, 32, 16, 128, 4096, 50.0),
             (2, 1000, 8, 2, 128, 0, 0.0), (1, 1000, 8, 4, 64, 256, 0.0),
             GEMMA3_TRAIN_ATTN, GEMMA3_UNWINDOWED_ATTN, *GEMMA3_BATCH_ATTN]
# q's scale in a softcap case: unit-scale inputs give scaled scores of about
# N(0, 1), where tanh(s / 50) * 50 is s to within 1%; at 8 (a power of two,
# exact in bf16) they reach a sizable share of the cap, and the plain
# backward without the softcap moves dq, dk and dv by several times the bf16
# tolerance
SOFTCAP_Q_SCALE = 8.0
GMM_BWD = [(32, 2560, 1024, 512), (32, 2560, 512, 1024), (32, 157, 1024, 512)]
# the backward kernels that must issue warpgroup products (HGMMA), by
# library: flash attention's one-pass kernels (head dims 64 and 128, and
# 256; each instantiation), the grouped matmul's dx and dw, and the SSD
# backward's four grids
SSD_BWD_GRIDS = {"bwd::bwd_prep_kernel": "prep: C.B^T, cumsums",
                 "bwd::bwd_dg_kernel": "over the heads: dG, P's sums, head "
                                       "term parts",
                 "bwd::bwd_head_kernel": "per head: dxdt, da",
                 "bwd::bwd_dbc_kernel": "dB, dC"}
WGMMA_KERNELS = {"flash_attention": ("bwd_wg::bwd_kernel",
                                     "bwd_wg::bwd_d256_kernel"),
                 "grouped_matmul": ("gmm_dx_kernel", "gmm_dw_kernel"),
                 "ssd": tuple(SSD_BWD_GRIDS)}
# the earlier design's times of the backward kernels (the mma.sync flash
# backward, and at head dim 256 the CUDA-core one, the grouped matmul on
# transposed copies, bf16; the SSD backward's four grids on the CUDA cores,
# f32, cold; ms, PERF.md's table, H100 80GB HBM3 at 700 W) beside this
# run's: flash attention's at train_yi9b's and train_granite's shapes and
# at gemma3-12b's with its window and without, the grouped matmul's at
# granite's wi/wg and wo, the SSD backward's at the training microbatches
# of train_mamba2 and train_zamba2
EARLIER_MS = {(4, 2048, 32, 4, 128, 0, 0.0): 3.552,
              (4, 2048, 16, 8, 64, 0, 0.0): 1.073,
              GEMMA3_TRAIN_ATTN: 7.729, GEMMA3_UNWINDOWED_ATTN: 10.741,
              (32, 2560, 1024, 512): 1.248, (32, 2560, 512, 1024): 0.901,
              (4, 2048, 32, 64, 128, 256): 1.353,
              (4, 2048, 64, 64, 64, 256): 2.241}
# train_yi9b: full width cut to 16 of 48 layers (all 48 need ~103 GB of bf16
# params and grads and f32 moments), one fixed 4 x 2048 batch
YI_TRAIN = dict(layers=16, batch=4, seq=2048, steps=10)
# train_gemma3: full width cut to 12 of 48 layers (two super-blocks of 5
# windowed layers and a global one; all 48 need ~141 GB of train state),
# one fixed 2 x 2048 batch
GEMMA3_TRAIN = dict(layers=12, batch=2, seq=2048, steps=6)
# train_granite: launch/train.py at full width, cut to 8 of 24 layers (the
# 1200 s limit: a save and a restore of its whole state are most of the
# phase, and the checks do not depend on the depth)
GRANITE_TRAIN = ["--arch", "granite-moe-1b-a400m", "--global-batch", "8",
                 "--seq-len", "2048", "--microbatches", "2"]
GRANITE_LAYERS = 8

# the SSD backward at the training microbatches of train_mamba2 (8 x 2048
# in 2 microbatches) and train_zamba2 (4 x 2048), each gradient within the
# forward's tolerance, its atol taken relative to the gradient's largest
# magnitude
MAMBA2_TRAIN_SSD = (4, 2048, 32, 64, 128, 256)
ZAMBA2_TRAIN_SSD = (4, 2048, 64, 64, 64, 256)
SSD_BWD_TOL = dict(atol_of_max=5e-4, rtol=5e-3)
# train_mamba2: launch/train.py at full width cut to 16 of 48 layers (the
# time limit); train_zamba2: full width and depth, one fixed batch
MAMBA2_TRAIN = ["--arch", "mamba2-370m", "--global-batch", "8",
                "--seq-len", "2048", "--microbatches", "2"]
MAMBA2_LAYERS = 16
ZAMBA2_TRAIN = dict(batch=4, seq=2048, steps=10)

# the embeddings input mode: the flash shapes of musicgen-medium's training
# microbatch (MHA, 24 heads of 64: a head count off the powers of two, GQA
# ratio 1) and of internvl2-26b's training batch and forward (48 q over 8
# kv heads of 128), each held against the plain versions before a model
# phase runs it; musicgen trained through launch/train.py at full width cut
# to 12 of 48 layers (the time limit); internvl2 at full width and depth for
# prefill + decode against its
# forward, and cut to 4 of 48 layers for training (all 48 need ~309 GB of
# train state)
MUSICGEN_TRAIN_ATTN = (4, 2048, 24, 24, 64, 0, 0.0)
INTERNVL2_TRAIN_ATTN = (2, 2048, 48, 8, 128, 0, 0.0)
INTERNVL2_FORWARD_ATTN = (2, 1024, 48, 8, 128, 0, 0.0)
EMBEDDINGS_ATTN = [MUSICGEN_TRAIN_ATTN, INTERNVL2_TRAIN_ATTN,
                   INTERNVL2_FORWARD_ATTN]
MUSICGEN_TRAIN = ["--arch", "musicgen-medium", "--global-batch", "8",
                  "--seq-len", "2048", "--microbatches", "2"]
MUSICGEN_LAYERS = 12
INTERNVL2_FULL = dict(batch=2, seq=1024)
INTERNVL2_TRAIN = dict(layers=4, batch=2, seq=2048, steps=3)
# prefill(S-1) + decode(1) against forward(S), the largest difference
# relative to the largest logit: JAX's bound for its reduced 2-layer models
# (tests/test_decode_consistency.py), and the bounds of internvl2_full. Its
# full-depth bf16 model is held to 5e-2: the decode step's scores are
# rounded to bf16 (JAX's decode attention, which the port mirrors) and the
# flash forward's are not, and bf16 rounding grows with depth (on the CPU,
# a 1024-wide copy of internvl2's heads gives 1.3e-2 at 2 layers and
# 1.6-1.8e-2 at 24; an H100 gave 2.12e-2 at 48); the same check in f32 at
# full width cut to 2 layers is held to 1e-4 (1.2e-6 on the CPU copy)
DECODE_REL = 2e-2
DECODE_REL_BF16_DEPTH = 5e-2
DECODE_REL_F32 = 1e-4

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


def step_profile(fn, top: int = 12, shares: dict = None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host ms, the summed
    device time of the kernels and copies on the card, the ``top`` kernels
    by device time (ms, calls) and, for each ``label: needle`` of
    ``shares``, the device ms of the kernels whose name holds the needle
    and their share of the busy time. "not measured" where the profiler
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
        # the raw records: ``prof.events()`` would first build the tree of
        # every host op, tens of seconds for a step of ~30,000 launches
        by_name = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    except Exception as exc:          # a measurement aid, not a check
        return {"profile": f"not measured ({type(exc).__name__}: {exc})"}
    busy = sum(ms for ms, _ in by_name.values())
    if busy <= 0:
        return {"profile": "not measured (no device events)"}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"host_ms_profiled": host_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1 - busy / host_ms),
           "top_kernels": [{"name": n[:120], "ms": ms, "calls": c}
                           for n, (ms, c) in ranked]}
    for label, needle in (shares or {}).items():
        ms = sum(m for n, (m, _) in by_name.items() if needle in n)
        out[f"{label}_ms"] = ms
        out[f"{label}_share_of_busy"] = ms / busy
    return out


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


def reset_launches(ops: dict):
    """Every kernel's launch counts, forward and backward, set to 0."""
    for op in ops.values():
        op.launches = op.bwd_launches = 0
    gmm = ops["grouped_matmul"]
    gmm.launches_by_variant.update(dict.fromkeys(gmm.launches_by_variant, 0))


def read_launches(ops: dict) -> dict:
    """Every kernel's launch counts since the last ``reset_launches``."""
    return {**{name: op.launches for name, op in ops.items()},
            **{f"{name}_bwd": op.bwd_launches for name, op in ops.items()},
            "grouped_matmul_by_variant": dict(
                ops["grouped_matmul"].launches_by_variant)}


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


def launch_train_resumed(smi: str, ops: dict, phase: str, argv: list,
                         layers: int, want: dict, want_variants: dict = None,
                         top: int = 12) -> dict:
    """``repro_torch.launch.train``'s run of ``argv`` (``run(args,
    cfg=...)``, the arch's config cut to ``layers``: the time limit) for
    10 steps saved at the 10th (checkpoints in a temp dir, deleted after;
    one save, for the time limit: the examples' ``torch_train_e2e`` saves
    while it trains), then a new run resumed from step 10 for 5, then one
    step of the same shape under the profiler after a warm one. Gates:
    finite and falling losses, the restored state equal to the saved one
    leaf for leaf, the resumed run restoring step 10, and exact launch
    counts, ``want`` (and the grouped matmul's ``want_variants``) in the
    first run, half of each in the resumed one. Emits ``phase``'s lines;
    returns the first run's counts."""
    import shutil

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.monitoring import Monitor
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                           device_batch)
    from repro_torch.launch import train as train_driver
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import OptimizerConfig, leaves
    from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                                 make_train_step)
    t0 = time.perf_counter()
    ckpt = Path(tempfile.mkdtemp(prefix=f"{phase}_"))
    try:
        args = train_driver.parse_args(argv + [
            "--steps", "10", "--ckpt-every", "10", "--ckpt-dir", str(ckpt)])
        cfg = dataclasses.replace(get_config(args.arch), num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ops)
        t1 = time.perf_counter()
        out = io.StringIO()
        mon = Monitor(name="train")
        with contextlib.redirect_stdout(out):
            losses1, state1 = train_driver.run(args, monitor=mon, cfg=cfg)
        run1_s = time.perf_counter() - t1
        got = read_launches(ops)
        peak1 = torch.cuda.max_memory_allocated() / 1e9
        step_ms = [1e3 * e["seconds"] for e in mon.events("train")
                   if e["event"] == "step.done"]
        tokens = args.global_batch * args.seq_len
        median_ms = float(np.median(step_ms[2:]))
        line = {"phase": phase, "layers": cfg.num_layers,
                "full_layers": get_config(args.arch).num_layers,
                "params": sum(t.numel() for t in leaves(state1["params"])),
                "d_model": cfg.d_model, "dtype": cfg.dtype,
                "input_mode": cfg.input_mode, "moments": "float32",
                "remat_policy": cfg.remat_policy,
                "argv": argv + ["--steps", "10", "--ckpt-every", "10"]}
        if "blocks" in state1["params"]:      # a transformer
            flops = model_flops(cfg, state1["params"], tokens, args.seq_len)
            line.update(model_flops_per_step=flops,
                        model_flops_share_of_bf16_peak=flops
                        / (median_ms * 1e-3) / H100_BF16_FLOPS)
        store = CheckpointStore(str(ckpt))
        saved = store.latest_step()
        restored = store.restore(state1, step=saved)
        mismatched = [i for i, (a, b) in enumerate(zip(
            leaves(restored), leaves(state1))) if not torch.equal(a, b)]
        n_leaves = len(leaves(state1))
        del restored, state1
        store.gc(keep_last=1)
        release(f"{phase} run 1")
        out2 = io.StringIO()
        reset_launches(ops)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out2):
            losses2 = train_driver.run(train_driver.parse_args(argv + [
                "--steps", "5", "--ckpt-every", "5", "--resume",
                "--ckpt-dir", str(ckpt)]), cfg=cfg)[0]
        run2_s = time.perf_counter() - t1
        got2 = read_launches(ops)
        want2 = {k: v // 2 for k, v in want.items()}
        variants2 = {k: v // 2 for k, v in (want_variants or {}).items()}
        emit({**line, "losses": losses1, "resumed_losses": losses2,
              "printed": out.getvalue().splitlines(),
              "printed_resume": out2.getvalue().splitlines(),
              "step_ms": step_ms, "step_ms_median_3_10": median_ms,
              "tokens_per_s": tokens / median_ms * 1e3,
              "run_seconds": run1_s, "resume_run_seconds": run2_s,
              "tokens_per_s_with_saves": 10 * tokens / run1_s,
              "saved_step": saved, "leaves": n_leaves,
              "restored_leaves_unequal": mismatched,
              "launches": got, "expected_launches": want,
              "expected_by_variant": want_variants,
              "resume_launches": got2, "expected_resume_launches": want2,
              "peak_memory_gb": peak1, "card": smi,
              "seconds": time.perf_counter() - t0})
        check_losses(phase, losses1)
        if not all(np.isfinite(losses2)) or \
                "[resume] restored step 10" not in out2.getvalue():
            fail(f"{phase}: the resumed run {losses2} did not restore step "
                 f"10")
        if saved != 10 or mismatched:
            fail(f"{phase}: step {saved} restored with leaves {mismatched} "
                 f"unequal")
        if {k: got[k] for k in want} != want or \
                {k: got2[k] for k in want2} != want2 or (want_variants and (
                    got["grouped_matmul_by_variant"] != want_variants or
                    got2["grouped_matmul_by_variant"] != variants2)):
            fail(f"{phase}: launches {got} then {got2}, expected {want} "
                 f"and {want_variants}, then half of each")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    release(phase)
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=5, total_steps=10)
    holder = [init_state(model, opt_cfg,
                         torch.Generator(device="cuda").manual_seed(0))]
    step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig(
        microbatches=args.microbatches))
    batch = device_batch(SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch,
        embeddings_dim=cfg.d_model if cfg.input_mode == "embeddings"
        else 0)).batch(0), "cuda")

    def one_step():
        holder[0], _ = step_fn(holder[0], batch)
    one_step()
    emit({"phase": f"{phase}_profile", **step_profile(one_step, top=top),
          "card": smi})
    del model, holder, step_fn, batch
    release(f"{phase}_profile")
    return got


def train_fixed_batch(smi: str, ops: dict, phase: str, cfg, run: dict,
                      want: dict, top: int = 12, shares: dict = None,
                      extra: dict = None) -> dict:
    """``cfg`` trained on the card (random weights from seed 0, f32
    moments) for ``run["steps"]`` steps on one fixed ``run["batch"]`` x
    ``run["seq"]`` batch, then one step more under the profiler
    (``step_profile``, with ``shares``). Gates: finite and falling losses
    and grad norms, launches equal to ``want``. Emits ``phase``'s line (ms
    a step, the median from step 3; tokens/s; for a transformer the model
    FLOPs' share of the bf16 peak; peak memory; ``extra``) and
    ``{phase}_profile``; returns the launch counts."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import OptimizerConfig, leaves
    from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                                 make_train_step)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    state = init_state(model, opt_cfg,
                       torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in leaves(state["params"]))
    step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=run["seq"],
                                      global_batch=run["batch"]))
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, norms, step_ms = [], [], []
    reset_launches(ops)
    for _ in range(run["steps"]):
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t1) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    got = read_launches(ops)
    tokens = run["batch"] * run["seq"]
    median_ms = float(np.median(step_ms[2:]))
    line = {"phase": phase, "layers": cfg.num_layers, **(extra or {}),
            "d_model": cfg.d_model, "params": n_params, "dtype": cfg.dtype,
            "moments": "float32", "remat_policy": cfg.remat_policy,
            "batch": run["batch"], "seq": run["seq"], "losses": losses,
            "grad_norms": norms, "step_ms": step_ms,
            f"step_ms_median_3_{run['steps']}": median_ms,
            "tokens_per_s": tokens / median_ms * 1e3}
    if "blocks" in state["params"]:      # a transformer
        flops = model_flops(cfg, state["params"], tokens, run["seq"])
        line.update(model_flops_per_step=flops,
                    model_flops_share_of_bf16_peak=flops
                    / (median_ms * 1e-3) / H100_BF16_FLOPS)
    emit({**line, "launches": got, "expected_launches": want,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "init_seconds": init_s, "card": smi,
          "seconds": time.perf_counter() - t0})
    check_losses(phase, losses, norms)
    if {k: got[k] for k in want} != want:
        fail(f"{phase}: launches {got}, expected {want}")
    holder = [state]

    def one_step():
        holder[0], _ = step_fn(holder[0], batch)
    emit({"phase": f"{phase}_profile", "step": run["steps"] + 1,
          **step_profile(one_step, top=top, shares=shares), "card": smi})
    del model, state, step_fn, batch, metrics, holder
    release(phase)
    return got


# the f32 parity runs, the card against the CPU from the same params, (arch,
# config overrides, batch, seq), 3 train steps each: yi-9b at depth 2
# (train_parity_f32), mamba2-370m at 2 layers and zamba2-1.2b at one
# segment of 6 and the shared block (train_parity_ssm_f32). Their CPU
# halves run in a process of their own from the script's start, beside the
# build and the kernel checks, on PARITY_THREADS of the host's threads (the
# time limit: about a minute of CPU work)
PARITY_RUNS = [("yi-9b", dict(num_layers=2), 2, 128),
               ("mamba2-370m", dict(num_layers=2), 2, 512),
               ("zamba2-1.2b", dict(num_layers=6), 1, 512)]
PARITY_STEPS = 3
PARITY_THREADS = 4


def _parity_cfg(arch, over):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), dtype="float32", **over)


def _parity_steps(model, cfg, state, batch, seq):
    """PARITY_STEPS train steps of ``state`` on the synthetic stream's
    first batches: (losses, grad norms, the state)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.training.train_step import (TrainStepConfig,
                                                 make_train_step)
    step_fn = make_train_step(model, cfg, OptimizerConfig(
        warmup_steps=2, total_steps=10), TrainStepConfig())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch))
    losses, norms = [], []
    for i in range(PARITY_STEPS):
        b = {k: torch.as_tensor(v).to(model.device)
             for k, v in data.batch(i).items()}
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, state


def cpu_parity_worker(out_dir: str):
    """The CPU halves of PARITY_RUNS, in a process of their own (started by
    ``CpuParity``): run ``i``'s params, drawn on the CPU from seed 0, go to
    ``{i}.init.pt`` before its steps, and its losses, grad norms and final
    params to ``{i}.done.pt`` after them, each file renamed into place
    whole."""
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import OptimizerConfig, leaves
    from repro_torch.training.train_step import init_state
    torch.set_num_threads(PARITY_THREADS)
    out = Path(out_dir)

    def put(obj, name):
        torch.save(obj, out / f"{name}.part")
        os.replace(out / f"{name}.part", out / name)
    for i, (arch, over, batch, seq) in enumerate(PARITY_RUNS):
        t0 = time.perf_counter()
        cfg = _parity_cfg(arch, over)
        model = build_model(cfg, device="cpu")
        state = init_state(model, OptimizerConfig(warmup_steps=2,
                                                  total_steps=10),
                           torch.Generator().manual_seed(0))
        put(state["params"], f"{i}.init.pt")
        losses, norms, state = _parity_steps(model, cfg, state, batch, seq)
        put({"losses": losses, "norms": norms,
             "params": leaves(state["params"]),
             "seconds": time.perf_counter() - t0}, f"{i}.done.pt")
        del model, state


class CpuParity:
    """``cpu_parity_worker`` in a spawned process, started at once (no
    card); ``load(name)`` waits for one of its files, failing if the
    process ends without it; ``close`` joins the process and removes its
    files."""

    def __init__(self):
        import multiprocessing
        self.dir = Path(tempfile.mkdtemp(prefix="cpu_parity_"))
        self.proc = multiprocessing.get_context("spawn").Process(
            target=cpu_parity_worker, args=(str(self.dir),), daemon=True)
        self.proc.start()

    def load(self, name: str, timeout: float = 600.0):
        """(the file's object, seconds waited for it)."""
        path, t0 = self.dir / name, time.perf_counter()
        while not path.exists():
            if self.proc.exitcode is not None and not path.exists():
                fail(f"cpu_parity_worker ended (exit {self.proc.exitcode}) "
                     f"without writing {name}")
            if time.perf_counter() - t0 > timeout:
                fail(f"cpu_parity_worker wrote no {name} in {timeout} s")
            time.sleep(0.1)
        return torch.load(path), time.perf_counter() - t0

    def close(self):
        import shutil
        self.proc.join(timeout=60)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        shutil.rmtree(self.dir, ignore_errors=True)


def _parity_card(ops: dict, parity: CpuParity, i: int):
    """PARITY_RUNS[i] on the card from the CPU process's params: (losses,
    grad norms, the final state, the card's launches, the CPU run's
    results with ``wait``, the seconds waited for them)."""
    from repro_torch.models.model import build_model
    from repro_torch.models.params import to_device
    from repro_torch.optim import adamw
    arch, over, batch, seq = PARITY_RUNS[i]
    cfg = _parity_cfg(arch, over)
    params, waited = parity.load(f"{i}.init.pt")
    params = to_device(params, "cuda")           # the same params
    model = build_model(cfg, device="cuda")
    state = {"params": params, "opt": adamw.init(params, adamw.OptimizerConfig(
        warmup_steps=2, total_steps=10))}
    del params
    reset_launches(ops)
    losses, norms, state = _parity_steps(model, cfg, state, batch, seq)
    launched = read_launches(ops)
    host, w = parity.load(f"{i}.done.pt")
    host["wait"] = waited + w
    return losses, norms, state, launched, host


def _parity_params(state, host: dict, ok: bool):
    """(the largest |card - CPU| over the params, ``ok`` and every param
    within atol 5e-5 + rtol 5e-4 of the CPU's)."""
    from repro_torch.optim.adamw import leaves
    worst = 0.0
    for a, b in zip(leaves(state["params"]), host["params"]):
        b = b.to(a.device)
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= 5e-5 + 5e-4 * b.abs()).all())
    return worst, ok


def training_phases(smi: str, ops: dict, parity: CpuParity) -> dict:
    """The training path on the card: yi-9b at full width (16 layers) and
    gemma3-12b at full width (12 layers) on one fixed batch each; yi-9b at
    depth 2 in float32 on the card against the
    CPU (the port's plain versions, run by ``parity``) from the same params;
    ``repro_torch.launch.train`` for granite-moe-1b-a400m at full width cut
    to GRANITE_LAYERS, saved and resumed; a VRE's ``lm-trainer`` across a
    destroy and re-instantiation; mamba2 and zamba2 in float32 against the
    CPU likewise; mamba2 through ``launch.train``, cut to MAMBA2_LAYERS;
    zamba2 at full width and depth. Each run's launch counts are set to 0
    just before it and read just after; returns them by run."""
    import shutil

    import repro_torch.core.services  # noqa: F401 (registers the services)
    from repro_torch.configs import get_config
    from repro_torch.core.vre import VirtualResearchEnvironment, VREConfig
    from repro_torch.optim.adamw import leaves
    counts = {}

    # -- train_yi9b: full width, 16 of 48 layers, bf16, f32 moments -------
    cfg = dataclasses.replace(get_config("yi-9b"),
                              num_layers=YI_TRAIN["layers"],
                              remat_policy="full")
    steps, layers = YI_TRAIN["steps"], YI_TRAIN["layers"]
    counts["train_yi9b"] = train_fixed_batch(
        smi, ops, "train_yi9b", cfg, YI_TRAIN,
        {"flash_attention": 2 * layers * steps,
         "flash_attention_bwd": layers * steps, "grouped_matmul": 0,
         "grouped_matmul_bwd": 0, "ssd": 0})

    # -- train_gemma3: full width, 12 of 48 layers (two super-blocks: 10
    # windowed layers, 2 global), bf16, f32 moments: the flash backward at
    # head dim 256, with its window and without
    cfg = dataclasses.replace(get_config("gemma3-12b"),
                              num_layers=GEMMA3_TRAIN["layers"],
                              remat_policy="full")
    steps, layers = GEMMA3_TRAIN["steps"], GEMMA3_TRAIN["layers"]
    lp, gp = cfg.local_global_pattern
    counts["train_gemma3"] = train_fixed_batch(
        smi, ops, "train_gemma3", cfg, GEMMA3_TRAIN,
        {"flash_attention": 2 * layers * steps,
         "flash_attention_bwd": layers * steps, "grouped_matmul": 0,
         "grouped_matmul_bwd": 0, "ssd": 0},
        shares={"flash_attention_bwd": "bwd_d256_kernel"},
        extra={"windowed_layers": layers // (lp + gp) * lp,
               "window": cfg.sliding_window})

    # -- train_parity_f32: depth 2, f32, the card against the CPU ---------
    t0 = time.perf_counter()
    cl, _, cst, ccounts, host = _parity_card(ops, parity, 0)
    hl = host["losses"]
    # f32 on both: summation orders (the kernels', the CPU's); params to
    # tests/test_training.py's accumulation tolerance
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cl, hl))
    worst, ok = _parity_params(cst, host, loss_rel <= 1e-4)
    want = {"flash_attention": 2 * 2 * 3, "flash_attention_bwd": 2 * 3}
    emit({"phase": "train_parity_f32", "layers": 2, "batch": 2, "seq": 128,
          "losses_cuda": cl, "losses_cpu": hl, "loss_max_rel_diff": loss_rel,
          "loss_rtol": 1e-4, "params_max_abs_diff": worst,
          "params_tol": {"atol": 5e-5, "rtol": 5e-4},
          "launches_cuda": ccounts, "ok": ok, "card": smi,
          "cpu_seconds": host["seconds"], "cpu_wait_seconds": host["wait"],
          "seconds": time.perf_counter() - t0})
    if not ok or {k: ccounts[k] for k in want} != want:
        fail(f"train_parity_f32: card and CPU disagree (losses {cl} vs {hl},"
             f" params {worst}) or launches {ccounts} != {want}")
    del cst, host
    release("train_parity_f32")

    # -- train_granite: launch/train.py, full width, resumed ---------------
    layers, steps, mbs = GRANITE_LAYERS, 10, 2
    # every layer MoE: 3 expert products a forward, run twice under remat,
    # and dx, dw for each in the backward; flash likewise; capacity 2560:
    # the tile kernel for the forward, its dx and dw variants for the
    # backward
    counts["train_granite"] = launch_train_resumed(
        smi, ops, "train_granite", GRANITE_TRAIN, layers,
        {"flash_attention": 2 * layers * mbs * steps,
         "flash_attention_bwd": layers * mbs * steps,
         "grouped_matmul": 6 * layers * mbs * steps,
         "grouped_matmul_bwd": 6 * layers * mbs * steps, "ssd": 0},
        {"tile": 6 * layers * mbs * steps, "stream": 0,
         "dx": 3 * layers * mbs * steps, "dw": 3 * layers * mbs * steps,
         "f32": 0})

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
        reset_launches(ops)
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
        counts["vre_train"] = got = read_launches(ops)
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
    for i in (1, 2):
        t0 = time.perf_counter()
        arch, _, batch, seq = PARITY_RUNS[i]
        cfg = _parity_cfg(*PARITY_RUNS[i][:2])
        cl, cn, cst, ccounts, host = _parity_card(ops, parity, i)
        hl, hn = host["losses"], host["norms"]
        # f32 on both: summation orders (the kernels', the CPU's); params
        # to tests/test_training.py's accumulation tolerance
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cl, hl))
        norm_rel = max(abs(a - b) / abs(b) for a, b in zip(cn, hn))
        worst, ok = _parity_params(cst, host,
                                   loss_rel <= 1e-4 and norm_rel <= 1e-3)
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
              "card": smi, "cpu_seconds": host["seconds"],
              "cpu_wait_seconds": host["wait"],
              "seconds": time.perf_counter() - t0})
        if not ok or {k: ccounts[k] for k in want} != want:
            fail(f"train_parity_ssm_f32 {arch}: card and CPU disagree "
                 f"(losses {cl} vs {hl}, grad norms {cn} vs {hn}, params "
                 f"{worst}) or launches {ccounts} != {want}")
        del cst, host
        release(f"train_parity_ssm_f32 {arch}")
    parity.close()

    # -- train_mamba2: launch/train.py, full width, resumed ----------------
    # remat "full": each layer's SSD forward twice a microbatch, its
    # backward once
    layers, steps, mbs = MAMBA2_LAYERS, 10, 2
    counts["train_mamba2"] = launch_train_resumed(
        smi, ops, "train_mamba2", MAMBA2_TRAIN, layers,
        {"ssd": 2 * layers * mbs * steps, "ssd_bwd": layers * mbs * steps,
         "flash_attention": 0, "flash_attention_bwd": 0,
         "grouped_matmul": 0, "grouped_matmul_bwd": 0}, top=16)

    # -- train_zamba2: full width and depth, one fixed 4 x 2048 batch -----
    cfg = get_config("zamba2-1.2b")
    steps, layers = ZAMBA2_TRAIN["steps"], cfg.num_layers
    apps = layers // cfg.shared_attn_every
    # Mamba2 layers remat'd (SSD forward twice), the shared block not
    counts["train_zamba2"] = train_fixed_batch(
        smi, ops, "train_zamba2", cfg, ZAMBA2_TRAIN,
        {"ssd": 2 * layers * steps, "ssd_bwd": layers * steps,
         "flash_attention": apps * steps,
         "flash_attention_bwd": apps * steps, "grouped_matmul": 0,
         "grouped_matmul_bwd": 0}, top=16,
        extra={"shared_block_applications": apps})
    return counts


def embeddings_phases(smi: str, ops: dict) -> dict:
    """The ``embeddings`` input mode on the card, the stub front ends'
    (B, S, d) float embeddings in place of token ids: musicgen-medium at
    full width cut to 2 layers in float32, the card against the CPU from
    the same params (forward logits, prefill(S-1) + decode(1) against
    forward(S), 3 train steps); ``repro_torch.launch.train``'s run for
    musicgen-medium at full width cut to MUSICGEN_LAYERS (8 x 2048 in 2
    microbatches, 10 steps saved at the 10th, resumed for 5) with one
    profiled step;
    internvl2-26b at full width and depth in bf16, prefill + decode against
    its forward; internvl2-26b cut to 4 layers, 3 train steps; and a VRE's
    ``data`` and ``lm-trainer`` on musicgen-medium. Each run's launch counts
    are set to 0 just before it and read just after; returns them by run."""
    import shutil

    import repro_torch.core.services  # noqa: F401 (registers the services)
    from repro_torch.configs import get_config
    from repro_torch.core.vre import VirtualResearchEnvironment, VREConfig
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                           device_batch)
    from repro_torch.models.model import build_model
    from repro_torch.models.params import to_device
    from repro_torch.optim.adamw import OptimizerConfig, leaves
    from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                                 make_train_step)
    counts = {}

    def rel(a, b) -> float:
        """Largest difference relative to the largest magnitude of ``b``."""
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def embedding_data(cfg, seq, batch):
        return SyntheticLMData(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            embeddings_dim=cfg.d_model))

    # -- embeddings_parity_f32: musicgen, depth 2, the card against the CPU
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("musicgen-medium"), num_layers=2,
                              dtype="float32")
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=10)
    cpu_model = build_model(cfg, device="cpu")
    cpu_state = init_state(cpu_model, opt_cfg,
                           torch.Generator().manual_seed(0))
    card_model = build_model(cfg, device="cuda")
    card_state = to_device(cpu_state, "cuda")     # the same params
    data = embedding_data(cfg, 128, 2)
    x = torch.as_tensor(data.batch(100)["inputs"])
    s = x.shape[1]
    runs = {}
    for label, model, st in (("cuda", card_model, card_state),
                             ("cpu", cpu_model, cpu_state)):
        reset_launches(ops)
        xd = x.to(model.device)
        with torch.no_grad():
            full, _ = model.forward(st["params"], xd)
            _, caches = model.prefill(st["params"], xd[:, :-1], s)
            last, _ = model.decode(st["params"], caches, xd[:, -1:],
                                   torch.full((x.shape[0],), s - 1))
        calls = read_launches(ops)
        step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
        reset_launches(ops)
        ls, ns = [], []
        for i in range(3):
            st, m = step_fn(st, device_batch(data.batch(i), model.device))
            ls.append(float(m["loss"]))
            ns.append(float(m["grad_norm"]))
        runs[label] = dict(full=full.cpu(), last=last[:, 0].cpu(), losses=ls,
                           norms=ns, state=st, calls=calls,
                           train=read_launches(ops))
        del full, caches, last
    card, host = runs["cuda"], runs["cpu"]
    # f32 on both: summation orders; train_parity_f32's tolerances, the
    # logits' relative to their largest magnitude at the loss's 1e-4
    logits_rel = rel(card["full"], host["full"])
    decode_rel = rel(card["last"], card["full"][:, -1])
    decode_rel_cpu = rel(host["last"], host["full"][:, -1])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                       host["losses"]))
    norm_rel = max(abs(a - b) / abs(b) for a, b in zip(card["norms"],
                                                       host["norms"]))
    # the first moments (each gradient element's weighted sum over the
    # steps) within 1e-3 of their leaf's largest, the grad norms' tolerance
    # (f32 sums over 256 tokens in the kernels' and the CPU's orders: 1.9e-4
    # on an H100); the params at train_parity_f32's tolerance but for at
    # most 1e-6 of their elements: Adam divides by sqrt(v) + eps, so an
    # element whose gradient lies near 0 in a step moves by up to twice that
    # step's lr on rounding alone (on an H100, 14 of 78.7 M elements past
    # it, each with its first moments equal within 1e-3). Each leaf past
    # it: the count, the first such element and both runs' moments there
    worst, m_rels, n_elems = 0.0, {}, 0
    over = {}
    for i, (a, b, ma, mb) in enumerate(zip(
            leaves(card["state"]["params"]), leaves(host["state"]["params"]),
            leaves(card["state"]["opt"]["m"]),
            leaves(host["state"]["opt"]["m"]))):
        diff = (a.cpu() - b).abs()
        worst = max(worst, float(diff.max()))
        m_rels[i] = rel(ma.cpu(), mb)
        n_elems += b.numel()
        bad = diff > 5e-5 + 5e-4 * b.abs()
        if bad.any():
            at = tuple(bad.nonzero()[0].tolist())
            over[i] = {"count": int(bad.sum()), "max_diff": float(
                diff.max()), "at": list(at), "cuda": float(a[at]),
                "cpu": float(b[at]), "m_cuda": float(ma[at]),
                "m_cpu": float(mb[at])}
    n_over = sum(o["count"] for o in over.values())
    m_rel = max(m_rels.values())
    ok = (logits_rel <= 1e-4 and decode_rel <= 1e-4 and loss_rel <= 1e-4
          and norm_rel <= 1e-3 and m_rel <= 1e-3
          and n_over <= 1e-6 * n_elems)
    # forward and prefill: one flash forward a layer each; training: two a
    # layer a step under remat "full", one backward
    want_calls = {"flash_attention": 2 * 2, "flash_attention_bwd": 0}
    want_train = {"flash_attention": 2 * 2 * 3, "flash_attention_bwd": 2 * 3}
    emit({"phase": "embeddings_parity_f32", "arch": cfg.name, "layers": 2,
          "d_model": cfg.d_model, "batch": x.shape[0], "seq": s,
          "input_scale": 0.02, "logits_max_rel_diff": logits_rel,
          "decode_vs_forward_rel_cuda": decode_rel,
          "decode_vs_forward_rel_cpu": decode_rel_cpu, "logits_rtol": 1e-4,
          "losses_cuda": card["losses"], "losses_cpu": host["losses"],
          "loss_max_rel_diff": loss_rel, "loss_rtol": 1e-4,
          "grad_norms_cuda": card["norms"], "grad_norms_cpu": host["norms"],
          "grad_norm_max_rel_diff": norm_rel, "grad_norm_rtol": 1e-3,
          "first_moments_max_diff_of_max": m_rel,
          "first_moments_diff_of_max_by_leaf": m_rels,
          "first_moments_tol_of_max": 1e-3, "params_max_abs_diff": worst,
          "params_tol": {"atol": 5e-5, "rtol": 5e-4},
          "params_over_tol": n_over, "params": n_elems,
          "params_over_tol_allowed": 1e-6 * n_elems,
          "params_over_tol_by_leaf": over,
          "launches_cuda": {"forward_prefill_decode": card["calls"],
                            "train": card["train"]},
          "expected_launches": {"forward_prefill_decode": want_calls,
                                "train": want_train},
          "ok": ok, "card": smi, "seconds": time.perf_counter() - t0})
    if not ok or {k: card["calls"][k] for k in want_calls} != want_calls or \
            {k: card["train"][k] for k in want_train} != want_train:
        fail(f"embeddings_parity_f32: card and CPU disagree (logits "
             f"{logits_rel}, decode {decode_rel}, losses {loss_rel}, grad "
             f"norms {norm_rel}, first moments {m_rel}, params {n_over} "
             f"past the tolerance) or launches "
             f"{card['calls']}, {card['train']}")
    counts["embeddings_parity_f32"] = card["train"]
    del cpu_model, cpu_state, card_model, card_state, runs, card, host, st
    release("embeddings_parity_f32")

    # -- train_musicgen: launch/train.py, full width, resumed --------------
    # remat "full": each layer's flash forward twice a microbatch, its
    # backward once
    layers, steps, mbs = MUSICGEN_LAYERS, 10, 2
    counts["train_musicgen"] = launch_train_resumed(
        smi, ops, "train_musicgen", MUSICGEN_TRAIN, layers,
        {"flash_attention": 2 * layers * mbs * steps,
         "flash_attention_bwd": layers * mbs * steps, "grouped_matmul": 0,
         "grouped_matmul_bwd": 0, "ssd": 0, "ssd_bwd": 0})

    # -- internvl2_full: full width and depth, prefill + decode against
    # the forward; first the same in f32 at 2 layers
    def decode_check(cfg):
        """(model, params, inputs, decode rel, prefill rel, launches):
        prefill(S-1) + decode(1) against forward(S) on the data pipeline's
        embeddings (f32, scale 0.02)."""
        model = build_model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        b, s = INTERNVL2_FULL["batch"], INTERNVL2_FULL["seq"]
        x = randn((b, s, cfg.d_model), torch.float32,
                  torch.Generator(device="cuda").manual_seed(1), 0.02)
        reset_launches(ops)
        with torch.no_grad():
            full, _ = model.forward(params, x)
            ref = full[:, -2:].clone()
            del full
            first, caches = model.prefill(params, x[:, :-1], s)
            dec, _ = model.decode(params, caches, x[:, -1:],
                                  torch.full((b,), s - 1))
        torch.cuda.synchronize()
        return (model, params, x, rel(dec[:, 0], ref[:, 1]),
                rel(first[:, 0], ref[:, 0]), read_launches(ops))

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(get_config("internvl2-26b"), num_layers=2,
                                dtype="float32")
    model, params, x, decode_rel_f32, prefill_rel_f32, got32 = \
        decode_check(cfg32)
    del model, params, x
    release("internvl2_full f32")
    cfg = get_config("internvl2-26b")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model, params, x, decode_rel, prefill_rel, got = decode_check(cfg)
    init_s = time.perf_counter() - t1
    n_params = sum(t.numel() for t in leaves(params))
    b, s = x.shape[:2]
    counts["internvl2_full"] = got
    # one flash forward a layer in the forward and in the prefill
    want = {"flash_attention": 2 * cfg.num_layers, "flash_attention_bwd": 0}
    want32 = {"flash_attention": 2 * cfg32.num_layers,
              "flash_attention_bwd": 0}

    def prefill():
        with torch.no_grad():
            return model.prefill(params, x[:, :-1], s)
    prefill_host_ms = host_ms(prefill, iters=2)
    prefill_busy_ms = device_busy_ms(prefill)
    emit({"phase": "internvl2_full", "layers": cfg.num_layers,
          "params": n_params, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
          "vocab": [cfg.vocab_size, cfg.padded_vocab], "dtype": cfg.dtype,
          "batch": b, "seq": s, "input_scale": 0.02,
          "decode_vs_forward_rel": decode_rel,
          "prefill_last_vs_forward_rel": prefill_rel,
          "rel_bound": DECODE_REL_BF16_DEPTH,
          "jax_reduced_model_bound": DECODE_REL,
          "f32_2_layers": {"decode_vs_forward_rel": decode_rel_f32,
                           "prefill_last_vs_forward_rel": prefill_rel_f32,
                           "rel_bound": DECODE_REL_F32, "launches": got32},
          "launches": got, "expected_launches": want,
          "prefill_host_ms": prefill_host_ms,
          "prefill_device_busy_ms": prefill_busy_ms,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "init_and_checks_seconds": init_s, "card": smi,
          "seconds": time.perf_counter() - t0})
    if not (decode_rel < DECODE_REL_BF16_DEPTH
            and prefill_rel < DECODE_REL_BF16_DEPTH
            and decode_rel_f32 < DECODE_REL_F32
            and prefill_rel_f32 < DECODE_REL_F32):
        fail(f"internvl2_full: prefill + decode against the forward: "
             f"{prefill_rel}, {decode_rel} in bf16 (bound "
             f"{DECODE_REL_BF16_DEPTH}); {prefill_rel_f32}, {decode_rel_f32} "
             f"in f32 (bound {DECODE_REL_F32})")
    if {k: got[k] for k in want} != want or \
            {k: got32[k] for k in want32} != want32:
        fail(f"internvl2_full: launches {got} and {got32}, expected {want} "
             f"and {want32}")
    del model, params, x
    release("internvl2_full")

    # -- train_internvl2: full width, 4 of 48 layers, one fixed batch -----
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("internvl2-26b"),
                              num_layers=INTERNVL2_TRAIN["layers"])
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    state = init_state(model, opt_cfg,
                       torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in leaves(state["params"]))
    step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
    batch = device_batch(embedding_data(cfg, INTERNVL2_TRAIN["seq"],
                                        INTERNVL2_TRAIN["batch"]).batch(0),
                         "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, norms, step_ms = [], [], []
    reset_launches(ops)
    for _ in range(INTERNVL2_TRAIN["steps"]):
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        step_ms.append((time.perf_counter() - t1) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    counts["train_internvl2"] = got = read_launches(ops)
    steps, layers = INTERNVL2_TRAIN["steps"], cfg.num_layers
    want = {"flash_attention": 2 * layers * steps,
            "flash_attention_bwd": layers * steps, "grouped_matmul": 0,
            "grouped_matmul_bwd": 0, "ssd": 0, "ssd_bwd": 0}
    tokens = INTERNVL2_TRAIN["batch"] * INTERNVL2_TRAIN["seq"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    capacity = torch.cuda.get_device_properties(0).total_memory / 1e9
    emit({"phase": "train_internvl2", "layers": layers,
          "depth_cut": f"{layers} of {get_config('internvl2-26b').num_layers}"
                       f" layers", "params": n_params,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "moments": "float32",
          "remat_policy": cfg.remat_policy, "batch": INTERNVL2_TRAIN["batch"],
          "seq": INTERNVL2_TRAIN["seq"], "losses": losses,
          "grad_norms": norms, "step_ms": step_ms,
          "tokens_per_s_last_step": tokens / step_ms[-1] * 1e3,
          "launches": got, "expected_launches": want,
          "peak_memory_gb": peak, "card_memory_gb": capacity,
          "init_seconds": init_s, "card": smi,
          "seconds": time.perf_counter() - t0})
    if not all(np.isfinite(losses + norms)):
        fail(f"train_internvl2: losses {losses}, grad norms {norms} not "
             f"finite")
    if {k: got[k] for k in want} != want:
        fail(f"train_internvl2: launches {got}, expected {want}")
    del model, state, step_fn, batch, metrics
    release("train_internvl2")

    # -- vre_train_musicgen: a VRE's data and lm-trainer ------------------
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="vre_train_musicgen_")
    try:
        vre = VirtualResearchEnvironment(VREConfig(
            name="train_musicgen", mesh_shape=(1, 1),
            services=["volumes", "data", "lm-trainer"],
            arch="musicgen-medium", provider="h100", workdir=workdir,
            extra={"global_batch": 8, "seq_len": 512}))
        vre.instantiate()
        trainer, data = vre.service("lm-trainer"), vre.service("data")
        shape = list(next(iter(data))["inputs"].shape)
        reset_launches(ops)
        losses = trainer.train_steps(data, 3)
        counts["vre_train_musicgen"] = got = read_launches(ops)
        device = str(leaves(trainer.state)[0].device)
        healthy = trainer.health()
        del trainer, data
        vre.destroy()
        del vre
        layers = get_config("musicgen-medium").num_layers
        want = {"flash_attention": 2 * layers * 3,
                "flash_attention_bwd": layers * 3, "grouped_matmul": 0,
                "ssd": 0}
        emit({"phase": "vre_train_musicgen", "arch": "musicgen-medium",
              "provider": "h100", "batch_inputs_shape": shape,
              "state_device": device, "losses": losses, "healthy": healthy,
              "launches": got, "expected_launches": want, "card": smi,
              "seconds": time.perf_counter() - t0})
        if not (all(np.isfinite(losses)) and healthy
                and device.startswith("cuda") and shape == [8, 512, 1536]):
            fail(f"vre_train_musicgen: losses {losses}, state on {device}, "
                 f"batches {shape}")
        if {k: got[k] for k in want} != want:
            fail(f"vre_train_musicgen: launches {got}, expected {want}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    release("vre_train_musicgen")
    return counts


# the distributed_granite phase: two ranks share the one card on a (data 1,
# model 2) mesh (NCCL takes one rank a card, so they run gloo); two train
# steps of one fixed batch, sharded, against the same steps unsharded; 12
# of granite's 24 layers (the time limit: the sharded serving phases after
# it share the script's budget)
DIST_GRANITE = dict(arch="granite-moe-1b-a400m", layers=12,
                    dtype="bfloat16", batch=4, seq=2048, microbatches=2,
                    steps=2)
# its f32 check at 2 layers, held as the CPU tests hold the sharded step
DIST_GRANITE_F32 = dict(DIST_GRANITE, layers=2, dtype="float32", seq=1024)


def _dist_config(run):
    from repro_torch.configs import get_config, reduced
    cfg = get_config(run["arch"])
    if run.get("reduced"):
        cfg = reduced(cfg)
    return dataclasses.replace(
        cfg, dtype=run["dtype"],
        num_layers=run["layers"] or cfg.num_layers)


def _param_diff(got, want, m, bound):
    """(max |got - want|, elements past ``bound(want)``, of them the ones
    whose first moment ``m`` is not below 1e-3 of the leaf's largest)."""
    diff = (got.float() - want.float()).abs()
    off = diff > bound(want.float().abs())
    live = off & (m.float().abs() >= 1e-3 * float(m.float().abs().max()))
    return float(diff.max()), int(off.sum()), int(live.sum())


def distributed_rank(rank, world, run):
    """One rank of the distributed_granite phase (spawned by
    ``repro_torch.distributed.spawn.run_ranks``): granite at ``run``'s depth
    and dtype on a (data 1, model ``world``) mesh ("heads" mode: each rank
    8 of the 16 q heads, 4 of 8 kv heads, 16 of 32 experts). Rank 0 first
    takes ``run["steps"]`` unsharded steps of the full params (drawn from
    seed 0 on the device, the same on every rank) and keeps them on the
    host; then every rank takes the sharded steps, timed, with the
    launches of the flash and grouped-matmul kernels (forward and
    backward) and the kernels' local shapes recorded; each rank's peak
    memory; the collectives by op (DTensor's and the port's helpers',
    each staged through the host); the sharded params gathered and held to
    the unsharded ones; each local shape's kernel against its plain
    version."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import comm
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         attention_ref_bwd)
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers, moe
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptimizerConfig, leaves
    from repro_torch.training import train_step as ts
    dev = run["device"]
    cuda = dev == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = {"flash_attention": fa_ops, "grouped_matmul": gmm_ops}
    for op in ops.values():
        if cuda:
            op.load_library()
    cfg = _dist_config(run)
    b, s, mb, steps = run["batch"], run["seq"], run["microbatches"], \
        run["steps"]
    mesh = make_test_mesh((1, world), ("data", "model"), device_type=dev)
    policy, par = specs.make_policy(cfg, ShapeConfig("t", s, b, "train"),
                                    mesh)
    ocfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                             size=(b, s + 1))
    batch = {"inputs": torch.as_tensor(toks[:, :-1], device=dev),
             "labels": torch.as_tensor(toks[:, 1:], device=dev)}
    sharded = build_model(cfg, dev, mesh, par, policy)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"rank": rank, "mode": policy.mode, "h_pad": policy.h_pad,
           "backend": dist.get_backend(), "layers": cfg.num_layers,
           "dtype": cfg.dtype}

    def steps_of(step_fn, state):
        losses, ms = [], []
        for _ in range(steps):
            sync()
            t = time.perf_counter()
            state, met = step_fn(state, batch)
            losses.append(float(met["loss"]))       # waits for the step
            ms.append((time.perf_counter() - t) * 1e3)
        return state, losses, ms

    ref = None
    if rank == 0:
        plain = build_model(cfg, dev)
        state = ts.init_state(plain, ocfg, torch.Generator(
            device=dev).manual_seed(0))
        state, out["unsharded_losses"], out["unsharded_ms"] = steps_of(
            ts.make_train_step(plain, cfg, ocfg,
                               ts.TrainStepConfig(microbatches=mb)), state)
        ref = ([t.cpu() for t in leaves(state["params"])],
               [t.cpu() for t in leaves(state["opt"]["m"])])
        del state, plain
    dist.barrier()
    # the same params, drawn whole on every rank and distributed
    state = ts.init_state(sharded, ocfg,
                          torch.Generator(device=dev).manual_seed(0))
    step_fn = ts.make_train_step(sharded, cfg, ocfg,
                                 ts.TrainStepConfig(microbatches=mb))
    # the kernels' local shapes, by shims over the names the model calls
    shapes = {"flash_attention": set(), "grouped_matmul": set()}
    fa_call, gmm_call = layers.flash_attention, moe.grouped_matmul

    def fa_shim(q, k, v, **kw):
        shapes["flash_attention"].add((tuple(q.shape), tuple(k.shape),
                                       str(q.dtype), q.is_contiguous()))
        return fa_call(q, k, v, **kw)

    def gmm_shim(x, w):
        shapes["grouped_matmul"].add((tuple(x.shape), tuple(w.shape),
                                      str(x.dtype), x.is_contiguous()
                                      and w.is_contiguous()))
        return gmm_call(x, w)
    layers.flash_attention, moe.grouped_matmul = fa_shim, gmm_shim
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    comm.staged.clear()
    comm.host_staged.clear()
    try:
        state, out["losses"], out["ms"] = steps_of(step_fn, state)
    finally:
        layers.flash_attention, moe.grouped_matmul = fa_call, gmm_call
    out["launches"] = {**{n: op.launches for n, op in ops.items()},
                       **{f"{n}_bwd": op.bwd_launches
                          for n, op in ops.items()}}
    out["grouped_matmul_by_variant"] = dict(gmm_ops.launches_by_variant)
    out["staged"] = dict(comm.staged)
    out["host_staged_bytes"] = dict(comm.host_staged)
    out["peak_memory_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                             if cuda else None)
    out["local_shapes"] = {k: sorted(v) for k, v in shapes.items()}
    out["placements"] = {"wq": str(state["params"]["blocks"][0]["attn"]["wq"]
                                   .placements),
                         "experts": str(state["params"]["blocks"][0]["moe"]
                                        ["wi"].placements),
                         "local_experts": state["params"]["blocks"][0]["moe"]
                         ["wi"].to_local().shape[1]}
    # the sharded params gathered whole, held to the unsharded ones: bf16
    # within what two Adam steps can move a param (the normalised step is
    # at most ~1, so 2 lr a step, lr 1.5e-4 then 3e-4 here) and two bf16
    # roundings of it (2^-6 of it); f32 at the CPU tests' atol 1e-4, rtol
    # 1e-3
    lr_sum = sum(float(adamw.schedule(ocfg, torch.tensor(i)))
                 for i in range(1, steps + 1))
    if cfg.dtype == "bfloat16":
        bound = lambda w: 2.2 * lr_sum + 2 ** -6 * w
    else:
        bound = lambda w: 1e-4 + 1e-3 * w
    worst = {"max_abs_diff": 0.0, "past_tol": 0, "past_tol_live_moment": 0,
             "leaf": None, "lr_sum": lr_sum}
    for i, p in enumerate(leaves(state["params"])):
        full = p.full_tensor().cpu()
        if ref is not None:
            d, off, live = _param_diff(full, ref[0][i], ref[1][i], bound)
            worst["past_tol"] += off
            worst["past_tol_live_moment"] += live
            if d > worst["max_abs_diff"]:
                worst.update(max_abs_diff=d, leaf=i)
    out["param_diff"] = worst
    out["params"] = sum(t.numel() for t in leaves(state["params"]))
    del state, step_fn
    # every local shape against its plain version, forward and backward
    checks = []
    g = torch.Generator(device=dev).manual_seed(rank + 1)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    for qs, ks, dt, contiguous in out["local_shapes"]["flash_attention"]:
        dtype = getattr(torch, dt.removeprefix("torch."))
        q, k, v = (rand(sh, dtype) for sh in (qs, ks, ks))
        dout = rand(qs, dtype)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        o = fa_ops.flash_attention(qg, kg, vg)
        grads = torch.autograd.grad(o, (qg, kg, vg), dout)
        r = attention_ref(q.float(), k.float(), v.float())
        rg = attention_ref_bwd(q.float(), k.float(), v.float(), dout.float())
        # chip_smoke's flash tolerances (section 3)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        err, ok = close(o, r, tol)
        gerr = max(float((a.float() - c).abs().max()) / float(c.abs().max())
                   for a, c in zip(grads, rg))
        checks.append({"kernel": "flash_attention", "q": list(qs),
                       "kv": list(ks), "dtype": dt, "contiguous": contiguous,
                       "max_abs_err": err, "bwd_err_of_max": gerr,
                       "tol": tol, "ok": ok and gerr <= tol})
    for xs, ws, dt, contiguous in out["local_shapes"]["grouped_matmul"]:
        dtype = getattr(torch, dt.removeprefix("torch."))
        x, w = rand(xs, dtype, 0.3), rand(ws, dtype, 0.3)
        dy = rand((xs[0], xs[1], ws[2]), dtype, 0.3)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        o = gmm_ops.grouped_matmul(xg, wg)
        dx, dw = torch.autograd.grad(o, (xg, wg), dy)
        xr, wr = (t.float().requires_grad_() for t in (x, w))
        r = grouped_matmul_ref(xr, wr)
        rx, rw = torch.autograd.grad(r, (xr, wr), dy.float())
        tol = 3e-2 if dtype == torch.bfloat16 else 3e-4
        err, ok = close(o, r.detach(), tol)
        gerr = max(float((a.float() - c).abs().max()) / float(c.abs().max())
                   for a, c in ((dx, rx), (dw, rw)))
        checks.append({"kernel": "grouped_matmul", "x": list(xs),
                       "w": list(ws), "dtype": dt, "contiguous": contiguous,
                       "max_abs_err": err, "bwd_err_of_max": gerr,
                       "tol": tol, "ok": ok and gerr <= tol})
    out["kernel_checks"] = checks
    return out


DIST_RUNS = [("distributed_granite", DIST_GRANITE),
             ("distributed_granite_f32", DIST_GRANITE_F32)]


def pair_rank(rank, world, dist_runs, sharded_runs):
    """The two ranks' body, in one process group (one spawn for both
    phases, for the time limit): ``distributed_rank`` for each of
    ``dist_runs``, each timed and freed before the next, then
    ``sharded_rank`` of ``sharded_runs``."""
    import torch.distributed as dist
    outs = []
    for run in dist_runs:
        t0 = time.perf_counter()
        out = distributed_rank(rank, world, run)
        out["seconds"] = time.perf_counter() - t0
        outs.append(out)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return outs, sharded_rank(rank, world, sharded_runs)


def rank_phases(smi: str) -> dict:
    """``distributed_phases`` and ``sharded_phases``: two ranks sharing the
    card run DIST_RUNS and then SHARDED_PAIR (``pair_rank``), then eight
    run SHARDED_MODES. Returns each phase's launches a rank."""
    from repro_torch.distributed.spawn import run_ranks
    t0 = time.perf_counter()
    outs = run_ranks(pair_rank, 2, backend="gloo", device_type="cuda",
                     args=([dict(r, device="cuda") for _, r in DIST_RUNS],
                           SHARDED_PAIR), timeout=1200, threads=0)
    spawn_s = time.perf_counter() - t0
    counts = distributed_phases(smi, [[o[0][i] for o in outs]
                                      for i in range(len(DIST_RUNS))],
                                spawn_s)
    counts.update(sharded_phases(smi, SHARDED_PAIR, 2, [o[1] for o in outs],
                                 spawn_s))
    t0 = time.perf_counter()
    outs = run_ranks(sharded_rank, 8, backend="gloo", device_type="cuda",
                     args=(SHARDED_MODES,), timeout=900, threads=0)
    counts.update(sharded_phases(smi, SHARDED_MODES, 8, outs,
                                 time.perf_counter() - t0))
    return counts


def distributed_phases(smi: str, outs_by_run: list, spawn_s: float) -> dict:
    """distributed_granite's lines from ``distributed_rank``'s results on
    two ranks that share the card (``outs_by_run``, DIST_RUNS' order): at
    full width cut to 12 of 24 layers in bf16, then at 2 layers in f32;
    fails on a kernel that disagrees with its plain version at a local
    shape, launches off the exact count, or sharded steps off the unsharded
    ones. Returns the bf16 run's launches a rank."""
    counts = {}
    for (label, run), outs in zip(DIST_RUNS, outs_by_run):
        r0 = outs[0]
        layers, steps, mbs = r0["layers"], run["steps"], run["microbatches"]
        # remat "full": the forward kernels twice a layer a microbatch
        per = layers * mbs * steps
        want = {"flash_attention": 2 * per, "flash_attention_bwd": per,
                "grouped_matmul": 6 * per, "grouped_matmul_bwd": 6 * per}
        bf16 = run["dtype"] == "bfloat16"
        # bf16: each step's loss within 1e-2 relative of the unsharded one
        # (the sharded sums round in another order through 24 layers) and
        # every param within ``distributed_rank``'s bound; f32: the CPU
        # tests' tolerances (a param past them only where its first moment
        # is near zero, at most 1e-5 of the params)
        loss_rtol = 1e-2 if bf16 else 1e-4
        loss_ok = all(abs(a - b) <= loss_rtol * abs(b) for a, b in zip(
            r0["losses"], r0["unsharded_losses"]))
        diff = r0["param_diff"]
        if bf16:
            param_tol = "2.2 x the lr summed over the steps + 2^-6 |p|"
            params_ok = diff["past_tol"] == 0
        else:
            param_tol = "atol 1e-4, rtol 1e-3 (past it only a near-zero " \
                        "first moment, at most 1e-5 of the params)"
            params_ok = diff["past_tol_live_moment"] == 0 and \
                diff["past_tol"] <= 1e-5 * r0["params"]
        checks = [c for o in outs for c in o["kernel_checks"]]
        emit({"phase": label, "arch": run["arch"], "layers": layers,
              "dtype": r0["dtype"], "ranks": 2, "mesh": {"data": 1,
                                                         "model": 2},
              "mode": r0["mode"], "h_pad": r0["h_pad"],
              "backend": r0["backend"],
              "staging": "every collective of a CUDA tensor through pinned "
                         "host memory (gloo takes none)",
              "staged_by_op": [o["staged"] for o in outs],
              "host_staged_bytes": [o["host_staged_bytes"] for o in outs],
              "placements": r0["placements"],
              "batch": run["batch"], "seq": run["seq"],
              "microbatches": mbs, "losses": r0["losses"],
              "unsharded_losses": r0["unsharded_losses"],
              "loss_rtol": loss_rtol,
              "param_diff": diff, "param_tol": param_tol,
              "sharded_ms_a_step": [o["ms"] for o in outs],
              "unsharded_ms_a_step": r0["unsharded_ms"],
              "peak_memory_gb_a_rank": [o["peak_memory_gb"] for o in outs],
              "launches_a_rank": [o["launches"] for o in outs],
              "expected_launches_a_rank": want,
              "local_shapes": r0["local_shapes"], "kernel_checks": checks,
              "card": smi, "seconds": r0["seconds"],
              "spawn_seconds": spawn_s})
        bad = [c for c in checks if not c["ok"]]
        if bad:
            fail(f"{label}: kernels disagree with their plain versions at "
                 f"local shapes: {bad}")
        if any(o["launches"] != want for o in outs):
            fail(f"{label}: launches {[o['launches'] for o in outs]}, "
                 f"expected {want} a rank")
        if not (loss_ok and params_ok and all(np.isfinite(r0["losses"]))):
            fail(f"{label}: sharded losses {r0['losses']} against "
                 f"{r0['unsharded_losses']}, params {diff} (tol "
                 f"{param_tol})")
        if label == "distributed_granite":
            counts[label] = {**outs[0]["launches"], "ssd": 0, "ssd_bwd": 0,
                             "grouped_matmul_by_variant":
                             outs[0]["grouped_matmul_by_variant"]}
    return counts


# prefill and decode under a policy, and the SSM and hybrid families
# sharded: ranks share the one card over host-staged gloo, as in
# distributed_granite. Two ranks on a (data 1, model 2) mesh run four
# phases in one process group; eight ranks on (data 1, model 8) run
# yi-9b's production modes at tp 8. Each serving phase prefills, then
# decodes ``steps`` tokens teacher-forced with the unsharded model's greedy
# tokens (so that no divergence compounds), sharded against unsharded in
# the same run; the SSM phases also take sharded train steps against
# unsharded ones, as distributed_granite does.
SERVE_2K = dict(prompt=1024, steps=16, max_seq=2048)
# each model cut to 8 layers at full width (the time limit: the host-staged
# collectives of a full-depth model cost seconds a decode step)
SHARDED_PAIR = [
    dict(phase="sharded_serve_yi9b", arch="yi-9b", layers=8,
         dtype="bfloat16", serve=dict(SERVE_2K, batch=2)),
    # at data 1 each rank routes the whole batch: the unsharded capacity
    dict(phase="sharded_serve_granite", arch="granite-moe-1b-a400m",
         layers=8, dtype="bfloat16", serve=dict(SERVE_2K, batch=1)),
    dict(phase="sharded_mamba2", arch="mamba2-370m", layers=8,
         dtype="bfloat16", serve=dict(SERVE_2K, batch=1),
         train=dict(batch=4, seq=2048, microbatches=2, steps=2)),
    # zamba2's 8: one segment of 6 with the shared block after it, and 2
    # trailing layers
    dict(phase="sharded_zamba2", arch="zamba2-1.2b", layers=8,
         dtype="bfloat16", serve=dict(SERVE_2K, batch=1),
         train=dict(batch=4, seq=2048, microbatches=2, steps=2))]
# yi-9b at 2 layers, f32, 8 ranks: "expand" prefill (4 of 32 q heads a
# rank, the 4 kv heads expanded, the cache's sequence over model), then
# "head_dim" decode (16 of 128 a rank); greedy tokens held equal
SHARDED_MODES = [dict(phase="sharded_modes_yi9b", arch="yi-9b", layers=2,
                      dtype="float32", serve=dict(SERVE_2K, batch=2))]
# the largest logit difference from the unsharded model over the largest
# logit: bf16 through the full depth, the ranks' partial sums rounded in
# another order, 2e-2; bf16 MoE 1e-1, where that rounding can move a near
# tie in the top-8-of-32 routing and so one expert's share of a token; f32
# at 2 layers 1e-4. A bf16 model cut in depth is held to its full depth's
# tolerance times sqrt(layers / full layers), the rounding differences
# adding up as a random walk over the layers: at 8 layers 8.2e-3 for yi-9b
# and mamba2-370m, 9.2e-3 for zamba2-1.2b and 5.8e-2 for granite (one bf16
# step at the largest logit is 2^-8 = 3.9e-3 of it)
SHARDED_LOGITS_REL = {"bfloat16": 2e-2, "moe_bfloat16": 1e-1,
                      "float32": 1e-4}


class _shapes_seen:
    """Records the local shapes (and dtype) that the flash, grouped-matmul
    and SSD ops receive through the names the models call, in the
    block."""
    def __enter__(self):
        from repro_torch.models import layers, mamba2, moe
        self.mods = (layers, moe, mamba2)
        self.fns = (layers.flash_attention, moe.grouped_matmul,
                    mamba2.ssd_chunked)
        self.seen = {"flash_attention": set(), "grouped_matmul": set(),
                     "ssd": set()}
        fa, gmm, ssd = self.fns

        def fa_shim(q, k, v, **kw):
            self.seen["flash_attention"].add(
                (tuple(q.shape), tuple(k.shape), str(q.dtype)))
            return fa(q, k, v, **kw)

        def gmm_shim(x, w):
            self.seen["grouped_matmul"].add(
                (tuple(x.shape), tuple(w.shape), str(x.dtype)))
            return gmm(x, w)

        def ssd_shim(x, dt, A, B, C, chunk):
            self.seen["ssd"].add((tuple(x.shape), B.shape[-1], chunk))
            return ssd(x, dt, A, B, C, chunk)
        layers.flash_attention, moe.grouped_matmul, mamba2.ssd_chunked = (
            fa_shim, gmm_shim, ssd_shim)
        return self.seen

    def __exit__(self, *exc):
        layers, moe, mamba2 = self.mods
        (layers.flash_attention, moe.grouped_matmul,
         mamba2.ssd_chunked) = self.fns


def _check_local_shapes(seen, trained: bool, gen) -> list:
    """Each kernel at each local shape of ``seen`` against its plain
    version, on fresh inputs: flash forward (and backward where the phase
    trains) against ``attention_ref``, the grouped matmul against
    ``grouped_matmul_ref``, the SSD intra-chunk kernels forward (and
    backward) against ``ssd_intra_chunk_ref`` at the chunks the local
    (b, s, heads) make, the models' decay range."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         attention_ref_bwd)
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import (ssd_intra_chunk_ref,
                                             ssd_intra_chunk_ref_bwd)
    checks = []
    for qs, ks, dt in sorted(seen["flash_attention"]):
        dtype = getattr(torch, dt.removeprefix("torch."))
        q, k, v = (randn(sh, dtype, gen) for sh in (qs, ks, ks))
        o = fa_ops.flash_attention(q, k, v)
        r = attention_ref(q.float(), k.float(), v.float())
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        err, ok = close(o, r, tol)
        check = {"kernel": "flash_attention", "q": list(qs), "kv": list(ks),
                 "dtype": dt, "max_abs_err": err, "tol": tol}
        if trained:
            dout = randn(qs, dtype, gen)
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            grads = torch.autograd.grad(fa_ops.flash_attention(qg, kg, vg),
                                        (qg, kg, vg), dout)
            rg = attention_ref_bwd(q.float(), k.float(), v.float(),
                                   dout.float())
            check["bwd_err_of_max"] = gerr = max(
                float((a.float() - c).abs().max()) / float(c.abs().max())
                for a, c in zip(grads, rg))
            ok = ok and gerr <= tol
        checks.append(dict(check, ok=ok))
    for xs, ws, dt in sorted(seen["grouped_matmul"]):
        dtype = getattr(torch, dt.removeprefix("torch."))
        x, w = randn(xs, dtype, gen, 0.3), randn(ws, dtype, gen, 0.3)
        tol = 3e-2 if dtype == torch.bfloat16 else 3e-4
        err, ok = close(gmm_ops.grouped_matmul(x, w),
                        grouped_matmul_ref(x.float(), w.float()), tol)
        checks.append({"kernel": "grouped_matmul", "x": list(xs),
                       "w": list(ws), "dtype": dt, "max_abs_err": err,
                       "tol": tol, "ok": ok})
    # tests/test_kernels.py's SSD tolerance; the backward's of check_ssd_bwd
    ssd_tol = dict(atol=5e-4, rtol=5e-3)
    for (b, s, nh, hd), ds, ch in sorted(seen["ssd"]):
        s = -(-s // ch) * ch
        ins = ssd_kernel_inputs(*ssd_inputs(b, s, nh, hd, ds, gen, True), ch)
        y, S = ssd_ops.ssd_intra_chunk(*ins)
        ry, rS = ssd_intra_chunk_ref(*ins)
        err = max(float((y - ry).abs().max()), float((S - rS).abs().max()))
        ok = all(torch.allclose(o, r, **ssd_tol) for o, r in ((y, ry),
                                                               (S, rS)))
        check = {"kernel": "ssd", "b": b, "s": s, "local_heads": nh,
                 "hd": hd, "ds": ds, "chunk": ch, "dtype": "float32",
                 "max_abs_err": err, "tol": ssd_tol}
        if trained:
            ins = [t.requires_grad_() for t in ins]
            dy = randn(ins[1].shape, torch.float32, gen)
            dS = randn((b, nh, s // ch, ds, hd), torch.float32, gen)
            grads = torch.autograd.grad(ssd_ops.ssd_intra_chunk(*ins),
                                        ins, (dy, dS))
            refs = ssd_intra_chunk_ref_bwd(*(t.detach() for t in ins), dy,
                                           dS)
            rel = 0.0
            for g, r in zip(grads, refs):
                top = float(r.abs().max())
                rel = max(rel, float((g - r).abs().max()) / top)
                ok = ok and bool(((g - r).abs() <= SSD_BWD_TOL["atol_of_max"]
                                  * top + SSD_BWD_TOL["rtol"] * r.abs())
                                 .all())
            check.update(bwd_err_of_max=rel, bwd_tol=SSD_BWD_TOL)
        checks.append(dict(check, ok=ok))
    return checks


def _logits_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


def _sharded_serve(run, rank, mesh, ops, dev) -> dict:
    """A serving phase on this rank: the unsharded prefill and greedy
    decode on rank 0 (its logits on the host, its tokens sent to every
    rank), then the same steps sharded: prefill under a prefill-kind
    policy, the caches placed for a decode-kind policy's model, decode fed
    the unsharded tokens; launches, local shapes, staged collectives, peak
    memory and host ms a call over the sharded steps only."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import comm
    from repro_torch.launch import specs
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import leaves
    cfg = _dist_config(run)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sv = run["serve"]
    b, s, steps, max_seq = sv["batch"], sv["prompt"], sv["steps"], \
        sv["max_seq"]
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg.vocab_size, size=(b, s)), device=dev)
    pos = [torch.full((b,), s + t) for t in range(steps)]
    out, ref = {}, None
    with torch.no_grad():
        if rank == 0:
            plain = build_model(cfg, dev)
            params = plain.init(torch.Generator(device=dev).manual_seed(0))
            lg, c = plain.prefill(params, toks, max_seq)
            ref, feed = [lg.float().cpu()], []
            for t in range(steps):
                feed.append(lg[:, -1, :cfg.vocab_size].argmax(-1))
                lg, c = plain.decode(params, c, feed[-1][:, None], pos[t])
                ref.append(lg.float().cpu())
            feed = torch.stack(feed, 1).cpu()
            del plain, params, c, lg
            _reset_memory(dev)
        box = [feed if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        feed = box[0].to(dev)
        pol_p, par = specs.make_policy(cfg, ShapeConfig("p", s, b,
                                                        "prefill"), mesh)
        pol_d, _ = specs.make_policy(cfg, ShapeConfig("d", max_seq, b,
                                                      "decode"), mesh)
        mp = build_model(cfg, dev, mesh, par, pol_p)
        md = build_model(cfg, dev, mesh, par, pol_d)
        full = mp.init(torch.Generator(device=dev).manual_seed(0))
        pp = mp.distribute(full)
        # one mode for both kinds: the same placements, one copy
        dp = pp if (pol_p.mode, pol_p.h_pad) == (pol_d.mode, pol_d.h_pad) \
            else md.distribute(full)
        del full
        _reset_memory(dev)
        reset_launches(ops)
        comm.staged.clear()
        comm.host_staged.clear()
        got, ms = [], {"prefill": None, "decode": []}
        with _shapes_seen() as seen:
            sync()
            t0 = time.perf_counter()
            lg, c = mp.prefill(pp, toks, max_seq)
            got.append(lg.full_tensor().float().cpu())
            ms["prefill"] = (time.perf_counter() - t0) * 1e3
            c = pol_d.constrain_tree(c, md.cache_axes())
            greedy = [got[0][:, -1, :cfg.vocab_size].argmax(-1)]
            for t in range(steps):
                sync()
                t0 = time.perf_counter()
                lg, c = md.decode(dp, c, feed[:, t:t + 1], pos[t])
                got.append(lg.full_tensor().float().cpu())
                ms["decode"].append((time.perf_counter() - t0) * 1e3)
                greedy.append(got[-1][:, -1, :cfg.vocab_size].argmax(-1))
        out["launches"] = read_launches(ops)
        out["staged"] = dict(comm.staged)
        out["host_staged_bytes"] = dict(comm.host_staged)
        out["peak_memory_gb"] = _peak_gb(dev)
        out["host_ms"] = ms
        out["modes"] = {"prefill": pol_p.mode, "decode": pol_d.mode,
                        "h_pad": pol_p.h_pad}
        out["local_shapes"] = {k: sorted(v) for k, v in seen.items()}
        out["cache_placements"] = [str(x.placements) for x in
                                   leaves(c)][:3]
        del mp, md, pp, dp, c, lg
    if rank == 0:
        rels = [_logits_rel(g, r) for g, r in zip(got, ref)]
        out.update(logits_rel=rels, greedy_feed=feed.cpu().tolist(),
                   greedy_sharded=torch.stack(greedy[:-1], 1).tolist(),
                   greedy_equal=bool(torch.equal(
                       torch.stack(greedy[:-1], 1), feed.cpu())))
    return out


def _reset_memory(dev):
    """Frees what was dropped and restarts the peak count (on the card)."""
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(dev):
    return torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" \
        else None


def _sharded_train(run, rank, mesh, ops, dev) -> dict:
    """A training check on this rank, as distributed_rank's: rank 0's
    unsharded steps from seed 0 (params and first moments kept on the
    host), then the sharded steps from the same params; losses, the
    largest param difference, launches, local shapes, staged collectives,
    peak memory, ms a step."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import comm
    from repro_torch.launch import specs
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptimizerConfig, leaves
    from repro_torch.training import train_step as ts
    cfg = _dist_config(run)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    tr = run["train"]
    b, s, mb, steps = tr["batch"], tr["seq"], tr["microbatches"], \
        tr["steps"]
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                             size=(b, s + 1))
    batch = {"inputs": torch.as_tensor(toks[:, :-1], device=dev),
             "labels": torch.as_tensor(toks[:, 1:], device=dev)}
    ocfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    tcfg = ts.TrainStepConfig(microbatches=mb)
    out, ref = {}, None

    def steps_of(step_fn, state):
        losses, ms = [], []
        for _ in range(steps):
            sync()
            t0 = time.perf_counter()
            state, met = step_fn(state, batch)
            losses.append(float(met["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, ms
    if rank == 0:
        plain = build_model(cfg, dev)
        state = ts.init_state(plain, ocfg, torch.Generator(
            device=dev).manual_seed(0))
        state, out["unsharded_losses"], out["unsharded_ms"] = steps_of(
            ts.make_train_step(plain, cfg, ocfg, tcfg), state)
        ref = ([t.cpu() for t in leaves(state["params"])],
               [t.cpu() for t in leaves(state["opt"]["m"])])
        del state, plain
        _reset_memory(dev)
    dist.barrier()
    policy, par = specs.make_policy(cfg, ShapeConfig("t", s, b, "train"),
                                    mesh)
    model = build_model(cfg, dev, mesh, par, policy)
    state = ts.init_state(model, ocfg, torch.Generator(
        device=dev).manual_seed(0))
    step_fn = ts.make_train_step(model, cfg, ocfg, tcfg)
    _reset_memory(dev)
    reset_launches(ops)
    comm.staged.clear()
    comm.host_staged.clear()
    with _shapes_seen() as seen:
        state, out["losses"], out["ms"] = steps_of(step_fn, state)
    out["launches"] = read_launches(ops)
    out["staged"] = dict(comm.staged)
    out["host_staged_bytes"] = dict(comm.host_staged)
    out["peak_memory_gb"] = _peak_gb(dev)
    out["local_shapes"] = {k: sorted(v) for k, v in seen.items()}
    out["mode"] = policy.mode
    lr_sum = sum(float(adamw.schedule(ocfg, torch.tensor(i)))
                 for i in range(1, steps + 1))
    # distributed_granite's bounds: bf16 2.2 lr summed over the steps +
    # 2^-6 |p|, f32 atol 1e-4 rtol 1e-3
    if cfg.dtype == "bfloat16":
        bound = lambda w: 2.2 * lr_sum + 2 ** -6 * w
    else:
        bound = lambda w: 1e-4 + 1e-3 * w
    worst = {"max_abs_diff": 0.0, "past_tol": 0, "past_tol_live_moment": 0,
             "lr_sum": lr_sum}
    for i, p in enumerate(leaves(state["params"])):
        full = p.full_tensor().cpu()
        if ref is not None:
            d, off, live = _param_diff(full, ref[0][i], ref[1][i], bound)
            worst["past_tol"] += off
            worst["past_tol_live_moment"] += live
            worst["max_abs_diff"] = max(worst["max_abs_diff"], d)
    out["param_diff"] = worst
    del state, step_fn, model
    return out


def sharded_rank(rank, world, runs):
    """The ranks' body for the sharded serving phases: each run of
    ``runs`` on a (data 1, model ``world``) mesh of this process group,
    its serving check, then its training check where it has one, then its
    kernels at each local shape against their plain versions; everything
    freed between runs. Returns each run's results (rank 0's logits
    comparisons and reference numbers)."""
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.mesh import make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = {"flash_attention": fa_ops, "grouped_matmul": gmm_ops,
           "ssd": ssd_ops}
    for op in ops.values():
        op.load_library()
    dev = "cuda"
    mesh = make_test_mesh((1, world), ("data", "model"), device_type=dev)
    results = []
    for run in runs:
        t0 = time.perf_counter()
        res = {"rank": rank, "backend": dist.get_backend()}
        res["serve"] = _sharded_serve(run, rank, mesh, ops, dev)
        gc.collect()
        torch.cuda.empty_cache()
        if run.get("train"):
            res["train"] = _sharded_train(run, rank, mesh, ops, dev)
            gc.collect()
            torch.cuda.empty_cache()
        seen = {k: set(v) for k, v in res["serve"]["local_shapes"].items()}
        if run.get("train"):
            for k, v in res["train"]["local_shapes"].items():
                seen[k] |= set(v)
        res["kernel_checks"] = _check_local_shapes(
            seen, bool(run.get("train")),
            torch.Generator(device=dev).manual_seed(rank + 1))
        res["seconds"] = time.perf_counter() - t0
        dist.barrier()
        results.append(res)
    return results


def _expected_launches(run, cfg) -> dict:
    """Each kernel's exact launches a rank in the serving check (prefill,
    then decode, which runs no kernel but the MoE's grouped matmuls) and
    the training check (remat "full": the Mamba2 layers' SSD forward twice
    a microbatch; the hybrid's shared block not remat'd)."""
    from repro_torch.models.model import _hybrid_layout, program
    sv, layers = run["serve"], cfg.num_layers
    zero = dict.fromkeys(("flash_attention", "grouped_matmul", "ssd"), 0)
    serve = dict(zero)
    train = dict(zero, **{f"{k}_bwd": 0 for k in zero})
    if cfg.family in ("dense", "moe"):
        n_super, subs = program(cfg)
        serve["flash_attention"] = layers
        moe_layers = n_super * sum(s.ffn == "moe" for s in subs)
        serve["grouped_matmul"] = 3 * moe_layers * (1 + sv["steps"])
    else:
        serve["ssd"] = layers
        apps = _hybrid_layout(cfg)[1] if cfg.family == "hybrid" else 0
        serve["flash_attention"] = apps
        if run.get("train"):
            per = run["train"]["microbatches"] * run["train"]["steps"]
            train.update(ssd=2 * layers * per, ssd_bwd=layers * per,
                         flash_attention=apps * per,
                         flash_attention_bwd=apps * per)
    serve.update({f"{k}_bwd": 0 for k in zero})
    return {"serve": serve, "train": train}


def sharded_phases(smi: str, runs: list, world: int, outs: list,
                   spawn_s: float) -> dict:
    """The sharded serving phases' lines from ``sharded_rank``'s results
    ``outs`` on ``world`` ranks sharing the card (SHARDED_PAIR on two,
    SHARDED_MODES on eight), one a phase; fails on a kernel that disagrees
    with its plain version at a local shape, launches off the exact count
    a rank, logits past SHARDED_LOGITS_REL of the unsharded ones, f32
    greedy tokens that differ, or sharded train steps off the unsharded
    ones. Returns each phase's launches a rank (serving and training
    summed)."""
    from repro_torch.configs import get_config
    counts = {}
    for i, run in enumerate(runs):
        cfg = _dist_config(run)
        per_rank = [o[i] for o in outs]
        r0 = per_rank[0]
        want = _expected_launches(run, cfg)
        sv = [o["serve"] for o in per_rank]
        full_tol = SHARDED_LOGITS_REL[
            ("moe_" if cfg.family == "moe" else "") + cfg.dtype
            if cfg.dtype == "bfloat16" else cfg.dtype]
        rel_tol = full_tol * math.sqrt(
            cfg.num_layers / get_config(run["arch"]).num_layers) \
            if cfg.dtype == "bfloat16" else full_tol
        line = {"phase": run["phase"], "arch": run["arch"],
                "layers": cfg.num_layers, "dtype": cfg.dtype,
                "ranks": world, "mesh": {"data": 1, "model": world},
                "backend": r0["backend"],
                "staging": "every collective of a CUDA tensor through "
                           "pinned host memory (gloo takes none)",
                "modes": r0["serve"]["modes"], "serve": run["serve"],
                "logits_rel": r0["serve"]["logits_rel"],
                "logits_rel_tol": rel_tol,
                "logits_rel_tol_full_depth": full_tol,
                "greedy_equal": r0["serve"]["greedy_equal"],
                "serve_launches_a_rank": [o["launches"] for o in sv],
                "expected_serve_launches": want["serve"],
                "serve_host_ms": [o["host_ms"] for o in sv],
                "serve_peak_memory_gb_a_rank":
                    [o["peak_memory_gb"] for o in sv],
                "serve_staged_by_op": [o["staged"] for o in sv],
                "serve_host_staged_bytes":
                    [o["host_staged_bytes"] for o in sv],
                "serve_local_shapes": r0["serve"]["local_shapes"],
                "cache_placements": r0["serve"]["cache_placements"],
                "kernel_checks": [c for o in per_rank
                                  for c in o["kernel_checks"]],
                "card": smi, "seconds": r0["seconds"]}
        bad = []
        if any(x > rel_tol for x in line["logits_rel"]):
            bad.append(f"logits {line['logits_rel']} past {rel_tol}")
        if cfg.dtype == "float32" and not line["greedy_equal"]:
            bad.append("greedy tokens differ")
        if any({k: o["launches"][k] for k in want["serve"]}
               != want["serve"] for o in sv):
            bad.append(f"serve launches {line['serve_launches_a_rank']}"
                       f", expected {want['serve']}")
        total = dict(want["serve"])
        if run.get("train"):
            tr = [o["train"] for o in per_rank]
            t0r = r0["train"]
            loss_rtol = 1e-2 if cfg.dtype == "bfloat16" else 1e-4
            line.update(
                train=run["train"], train_mode=t0r["mode"],
                losses=t0r["losses"],
                unsharded_losses=t0r["unsharded_losses"],
                loss_rtol=loss_rtol, param_diff=t0r["param_diff"],
                sharded_ms_a_step=[o["ms"] for o in tr],
                unsharded_ms_a_step=t0r["unsharded_ms"],
                train_launches_a_rank=[o["launches"] for o in tr],
                expected_train_launches=want["train"],
                train_peak_memory_gb_a_rank=[o["peak_memory_gb"]
                                             for o in tr],
                train_staged_by_op=[o["staged"] for o in tr],
                train_host_staged_bytes=[o["host_staged_bytes"]
                                         for o in tr],
                train_local_shapes=t0r["local_shapes"])
            if not all(abs(a - b) <= loss_rtol * abs(b) for a, b in zip(
                    t0r["losses"], t0r["unsharded_losses"])) or not \
                    all(np.isfinite(t0r["losses"])):
                bad.append(f"losses {t0r['losses']} against "
                           f"{t0r['unsharded_losses']}")
            if t0r["param_diff"]["past_tol"]:
                bad.append(f"params {t0r['param_diff']}")
            if any({k: o["launches"][k] for k in want["train"]}
                   != want["train"] for o in tr):
                bad.append(f"train launches "
                           f"{line['train_launches_a_rank']}, expected "
                           f"{want['train']}")
            total = {k: total[k] + want["train"][k] for k in total}
        if not all(c["ok"] for c in line["kernel_checks"]):
            bad.append("kernels disagree with their plain versions at "
                       "local shapes: " + str(
                           [c for c in line["kernel_checks"]
                            if not c["ok"]]))
        line["spawn_seconds"] = spawn_s
        emit(line)
        if bad:
            fail(f"{run['phase']}: " + "; ".join(bad))
        counts[run["phase"]] = dict(total, grouped_matmul_by_variant=r0[
            "serve"]["launches"]["grouped_matmul_by_variant"])
    return counts


# the dry-run held to the card: each cell's step counted on meta tensors
# and counted around the real run, full width at a depth that fits
DRYRUN_CELLS = [
    dict(phase="dryrun_yi9b", arch="yi-9b", layers=8, kind="prefill",
         batch=1, seq=2048),
    dict(phase="dryrun_granite", arch="granite-moe-1b-a400m", layers=4,
         kind="train", batch=2, seq=2048),
    dict(phase="dryrun_mamba2", arch="mamba2-370m", layers=None,
         kind="prefill", batch=1, seq=2048),
]
DRYRUN_PEAK_REL = 0.10      # predicted peak against the allocator's
# each kernel's report name in the analysis, and its op in ``ops``
DRYRUN_KERNELS = {"flash_attention": "flash_attention",
                  "grouped_matmul": "grouped_matmul",
                  "ssd_intra_chunk": "ssd"}
# the production cell the phase also traces on meta in a process of its
# own, off the card
DRYRUN_CLI = ["--arch", "yi-9b", "--shape", "prefill_32k", "--mesh",
              "single"]


def start_dryrun_cli():
    """``python -m repro_torch.launch.dryrun`` of the production cell
    ``DRYRUN_CLI`` on meta under the fake process group, in a process of
    its own (no card), started now and read by ``dryrun_phases``: (the
    process, its output directory, the time it started)."""
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    # its output to files, not pipes that nobody reads until it ends
    with open(Path(out_dir) / "stdout.txt", "w") as out, \
            open(Path(out_dir) / "stderr.txt", "w") as err:
        cli = subprocess.Popen([sys.executable, "-m",
                                "repro_torch.launch.dryrun", *DRYRUN_CLI,
                                "--out", out_dir], env=env, stdout=out,
                               stderr=err)
    return cli, out_dir, time.perf_counter()


def dryrun_phases(smi: str, ops: dict, started) -> dict:
    """The dry-run against the card (``repro_torch.launch.dryrun``): each
    of ``DRYRUN_CELLS`` is counted by ``op_analysis`` on meta tensors and
    again around the real step on the card, after a warm-up step. The
    FLOPs and the kernel calls must be equal, the card's launch counts must
    equal the meta calls, and the meta peak must lie within
    ``DRYRUN_PEAK_REL`` of the change in ``max_memory_allocated``; the
    step's ms stand beside the counted roofline's dominant term. Then the
    production cell's trace, ``started`` by ``start_dryrun_cli`` well
    before (the time limit), must have printed its ``[ok]`` line."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, op_analysis

    cli, out_dir, t_cli = started
    counts = {}
    for cell in DRYRUN_CELLS:
        t0 = time.perf_counter()
        cfg = get_config(cell["arch"])
        if cell["layers"]:
            cfg = dataclasses.replace(cfg, num_layers=cell["layers"])
        step = (cfg, cell["kind"], cell["batch"], cell["seq"])
        fn, args = dryrun.local_step(*step, "meta")
        _, meta = op_analysis.analyze_step(fn, *args)
        del fn, args
        fn, args = dryrun.local_step(*step, "cuda")
        fn(*args)                 # fills the caches and cuBLAS's workspace
        torch.cuda.synchronize()
        reset_launches(ops)
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        out, card = op_analysis.analyze_step(fn, *args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - m0
        launched = read_launches(ops)
        del out
        ms = host_ms(lambda: fn(*args), iters=3)
        shape = ShapeConfig(cell["phase"], cell["seq"], cell["batch"],
                            cell["kind"])
        roof = dryrun.roofline(meta, cfg, shape, chips=1)
        dominant_s = roof[roof["dominant"]]
        calls = meta.kernel_calls
        want = {}
        for kernel, name in DRYRUN_KERNELS.items():
            c = calls.get(kernel, {})
            want[name] = c.get("fwd", 0)
            want[f"{name}_bwd"] = sum(v for d, v in c.items() if d != "fwd")
        got = {k: launched[k] for k in want}
        predicted = meta.memory["temp_bytes"]
        line = {
            "phase": cell["phase"], "arch": cell["arch"],
            "layers": cfg.num_layers, "kind": cell["kind"],
            "batch": cell["batch"], "seq": cell["seq"],
            "flops": {"meta": meta.flops, "card": card.flops},
            "dot_flops": {"meta": meta.dot_flops, "card": card.dot_flops},
            "kernel_calls": {"meta": calls, "card": card.kernel_calls},
            "launches": got, "launches_want": want,
            "hbm_bytes": {"meta": meta.hbm_bytes, "card": card.hbm_bytes},
            "peak_bytes": {"meta_temp": predicted,
                           "card_tracker_temp": card.memory["temp_bytes"],
                           "max_memory_allocated_delta": peak,
                           "rel": abs(predicted - peak) / peak},
            "ms": ms, "roofline": roof, "dominant_ms": 1e3 * dominant_s,
            "ms_over_dominant": ms / (1e3 * dominant_s),
            "measured_roofline_fraction": roof["model_flops_per_device"]
            / H100_BF16_FLOPS / (ms * 1e-3),
            "nvidia_smi": smi, "seconds": time.perf_counter() - t0}
        emit(line)
        if meta.flops != card.flops or meta.dot_flops != card.dot_flops:
            fail(f"{cell['phase']}: meta counts {meta.flops} FLOPs, the "
                 f"card {card.flops}")
        if calls != card.kernel_calls:
            fail(f"{cell['phase']}: kernel calls on meta {calls}, on the "
                 f"card {card.kernel_calls}")
        if got != want or not any(want.values()):
            fail(f"{cell['phase']}: the card launched {got}, the meta "
                 f"calls say {want}")
        if line["peak_bytes"]["rel"] > DRYRUN_PEAK_REL:
            fail(f"{cell['phase']}: predicted peak {predicted} bytes, the "
                 f"card's rose by {peak}")
        counts[cell["phase"]] = got
        del fn, args
        release(cell["phase"])
    t_wait = time.perf_counter()
    cli.wait(timeout=300)
    waited = time.perf_counter() - t_wait
    out, err = (Path(out_dir, f).read_text()
                for f in ("stdout.txt", "stderr.txt"))
    summary = [ln for ln in out.splitlines() if ln.startswith("[ok]")]
    if cli.returncode or not summary:
        fail(f"dryrun {' '.join(DRYRUN_CLI)}: exit {cli.returncode}\n"
             f"{out[-2000:]}\n{err[-3000:]}")
    print(summary[0], flush=True)
    cell = json.loads(next(Path(out_dir).glob("*.json")).read_text())
    emit({"phase": "dryrun_cli", "args": DRYRUN_CLI, "summary": summary[0],
          "chips": cell["chips"], "attn_mode": cell["attn_mode"],
          "roofline": cell["roofline"],
          "memory_analysis": cell["memory_analysis"],
          "timings_s": cell["timings_s"],
          "seconds": time.perf_counter() - t_cli, "wait_seconds": waited})
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts


# the port's examples (examples/torch_*.py), in this order, each at its
# card default; torch_train_e2e's is its --full config, saved every 100 of
# its 300 steps here, not every 10 (27 fewer saves of its 1.38 GB state:
# the time limit)
EXAMPLES = [("torch_workflow_pipeline", []), ("torch_quickstart", []),
            ("torch_elastic_restart", []), ("torch_serve_batched", []),
            ("torch_train_e2e", ["--ckpt-every", "100"])]


def _example_launches(name: str, out: dict) -> dict:
    """The kernel launches ``name``'s card default must make, from its
    result: under remat "full" each layer's forward runs twice a step."""
    from repro_torch.configs import get_config
    zero = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                          "grouped_matmul", "grouped_matmul_bwd", "ssd",
                          "ssd_bwd"), 0)
    if name == "torch_quickstart":        # granite: 5 steps, every layer MoE
        n = get_config(out["arch"]).num_layers * len(out["losses"])
        # capacity _capacity(4 * 32, 8, 32, 1.25) = 40: the tile kernel
        return {**zero, "flash_attention": 2 * n, "flash_attention_bwd": n,
                "grouped_matmul": 6 * n, "grouped_matmul_bwd": 6 * n,
                "grouped_matmul_by_variant": {"tile": 6 * n, "stream": 0,
                                              "dx": 3 * n, "dw": 3 * n,
                                              "f32": 0}}
    if name == "torch_elastic_restart":   # mamba2: 6 + 6 steps
        n = get_config(out["arch"]).num_layers * (len(out["losses1"])
                                                  + len(out["losses2"]))
        return {**zero, "ssd": 2 * n, "ssd_bwd": n}
    if name == "torch_serve_batched":     # every prefill group, the oracle's
        calls = sum(m["prefills"] for m in out["metrics"].values()) + 1
        return {**zero, "flash_attention": out["layers"] * calls}
    if name == "torch_train_e2e":
        n = 12 * out["microbatches"] * out["steps"]
        return {**zero, "flash_attention": 2 * n, "flash_attention_bwd": n}
    return zero


def examples_phases(smi: str, ops: dict, check_flash, check_flash_bwd,
                    check_gmm_bwd, misses: list) -> dict:
    """Each of the port's examples (``EXAMPLES``) through its ``main`` in
    this process at its card default, ``torch_train_e2e``'s with its
    checkpoints in a temp dir (its bytes counted, then deleted): one line
    each with its wall seconds, its own numbers and printed lines, each
    kernel's launches against ``_example_launches`` and its peak memory;
    for ``torch_train_e2e`` also tokens/s and the model FLOPs' share of the
    bf16 peak over all its steps, the median ms a step (steps 3-300) and
    one profiled step. Then
    each kernel against its plain version at every shape the examples
    launched it (logged by shims over the models' kernel calls), forward
    and, where the call was differentiated, backward; the SSD op at
    mamba2's 32 tokens padded to one 256-token chunk against the
    sequential scan, gradients included. Returns the launch counts by
    example."""
    import importlib
    import shutil

    import repro_torch.models.layers as layers
    import repro_torch.models.mamba2 as mamba2
    import repro_torch.models.moe as moe
    from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                           device_batch)
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.launch.specs import MetaGenerator
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                                 make_train_step)

    sys.path.insert(0, str(ROOT / "examples"))
    from torch_train_e2e import full_config
    fa_ops, gmm_ops, ssd_ops = (ops[k] for k in ("flash_attention",
                                                  "grouped_matmul", "ssd"))
    # each kernel's shapes in the examples, and whether a call at the shape
    # was differentiated
    seen = {"flash": {}, "gmm": {}, "ssd": {}}
    wrapped = (layers.flash_attention, moe.grouped_matmul,
               mamba2.ssd_chunked)

    def log(kind, key, *ts):
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in ts)
        seen[kind][key] = seen[kind].get(key, False) or grad

    def flash_logged(q, k, v, *, causal=True, window=0, softcap=0.0):
        b, s, h, d = q.shape
        log("flash", ((b, s, h, k.shape[2], d, window, float(softcap)),
                      q.dtype), q, k, v)
        return wrapped[0](q, k, v, causal=causal, window=window,
                          softcap=softcap)

    def gmm_logged(x, w):
        log("gmm", (tuple(x.shape) + (w.shape[-1],), x.dtype), x, w)
        return wrapped[1](x, w)

    def ssd_logged(x, dt, A, B, C, chunk):
        log("ssd", (*x.shape, B.shape[-1], chunk), x, dt, A, B, C)
        return wrapped[2](x, dt, A, B, C, chunk)

    counts = {}
    layers.flash_attention, moe.grouped_matmul, mamba2.ssd_chunked = (
        flash_logged, gmm_logged, ssd_logged)
    try:
        for name, argv in EXAMPLES:
            t0 = time.perf_counter()
            ckpt = None
            if name == "torch_train_e2e":
                ckpt = Path(tempfile.mkdtemp(prefix="train_e2e_"))
                argv = argv + ["--ckpt-dir", str(ckpt)]
            printed = io.StringIO()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(ops)
            try:
                with contextlib.redirect_stdout(printed):
                    out = importlib.import_module(name).main(argv)
                torch.cuda.synchronize()
            except Exception as exc:
                fail(f"example {name} {argv}: {type(exc).__name__}: {exc}\n"
                     f"{printed.getvalue()[-3000:]}")
            finally:
                ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                                 if f.is_file()) if ckpt else 0
                if ckpt:
                    shutil.rmtree(ckpt, ignore_errors=True)
            seconds = time.perf_counter() - t0
            counts[name] = got = read_launches(ops)
            want = _example_launches(name, out)
            line = {"phase": "example", "example": name, "argv": argv,
                    "seconds": seconds, "result": out,
                    "printed": printed.getvalue().splitlines(),
                    "launches": got, "expected_launches": want,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            if name == "torch_train_e2e":
                cfg = full_config()
                tokens = out["global_batch"] * out["seq_len"]
                median_ms = 1e3 * float(np.median(out["step_s"][2:]))
                meta = build_model(cfg, device="meta").init(MetaGenerator())
                flops = model_flops(cfg, meta, tokens, out["seq_len"])
                losses = out["losses"]
                steps_s = float(sum(out["step_s"]))   # every step's time
                line.update(
                    mode=out["mode"], params=out["params"],
                    steps_seconds=steps_s,
                    tokens_per_s=tokens * len(out["step_s"]) / steps_s,
                    model_flops_per_step=flops,
                    model_flops_share_of_bf16_peak=flops
                    * len(out["step_s"]) / steps_s / H100_BF16_FLOPS,
                    step_ms_median_3_300=median_ms,
                    tokens_per_s_at_median_step=tokens / median_ms * 1e3,
                    checkpoint_gb_written=ckpt_bytes / 1e9)
                if not (out["mode"] == "full" and out["steps"] == 300
                        and len(losses) == out["steps"]
                        and losses[-1] < losses[0]
                        and all(np.isfinite(losses))):
                    fail(f"{name}: losses {losses[:3]} ... {losses[-3:]} "
                         f"not {out['steps']} finite and falling")
            emit({**line, "card": smi})
            if {k: got[k] for k in want} != want:
                fail(f"example {name}: launches {got}, expected {want}")
            del out
            release(name)
    finally:
        layers.flash_attention, moe.grouped_matmul, mamba2.ssd_chunked = \
            wrapped

    # one profiled step of train_e2e --full's config, after a warm one
    cfg = full_config()
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=5, total_steps=300)
    holder = [init_state(model, opt_cfg,
                         torch.Generator(device="cuda").manual_seed(0))]
    step_fn = make_train_step(model, cfg, opt_cfg,
                              TrainStepConfig(microbatches=2))
    batch = device_batch(SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=512, global_batch=8)).batch(0),
        "cuda")

    def one_step():
        holder[0], _ = step_fn(holder[0], batch)
    one_step()
    emit({"phase": "example_profile", "example": "torch_train_e2e",
          **step_profile(one_step, shares={"flash": "flash"}), "card": smi})
    del model, holder, step_fn, batch
    release("example_profile")

    # each kernel against its plain version at the examples' shapes
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(29)
    for (case, dtype), grad in sorted(seen["flash"].items(), key=str):
        check_flash(case, dtype, phase="kernel_vs_plain_examples")
        if grad:
            check_flash_bwd(case, dtype)
    for ((e, c, d, f), dtype), grad in sorted(seen["gmm"].items(), key=str):
        x = randn((e, c, d), dtype, gen, 0.3)
        w = randn((e, d, f), dtype, gen, 0.3)
        tol = 3e-4 if dtype == torch.float32 else 3e-2
        err, ok = close(gmm_ops.grouped_matmul(x, w),
                        grouped_matmul_ref(x, w), tol)
        emit({"phase": "kernel_vs_plain_examples", "kernel":
              "grouped_matmul", "shape": {"E": e, "C": c, "d": d, "f": f},
              "dtype": str(dtype).removeprefix("torch."),
              "max_abs_err": err, "tol": tol, "ok": ok})
        if not ok:
            misses.append(("grouped_matmul", (e, c, d, f), str(dtype)))
        if grad:
            check_gmm_bwd((e, c, d, f), dtype)
    for (b, s, nh, hd, ds, ch), grad in sorted(seen["ssd"].items()):
        ins = [t.requires_grad_() for t in ssd_inputs(b, s, nh, hd, ds, gen,
                                                      wide_decay=True)]
        before = (ssd_ops.launches, ssd_ops.bwd_launches)
        y, st = ssd_ops.ssd_chunked(*ins, ch)
        dy, dst = randn(y.shape, y.dtype, gen), randn(st.shape, st.dtype, gen)
        grads = torch.autograd.grad((y, st), ins, (dy, dst))
        torch.cuda.synchronize()
        launched = (ssd_ops.launches - before[0],
                    ssd_ops.bwd_launches - before[1])
        ref_ins = [t.detach().requires_grad_() for t in ins]
        ry, rst = mamba2.ssd_ref(*ref_ins)
        refs = torch.autograd.grad((ry, rst), ref_ins, (dy, dst))
        errs, tops, ok = {}, {}, launched == (1, 1)
        for label, g, r in zip(("y", "state", "dx", "ddt", "dA", "dB", "dC"),
                               (y.detach(), st.detach()) + grads,
                               (ry.detach(), rst.detach()) + refs):
            errs[label] = float((g - r).abs().max())
            tops[label] = float(r.abs().max())
            ok = ok and bool(torch.isfinite(g).all()) and bool((
                (g - r).abs() <= SSD_BWD_TOL["atol_of_max"] * tops[label]
                + SSD_BWD_TOL["rtol"] * r.abs()).all())
        emit({"phase": "kernel_vs_plain_examples", "kernel": "ssd",
              "op": "ssd_chunked", "against": "sequential ssd_ref, autograd",
              "shape": {"b": b, "S": s, "nh": nh, "hd": hd, "ds": ds,
                        "chunk": ch}, "padded_rows": (-s) % ch,
              "differentiated_in_example": grad,
              "launched_fwd_bwd": list(launched), "max_abs_err": errs,
              "max": tops, "tol": SSD_BWD_TOL, "dtype": "float32",
              "ok": ok})
        if not ok:
            misses.append(("ssd_chunked", (b, s, nh, hd, ds, ch), "float32"))
    emit({"phase": "kernel_vs_plain_examples",
          **{f"{kind}_shapes": sorted(
              [[str(k), g] for k, g in seen[kind].items()])
             for kind in seen}, "seconds": time.perf_counter() - t0})
    if misses:
        fail(f"a kernel disagrees with its plain version at an example's "
             f"shape: {misses}")
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
    # the f32 parity runs' CPU halves, beside the build and the kernel checks
    parity = CpuParity()
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
    # the embeddings input mode's shapes, forward and backward, before any
    # model phase runs them
    embeddings_errs = {}
    for case in EMBEDDINGS_ATTN:
        for dtype in (torch.float32, torch.bfloat16):
            embeddings_errs[(case, dtype)] = (check_flash(case, dtype),
                                              check_flash_bwd(case, dtype))
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
    # flash_embeddings_shapes: the embeddings input mode's shapes, the
    # kernels' errors (section 3) and times beside their bounds, the plain
    # versions and SDPA's forward and backward
    by_shape = []
    for case in EMBEDDINGS_ATTN:
        fwd, bwd = time_flash(case), time_flash_bwd(case)
        kernels["flash_attention"].setdefault("by_embeddings_shape", []) \
            .append(dict(fwd, shape=case))
        kernels["flash_attention_bwd"]["by_shape"].append(dict(bwd,
                                                              shape=case))
        line = {"shape": dict(zip("B S H KV D".split(), case[:5]))}
        for dtype in (torch.float32, torch.bfloat16):
            (ferr, ftol), (berr, btol) = embeddings_errs[(case, dtype)]
            line[str(dtype).removeprefix("torch.")] = {
                "fwd_max_abs_err": ferr, "fwd_tol": ftol,
                "bwd_max_abs_err": berr, "bwd_tol_of_max": btol}
        for name, t in (("fwd", fwd), ("bwd", bwd)):
            line[name] = {k: t[k] for k in ("kernel_ms", "bound_ms",
                                            "bound_by", "share_of_bound",
                                            "plain_ms", "library_ms")}
        by_shape.append(line)
    emit({"phase": "flash_embeddings_shapes", "dtype_timed": "bfloat16",
          "library": "scaled_dot_product_attention (causal, enable_gqa)",
          "shapes": by_shape, "card": smi})
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

    def flash_bwd_inputs(case):
        """bf16 q, k, v, dO and the forward's output and log-sum-exp."""
        b, s, h, kv, d, win, cap = case
        q, k, v = (randn((b, s, n, d), dtype, gen) for n in (h, kv, kv))
        dout = randn((b, s, h, d), dtype, gen)
        out, lse = fa_ops._forward(q, k, v, True, win, cap, with_lse=True)
        return q, k, v, dout, out, lse

    # head dims 64 and 128 (bwd_kernel) and 256 (bwd_d256_kernel)
    for case in (YI_TRAIN_ATTN, GEMMA3_UNWINDOWED_ATTN):
        b, s, h, kv, d, win, cap = case
        q, k, v, dout, out, lse = flash_bwd_inputs(case)
        names = {n: calls for n, (_, calls) in device_kernels(
            lambda: fa_ops.flash_attention_bwd(
                q, k, v, out, dout, lse, window=win, softcap=cap)).items()}
        roles = {n: "D" if "delta_kernel" in n else
                 "main" if "bwd_wg::bwd_kernel" in n
                 or "bwd_wg::bwd_d256_kernel" in n else
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
    for case in (YI_TRAIN_ATTN, GRANITE_TRAIN_ATTN, GEMMA3_UNWINDOWED_ATTN):
        b, s, h, kv, d, win, cap = case
        q, k, v, dout, out, lse = flash_bwd_inputs(case)
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
    dryrun_cli = start_dryrun_cli()     # off the card, read in 4d
    train_counts = training_phases(smi, ops, parity)
    train_counts.update(embeddings_phases(smi, ops))
    # -- 4c. the distributed layer: ranks share the card; prefill and
    # decode sharded, the SSM and hybrid families -------------------------
    train_counts.update(rank_phases(smi))
    # -- 4d. the dry-run's counts against the card --------------------------
    train_counts.update(dryrun_phases(smi, ops, dryrun_cli))

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
    # -- 7b. the port's examples at their card defaults ----------------------
    train_counts.update(examples_phases(smi, ops, check_flash,
                                        check_flash_bwd, check_gmm_bwd,
                                        misses))
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
