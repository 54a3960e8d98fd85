"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each: the device; the kernel build from the sources in
this checkout (nvcc, sm_90a); every kernel against its plain PyTorch version
on the card; kernel timings beside their bound and a library yardstick;
full-width yi-9b (depth 2, float32) engine tokens against the port's greedy
oracle; full yi-9b (48 layers, bf16) served through ``build_replicaset`` and
``run_load`` with the kernel launch counts of that run. Then one line with
every kernel's numbers and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, and prints no result line, without a card, outside a full
checkout, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12

# the sweep of tests/test_kernels.py: (B, S, H, KV, D, window, softcap)
SWEEP = [(2, 128, 4, 4, 32, 0, 0.0), (2, 192, 4, 2, 64, 0, 0.0),
         (2, 128, 4, 2, 32, 48, 0.0), (2, 128, 2, 2, 64, 0, 30.0),
         (2, 96, 8, 1, 32, 32, 50.0)]
YI_PREFILL = (4, 1024, 32, 4, 128, 0, 0.0)     # serving prefill at full width


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, s, h, kv, d, window, dtype) -> tuple[float, str]:
    """Least time for causal attention on these inputs: the larger of the
    operations on the unmasked (q, k) pairs (QK^T and PV, 2 flops per
    multiply-add each) over the peak rate for the dtype, and q, k, v read
    once plus o written once over the memory rate."""
    qpos = np.arange(s)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, int)
    pairs = int(np.sum(qpos - lo + 1))
    flops = 4.0 * d * b * h * pairs
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    nbytes = b * s * (2 * h + 2 * kv) * d * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core.monitoring import Monitor
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.serve import (build_replicaset, make_prompts,
                                          run_load)
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine, greedy_generate

    kernels = {"flash_attention": {
        "name": "flash_attention", "route": "cuda",
        "source": str(fa_ops.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
        "tpu_kernel": "src/repro/kernels/flash_attention/kernel.py:"
                      "flash_attention_kernel"}}

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
    sources = {"flash_attention": fa_ops.SOURCE}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = {n: pool.submit(_build.build, src)
                 for n, src in sources.items()}
        built = {n: f.result() for n, f in built.items()}
    for name, (lib, report, secs) in built.items():
        ptxas = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        emit({"phase": "build", "kernel": name, "library": lib.name,
              "nvcc_seconds": secs, "ptxas": ptxas})
    fa_ops.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    # -- 3. kernel vs plain version on the card ----------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    misses, main_err = [], {}
    for case in SWEEP + [YI_PREFILL]:
        b, s, h, kv, d, win, cap = case
        for dtype in (torch.float32, torch.bfloat16):
            q = randn((b, s, h, d), dtype, gen)
            k = randn((b, s, kv, d), dtype, gen)
            v = randn((b, s, kv, d), dtype, gen)
            out = fa_ops.flash_attention(q, k, v, window=win, softcap=cap)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, window=win, softcap=cap)
            # f32: summation order (longer rows at S=1024); bf16: output
            # rounding, the kernel keeps probabilities in f32
            tol = 2e-2 if dtype == torch.bfloat16 else (
                1e-4 if s >= 1024 else 2e-5)
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            ok = bool((diff <= tol + tol * ref.float().abs()).all())
            emit({"phase": "kernel_vs_plain", "kernel": "flash_attention",
                  "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": d},
                  "window": win, "softcap": cap,
                  "dtype": str(dtype).removeprefix("torch."),
                  "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                misses.append(case)
            if case == YI_PREFILL and dtype == torch.bfloat16:
                main_err = {"max_abs_err": err, "max_err": err, "tol": tol}
    if misses:
        fail(f"flash_attention disagrees with its plain version: {misses}")
    kernels["flash_attention"].update(main_err)
    emit({"phase": "kernel_vs_plain", "seconds": time.perf_counter() - t0})

    # -- 4. timing at the serving prefill shape, bf16 -----------------------
    t0 = time.perf_counter()
    b, s, h, kv, d, win, cap = YI_PREFILL
    dtype = torch.bfloat16
    q, k, v = (randn((b, s, n, d), dtype, gen) for n in (h, kv, kv))
    kernel_ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True), 20)
    except TypeError:       # a torch without enable_gqa: no yardstick
        library_ms = None
    bound_ms, bound_by = attention_bound_ms(b, s, h, kv, d, win, dtype)
    timing = {"kernel_ms": kernel_ms, "ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by}
    kernels["flash_attention"].update(timing)
    emit({"phase": "timing", "kernel": "flash_attention",
          "shape": {"B": b, "S": s, "H": h, "KV": kv, "D": d},
          "dtype": "bfloat16", **timing,
          "kernel_tflops": 4.0 * d * b * h * (s * (s + 1) // 2)
          / (kernel_ms * 1e-3) / 1e12,
          "card": smi, "seconds": time.perf_counter() - t0})
    del q, k, v, qt, kt, vt

    # -- 5. full width, depth 2, float32: engine tokens == oracle ----------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=2,
                              dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    eng = ServingEngine(model, params, slots=4, max_seq=640, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in (64, 200, 377, 512)]
    futs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    eng.run_until_idle()
    mismatched = []
    for i, (p, f) in enumerate(zip(prompts, futs)):
        got, want = f.result(), greedy_generate(model, params, p, 16, 640)
        if got.shape != (16,) or not np.array_equal(got, want):
            mismatched.append({"prompt_len": len(p), "engine": got.tolist(),
                               "oracle": want.tolist()})
    emit({"phase": "parity_full_width_f32", "layers": cfg.num_layers,
          "d_model": cfg.d_model, "prompt_lens": [len(p) for p in prompts],
          "new_tokens": 16, "identical": not mismatched,
          "mismatched": mismatched, "seconds": time.perf_counter() - t0})
    if mismatched:
        fail("engine tokens differ from the greedy oracle at full width")
    del model, params, eng
    torch.cuda.empty_cache()

    # -- 6. serve full yi-9b (48 layers, bf16) through the entry points ----
    t0 = time.perf_counter()
    cfg = get_config("yi-9b")
    torch.cuda.reset_peak_memory_stats()
    rs = build_replicaset(cfg, replicas=1, slots=4, max_seq=2048,
                          monitor=Monitor())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = make_prompts(8, cfg.vocab_size, rng, lo=256, hi=1025)
    fa_ops.launches = 0                 # count only the main path's launches
    rs.start()
    try:
        report = run_load(rs, prompts, rate_rps=4.0, max_new_tokens=32,
                          rng=rng, timeout_s=600.0)
    finally:
        rs.stop()
    launches = {"flash_attention": fa_ops.launches}
    prefills = rs.metrics()["total"]["prefills"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "dtype": cfg.dtype, "replicas": 1, "slots": 4, "max_seq": 2048,
          "prompt_lens": [len(p) for p in prompts], "rate_rps": 4.0,
          "max_new_tokens": 32, "report": report,
          "prefill_calls": prefills, "launches": launches,
          "peak_memory_gb": peak_gb, "init_seconds": init_s, "card": smi,
          "seconds": time.perf_counter() - t0})
    if report["completed"] != 8 or report["tokens"] != 8 * 32:
        fail(f"served {report['completed']}/8 requests, "
             f"{report['tokens']}/{8 * 32} tokens")
    if prefills <= 0 or launches["flash_attention"] != \
            cfg.num_layers * prefills:
        fail(f"flash_attention launched {launches['flash_attention']} times "
             f"for {prefills} prefill calls of {cfg.num_layers} layers")

    # where a step's time goes (after the counted run): one prefill at the
    # largest serving shape and one fused decode step, host clock + sync
    t0 = time.perf_counter()
    eng = rs.engines[0]
    with torch.inference_mode():
        toks = torch.randint(1, cfg.vocab_size, (4, 1024), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(2))
        times = {}
        for label, fn in (
                ("prefill_4x1024_ms",
                 lambda: eng.model.prefill(eng.params, toks, 2048)),
                ("decode_step_4_slots_ms",
                 lambda: eng.model.decode(
                     eng.params, eng.cache, toks[:, :1],
                     torch.full((4,), 1500, device="cuda")))):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            times[label] = (time.perf_counter() - t) / 3 * 1e3
    times["flash_share_of_prefill"] = (
        cfg.num_layers * kernel_ms / times["prefill_4x1024_ms"])
    emit({"phase": "serve_breakdown", **times, "card": smi,
          "seconds": time.perf_counter() - t0})
    del rs, eng
    torch.cuda.empty_cache()

    # -- 7. kernels, 8. result -------------------------------------------
    for name, n in launches.items():
        kernels[name]["launches"] = n
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": device})


if __name__ == "__main__":
    main()
