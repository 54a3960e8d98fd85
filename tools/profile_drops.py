"""How often a profile of one backward call loses a kernel's record, with
and without the host guard of ``repro_torch.kernels.profiling``.

    python3 tools/profile_drops.py [--trials 100] [--guard SECONDS]

Each trial takes, for each backward wrapper that ``chip_smoke.py``'s
``profiled_bwd`` checks, one profile through ``recorded_events`` with no
guard and one with ``--guard`` seconds (default ``HOST_GUARD_S``), in
that order, on the same bf16
(flash attention, grouped matmul) or f32 (SSD) inputs, random from seed 0,
at the check's shapes: the grouped matmul's (32, 2560, 1024, 512), flash
attention's train_yi9b batch (4, 2048, 32, 4, 128) and the SSD's mamba2
microbatch (4, 2048, 32, 64, 128, 256). A profile is short when a grid the
wrapper launches once a call is missing from it. Also read from each
profile: how far the recorded call's first kernel starts after the
recorded step opens, on the profiler's clock (negative: before it opened;
under the guard: earlier than the host let it start).

Prints one JSON line a wrapper and arm (trials, short profiles, the grids
missing and how often, the least and median lead in microseconds, and how
many leads fell under the arm's guard), then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

import ab  # noqa: F401  (puts the repo root and src/ on sys.path)
import chip_smoke as cs

# each wrapper's grids, by a part of their names, each launched once a call
GRIDS = {
    "grouped_matmul_bwd": ("gmm_dx_kernel", "gmm_dw_kernel"),
    "flash_attention_bwd": ("delta_kernel", "bwd_kernel", "dq_cast_kernel",
                            "FillFunctor"),
    "ssd_bwd": ("bwd_prep_kernel", "bwd_dg_kernel", "bwd_head_kernel",
                "bwd_dbc_kernel"),
}


def calls() -> dict:
    """Each wrapper's call on its inputs at the profiled check's shape."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    e, c, d, f = cs.GMM_BWD[0]
    x, w, dy = (cs.randn(s, bf16, gen, 0.3)
                for s in ((e, c, d), (e, d, f), (e, c, f)))
    b, s, h, kv, hd, win, cap = cs.YI_TRAIN_ATTN
    q, k, v = (cs.randn((b, s, n, hd), bf16, gen) for n in (h, kv, kv))
    dout = cs.randn((b, s, h, hd), bf16, gen)
    out, lse = fa_ops._forward(q, k, v, True, win, cap, with_lse=True)
    b, s, nh, hd, ds, ch = cs.MAMBA2_TRAIN_SSD
    a, xdt, B, C = cs.ssd_kernel_inputs(
        *cs.ssd_inputs(b, s, nh, hd, ds, gen, wide_decay=True), ch)
    dy_ssd = cs.randn(xdt.shape, torch.float32, gen)
    dS = cs.randn((b, nh, s // ch, ds, hd), torch.float32, gen)
    B, C = B.contiguous(), C.contiguous()
    return {
        "grouped_matmul_bwd": lambda: gmm_ops.grouped_matmul_bwd(x, w, dy),
        "flash_attention_bwd": lambda: fa_ops.flash_attention_bwd(
            q, k, v, out, dout, lse, window=win, softcap=cap),
        "ssd_bwd": lambda: ssd_ops.ssd_intra_chunk_bwd(a, xdt, B, C, dy_ssd,
                                                       dS),
    }


def read(events, grids) -> tuple[list, float | None]:
    """The grids missing from one profile, and its first kernel's start
    less the recorded step's, in microseconds."""
    from torch.autograd import DeviceType
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    steps = [e for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("ProfilerStep")]
    missing = [g for g in grids if not any(g in e.name for e in kernels)]
    lead = (min(e.time_range.start for e in kernels) -
            min(e.time_range.start for e in steps)) \
        if kernels and steps else None
    return missing, lead


def main(argv=None) -> int:
    from repro_torch.kernels.profiling import HOST_GUARD_S, recorded_events
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--guard", type=float, default=HOST_GUARD_S)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    fns = calls()
    for fn in fns.values():            # build and warm every kernel
        fn()
    torch.cuda.synchronize()
    arms = {0.0: "no guard", args.guard: f"guard {args.guard} s"}
    got = {(n, g): {"short": 0, "missing": {}, "leads": []}
           for n in fns for g in arms}
    for _ in range(args.trials):
        for name, fn in fns.items():
            for guard in arms:
                missing, lead = read(recorded_events(fn, guard), GRIDS[name])
                cell = got[(name, guard)]
                cell["short"] += bool(missing)
                for g in missing:
                    cell["missing"][g] = cell["missing"].get(g, 0) + 1
                if lead is not None:
                    cell["leads"].append(lead)
    for (name, guard), cell in got.items():
        leads = cell.pop("leads")
        print(json.dumps({"wrapper": name, "arm": arms[guard],
                          "trials": args.trials, **cell,
                          "leads_under_guard": sum(
                              lead < guard * 1e6 for lead in leads),
                          "lead_us_min": min(leads) if leads else None,
                          "lead_us_median": statistics.median(leads)
                          if leads else None}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
