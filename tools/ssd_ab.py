"""This checkout's SSD wrappers and kernels against those of another
checkout, alternated in one process on one card.

    python3 tools/ssd_ab.py --other DIR [--rounds 15] [--bwd-rounds 3]
                            [--steps 3]

DIR holds another checkout of the repo, for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``). Its ``src/repro_torch/kernels/ssd/ops.py`` is loaded beside
this checkout's, built by that checkout's own ``kernels/_build.py`` from its
own sources and headers; everything else is this checkout's code. Every
A/B reading is taken for both sides in the order this, other, other, this,
once a round:

* forward kernel ms, cold and warm L2, at mamba2-370m's 1024- and 256-token
  prefill shapes (``chip_smoke.py``'s ``cold_ms`` and ``cuda_ms``; 2
  rounds);
* host µs to launch one forward call at the 1024-token shape (``host_us``);
* host ms of mamba2-370m's 1 x 1024 prefill to the end of its device work
  (``host_ms``), full depth and width, bf16, random weights from seed 0,
  each side's ``ssd_intra_chunk`` swapped in;
* backward kernel ms, cold, at the training microbatches of train_mamba2
  (4, 2048, 32, 64, 128, 256) and train_zamba2 (4, 2048, 64, 64, 64, 256)
  (``--bwd-rounds`` rounds), and each side's grids by device ms in one
  profiled call at each shape;
* host ms of a train step of ``chip_smoke.py``'s train_zamba2 (full width
  and depth, one fixed 4 x 2048 batch, random weights from seed 0), median
  of ``--steps`` steps a reading, each side's ``ssd_intra_chunk_bwd``
  swapped in (none with ``--steps 0``); then one profiled step of each
  side, its top kernels by device time.

Prints one JSON line with every reading and each side's median, then the
card's name and power limit.
"""
from __future__ import annotations

import gc
import json
import statistics
import sys
import time

import torch

import ab  # puts the repo root and src/ on sys.path
import chip_smoke as cs  # the measurement helpers


def bwd_sets(case, gen) -> list:
    """Input sets of the backward (a, xdt, B, C, dy, dS) past the L2, as
    ``chip_smoke.py`` times it."""
    b, s, nh, hd, ds, ch = case

    def one_set():
        a, xdt, Bc, Cc = cs.ssd_kernel_inputs(
            *cs.ssd_inputs(b, s, nh, hd, ds, gen, wide_decay=True), ch)
        return (a, xdt, Bc.contiguous(), Cc.contiguous(),
                cs.randn(xdt.shape, torch.float32, gen),
                cs.randn((b, nh, s // ch, ds, hd), torch.float32, gen))
    return [one_set() for _ in range(
        2 + 2 * cs.L2_BYTES // cs.ssd_bwd_set_bytes(b, s, nh, hd, ds, ch))]


def zamba2_steps(sides: dict, rounds: int, steps: int) -> dict:
    """``ab.abba`` of the median host ms of ``steps`` train_zamba2 steps,
    each side's backward wrapper swapped into this checkout's ops module
    (``SSDIntraChunk.backward`` calls it by name), then one profiled step
    of each side."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                                 make_train_step)
    ops = sides["this"]
    bwd = {side: mod.ssd_intra_chunk_bwd for side, mod in sides.items()}
    cfg = get_config("zamba2-1.2b")
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    box = {"state": init_state(model, opt_cfg,
                               torch.Generator(device="cuda").manual_seed(0))}
    step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=cs.ZAMBA2_TRAIN["seq"],
                                      global_batch=cs.ZAMBA2_TRAIN["batch"]))
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}

    def one_step():
        box["state"], metrics = step_fn(box["state"], batch)
        float(metrics["loss"])            # waits for the step

    def read(side):
        ops.ssd_intra_chunk_bwd = bwd[side]
        ms = []
        for _ in range(steps):
            t = time.perf_counter()
            one_step()
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms)

    try:
        one_step()                        # allocations
        out = {"step_ms": ab.abba(read, rounds)}
        for side in sides:
            ops.ssd_intra_chunk_bwd = bwd[side]
            one_step()
            out[f"profile_{side}"] = cs.step_profile(one_step, top=16)
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return out
    finally:
        ops.ssd_intra_chunk_bwd = bwd["this"]
        del box, model, step_fn, batch
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    args = ab.parse_args(__doc__, 15, bwd_rounds=3, steps=3)
    if args is None:
        return 1

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops
    from repro_torch.models.model import build_model

    sides = {"this": ops, "other": ab.load_other(args.other, ("ssd",))["ssd"]}
    wrappers = {side: mod.ssd_intra_chunk for side, mod in sides.items()}
    out = {"other": str(args.other), "rounds": args.rounds}
    gen = torch.Generator(device="cuda").manual_seed(0)

    for label, case in (("1024", cs.SSD_PREFILL), ("256", cs.SSD_PREFILL_256)):
        b, s, nh, hd, ds, ch = case
        sets = [cs.ssd_kernel_inputs(*cs.ssd_inputs(b, s, nh, hd, ds, gen), ch)
                for _ in range(2 + 2 * cs.L2_BYTES
                               // cs.ssd_set_bytes(b, s, nh, hd, ds, ch))]
        out[f"kernel_cold_ms_{label}"] = ab.abba(
            lambda side: cs.cold_ms(lambda st: wrappers[side](*st), sets, 40),
            2)
        out[f"kernel_warm_ms_{label}"] = ab.abba(
            lambda side: cs.cuda_ms(lambda: wrappers[side](*sets[0]), 40), 2)
        if label == "1024":
            out["host_us_per_call"] = ab.abba(
                lambda side: cs.host_us(lambda: wrappers[side](*sets[0])),
                args.rounds)
        del sets

    cfg = get_config("mamba2-370m")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (1, 1024), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))

    def prefill_ms(side):
        ops.ssd_intra_chunk = wrappers[side]
        return cs.host_ms(lambda: model.prefill(params, toks, 2048))

    with torch.inference_mode():
        out["prefill_1x1024_host_ms"] = ab.abba(prefill_ms, args.rounds)
    ops.ssd_intra_chunk = wrappers["this"]
    del model, params

    for label, case in (("mamba2", cs.MAMBA2_TRAIN_SSD),
                        ("zamba2", cs.ZAMBA2_TRAIN_SSD)):
        sets = bwd_sets(case, gen)
        out[f"bwd_cold_ms_{label}"] = ab.abba(
            lambda side: cs.cold_ms(
                lambda st: sides[side].ssd_intra_chunk_bwd(*st), sets, 10),
            args.bwd_rounds)
        for side, mod in sides.items():
            mod.ssd_intra_chunk_bwd(*sets[0])
            prof = cs.step_profile(lambda: mod.ssd_intra_chunk_bwd(*sets[0]))
            out[f"bwd_grids_{label}_{side}"] = prof.get(
                "top_kernels", prof.get("profile"))
        del sets
        gc.collect()
        torch.cuda.empty_cache()

    if args.steps > 0:
        out["train_zamba2"] = zamba2_steps(sides, args.bwd_rounds,
                                           args.steps)

    print(json.dumps(out), flush=True)
    ab.print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
