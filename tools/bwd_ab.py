"""This checkout's backward kernels (flash attention's, the grouped matmul's
dx and dw) against those of another checkout, alternated in one process on
one card.

    python3 tools/bwd_ab.py --other DIR [--rounds 3] [--steps 3]

DIR holds another checkout of the repo, for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``). Its ``flash_attention/ops.py`` and ``grouped_matmul/ops.py``
are loaded beside this checkout's, each built by that checkout's own
``kernels/_build.py`` from its own sources and headers into its own
``build/kernels/``. Every reading is taken for both sides in the order
this, other, other, this, once a round, on the same bf16 inputs (random,
seed 0), with ``chip_smoke.py``'s ``cuda_ms``:

* ``flash_attention_bwd`` ms at train_yi9b's (4, 2048, 32, 4, 128) and
  train_granite's (4, 2048, 16, 8, 64), from this checkout's forward
  output and log-sum-exp;
* ``grouped_matmul_bwd`` ms at granite's training capacity (C = 2560),
  wi/wg's (32, 2560, 1024, 512) and wo's (32, 2560, 512, 1024);
* host ms of a train step, to the loss on the host, median of
  ``--steps`` steps a reading (none with ``--steps 0``), with each side's
  two backward wrappers swapped in for this checkout's:
  ``chip_smoke.py``'s train_yi9b (yi-9b at full width, 16 layers, remat
  "full", 4 x 2048) and train_granite's (granite-moe-1b-a400m at full
  width and depth, 8 x 2048 in 2 microbatches), each on one fixed batch,
  random weights from seed 0.

Prints one JSON line with every reading and each side's median, then the
card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
import torch

import ab  # puts the repo root and src/ on sys.path
import chip_smoke as cs  # the measurement helpers


def train_cases() -> list:
    """(label, model config, TrainStepConfig, batch, sequence length) of
    chip_smoke.py's train_yi9b and train_granite."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.training.train_step import TrainStepConfig
    yi = dataclasses.replace(get_config("yi-9b"),
                             num_layers=cs.YI_TRAIN["layers"],
                             remat_policy="full")
    granite = dict(zip(cs.GRANITE_TRAIN[::2], cs.GRANITE_TRAIN[1::2]))
    return [("yi9b_16_layers_4x2048", yi, TrainStepConfig(),
             cs.YI_TRAIN["batch"], cs.YI_TRAIN["seq"]),
            ("granite_8x2048", get_config(granite["--arch"]),
             TrainStepConfig(microbatches=int(granite["--microbatches"])),
             int(granite["--global-batch"]), int(granite["--seq-len"]))]


def train_step_ab(cfg, ts, batch_size: int, seq: int, sides: dict,
                  rounds: int, steps: int) -> dict:
    """``ab.abba`` of the median host ms of ``steps`` train steps, each
    side's flash and grouped-matmul backward wrappers swapped into this
    checkout's ops modules (the autograd functions call them by name)."""
    import gc

    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.training.train_step import init_state, make_train_step
    fa_ops = sides["this"]["flash_attention"]
    gmm_ops = sides["this"]["grouped_matmul"]
    # each side's wrappers, taken before any swap
    bwd = {side: (ops["flash_attention"].flash_attention_bwd,
                  ops["grouped_matmul"].grouped_matmul_bwd)
           for side, ops in sides.items()}
    model = build_model(cfg, device="cuda")
    opt_cfg = OptimizerConfig(warmup_steps=2, total_steps=100)
    state = init_state(model, opt_cfg,
                       torch.Generator(device="cuda").manual_seed(0))
    step_fn = make_train_step(model, cfg, opt_cfg, ts)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch_size))
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch(0).items()}
    box = {"state": state}

    def read(side):
        fa_ops.flash_attention_bwd, gmm_ops.grouped_matmul_bwd = bwd[side]
        ms = []
        for _ in range(steps):
            t = time.perf_counter()
            box["state"], metrics = step_fn(box["state"], batch)
            float(metrics["loss"])            # waits for the step
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms)

    try:
        box["state"] = step_fn(box["state"], batch)[0]   # allocations
        return ab.abba(read, rounds)
    finally:
        fa_ops.flash_attention_bwd, gmm_ops.grouped_matmul_bwd = bwd["this"]
        del box, state, model, step_fn, batch
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    args = ab.parse_args(__doc__, 3, steps=3)
    if args is None:
        return 1

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops

    other = ab.load_other(args.other, ("flash_attention", "grouped_matmul"))
    sides = {"this": {"flash_attention": fa_ops, "grouped_matmul": gmm_ops},
             "other": other}
    out = {"other": str(args.other), "rounds": args.rounds}
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = torch.bfloat16

    for label, case in (("yi9b", cs.YI_TRAIN_ATTN),
                        ("granite", cs.GRANITE_TRAIN_ATTN)):
        b, s, h, kv, d, win, cap = case
        q, k, v = (cs.randn((b, s, n, d), dtype, gen) for n in (h, kv, kv))
        dout = cs.randn((b, s, h, d), dtype, gen)
        o, lse = fa_ops._forward(q, k, v, True, win, cap, with_lse=True)
        out[f"flash_bwd_ms_{label}"] = ab.abba(
            lambda side: cs.cuda_ms(
                lambda: sides[side]["flash_attention"].flash_attention_bwd(
                    q, k, v, o, dout, lse, window=win, softcap=cap), 10),
            args.rounds)
        del q, k, v, dout, o, lse

    for label, (e, c, d, f) in (("wi", cs.GMM_BWD[0]), ("wo", cs.GMM_BWD[1])):
        x = cs.randn((e, c, d), dtype, gen, 0.3)
        w = cs.randn((e, d, f), dtype, gen, 0.3)
        dy = cs.randn((e, c, f), dtype, gen, 0.3)
        out[f"gmm_bwd_ms_{label}"] = ab.abba(
            lambda side: cs.cuda_ms(
                lambda: sides[side]["grouped_matmul"].grouped_matmul_bwd(
                    x, w, dy), 20),
            args.rounds)
        del x, w, dy

    for label, *case in train_cases() if args.steps > 0 else ():
        out[f"train_step_ms_{label}"] = train_step_ab(
            *case, sides, args.rounds, args.steps)

    print(json.dumps(out), flush=True)
    ab.print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
