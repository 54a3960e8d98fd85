"""This checkout's SSD wrapper and kernels against those of another
checkout, alternated in one process on one card.

    python3 tools/ssd_ab.py --other DIR [--rounds 15]

DIR holds another checkout of the repo, for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``). Its ``src/repro_torch/kernels/ssd/ops.py`` is loaded beside
this checkout's (each builds its own ``csrc/ssd.cu``) and swapped in for
``ssd_chunked``'s call of ``ssd_intra_chunk``; everything else is this
checkout's code. Every reading is taken for both sides in the order this,
other, other, this, once a round:

* kernel ms, cold and warm L2, at mamba2-370m's 1024- and 256-token prefill
  shapes (``chip_smoke.py``'s ``cold_ms`` and ``cuda_ms``; 2 rounds);
* host µs to issue one wrapper call at the 1024-token shape (``host_us``);
* host ms of mamba2-370m's 1 x 1024 prefill to the end of its device work
  (``host_ms``), full depth and width, bf16, random weights from seed 0.

Prints one JSON line with every reading and each side's median, then the
card's name and power limit.
"""
from __future__ import annotations

import json
import sys

import torch

import ab  # puts the repo root and src/ on sys.path
import chip_smoke as cs  # the measurement helpers


def main() -> int:
    args = ab.parse_args(__doc__, 15)
    if args is None:
        return 1

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops
    from repro_torch.models.model import build_model

    path = args.other / "src" / "repro_torch" / "kernels" / "ssd" / "ops.py"
    other = ab.module("other_ssd_ops", path)
    wrappers = {"this": ops.ssd_intra_chunk, "other": other.ssd_intra_chunk}
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

    print(json.dumps(out), flush=True)
    ab.print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
