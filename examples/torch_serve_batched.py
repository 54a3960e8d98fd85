"""End-to-end serving on the PyTorch port: ten requests batched
through the edge router over two serving engines, one output held to the
sequential greedy oracle. The counterpart of ``examples/serve_batched.py``.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

With ``--device cpu``: the reduced ``gemma2-27b`` in its own dtype at
``max_seq`` 96, exactly as the JAX example (local/global layers; the
reduced window is 32, so the caches roll). On the card (the default):
gemma2-27b at full width in float32, cut in depth to ``--layers`` (8 of
46: local and global still alternate), at ``max_seq`` 4160, past the
4096-token window, so the caches roll as the JAX example intends; the
flash kernel runs every prefill (softcap 50, window 4096, head dim 128).
It serves in float32 because a padded batched prefill and the batch-1
oracle round differently, and in bfloat16 a near-tie can flip a token.
~23 GB of weights (2.27 GB a layer and a 4.72 GB embedding) and at most
3.2 GB of caches; both engines share one copy of the params. Without a
card and without ``--device cpu`` it raises.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving.engine import (EdgeRouter, ServingEngine,
                                        greedy_generate)

ARCH = "gemma2-27b"
CARD_LAYERS = 8
CARD_MAX_SEQ = 4160     # past the 4096-token window: the caches roll
CPU_MAX_SEQ = 96        # the JAX example's


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card); "
                         "cpu serves the reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help=f"the card's depth cut (full width, float32; "
                         f"default {CARD_LAYERS}); not with --device cpu")
    return ap.parse_args(argv)


def make_prompts(vocab_size: int) -> list:
    """The JAX example's ten prompts: 4 to 11 tokens each, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab_size, size=int(rng.integers(4, 12)))
            for _ in range(10)]


def serve(model, params, prompts, max_seq: int, device=None,
          max_new_tokens: int = 8):
    """``prompts`` through an ``EdgeRouter`` over two engines of 3 slots
    each sharing ``params``: (outputs, seconds, the router's metrics)."""
    engines = [ServingEngine(model, params, slots=3, max_seq=max_seq,
                             name=f"r{i}", device=device) for i in range(2)]
    router = EdgeRouter(engines)
    t0 = time.time()
    futs = [router.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    router.drain()
    outs = [f.result() for f in futs]
    return outs, time.time() - t0, router.metrics()


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(ARCH)
    if device.type == "cpu":
        if args.layers is not None:
            raise ValueError("--layers cuts the card's full-width model; "
                             "--device cpu serves the reduced config")
        cfg = reduced(cfg)          # local/global + rolling caches
        max_seq = CPU_MAX_SEQ
    else:
        cfg = dataclasses.replace(cfg, num_layers=args.layers or CARD_LAYERS,
                                  dtype="float32")
        max_seq = CARD_MAX_SEQ
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rolling = any(0 < s.window < max_seq for s in model.subs)
    print(f"{cfg.name}: {cfg.num_layers} layers, {cfg.dtype}, max_seq "
          f"{max_seq}, rolling caches: {rolling}")

    prompts = make_prompts(cfg.vocab_size)
    outs, dt, metrics = serve(model, params, prompts, max_seq, device)
    tokens = sum(map(len, outs))
    print(f"10 batched requests -> {tokens} tokens in {dt:.1f}s "
          f"({tokens / dt:.1f} tok/s)")

    # verify one against the sequential oracle
    ref = greedy_generate(model, params, prompts[0], 8, max_seq)
    assert np.array_equal(outs[0], ref), "batched decode must equal the oracle"
    print("continuous-batched output == sequential oracle; metrics:",
          metrics)
    return {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
            "max_seq": max_seq, "rolling": rolling, "tokens": tokens,
            "seconds": dt, "tok_per_s": tokens / dt,
            "outputs": [o.tolist() for o in outs],
            "oracle_equal_tokens": int((outs[0] == ref).sum()),
            "metrics": metrics}


if __name__ == "__main__":
    main()
