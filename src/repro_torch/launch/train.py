"""End-to-end training driver, ported from the JAX package's
``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --steps 20 \
        --reduced --global-batch 8 --seq-len 128 --device cpu

Trains every token-input arch: dense, MoE, the SSM (``--arch
mamba2-370m``) and the hybrid (``--arch zamba2-1.2b``); an ``embeddings``
input arch raises (ROADMAP A.7c). Builds the model on the card (``--device
cpu`` for the CPU), trains on the synthetic packed-LM stream, saves the train state asynchronously every
``--ckpt-every`` steps and blocks on the last save; ``--resume`` restores
the latest committed step and continues from it. The same arguments and
printed lines as the JAX driver, except that ``--ckpt-dir`` defaults to
``repro_ckpt`` under the temp directory (``tempfile.gettempdir()``, which
follows ``TMPDIR``) instead of JAX's fixed ``/tmp/repro_ckpt``, so that two
checkouts with their own ``TMPDIR`` never resume from each other's state.
Where the last step was just saved asynchronously, the final save waits
for that one instead of writing the same step again.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core.monitoring import Monitor
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, device_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                             make_train_step)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b",
                    help="a token-input config: dense, MoE, SSM "
                         "(mamba2-370m) or hybrid (zamba2-1.2b)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving reduced config (CPU)")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, monitor: Monitor = None):
    """The training run of ``args``: (losses, the final train state).
    ``monitor`` (default: a new one) times each step to the end of its
    device work (``train/step``), not the checkpoint saves."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    device = resolve_device(args.device)
    monitor = monitor or Monitor(name="train")
    model = build_model(cfg, device=device)
    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=5,
                              total_steps=max(args.steps, 10))
    step_fn = make_train_step(model, cfg, opt_cfg, TrainStepConfig(
        microbatches=args.microbatches))

    state = init_state(model, opt_cfg,
                       torch.Generator(device=device).manual_seed(0))
    store = CheckpointStore(args.ckpt_dir)
    start_step = 0
    if args.resume and store.latest_step() is not None:
        state = store.restore(state)
        start_step = store.latest_step()
        print(f"[resume] restored step {start_step}")

    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch,
        embeddings_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0))

    t0 = time.time()
    losses = []
    saved = None
    end = start_step + args.steps
    for step in range(start_step, end):
        batch = device_batch(data.batch(step), device)
        with monitor.timer("train", "step", step=step):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])      # waits for the device
        losses.append(loss)
        if step % 5 == 0 or step == end - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if (step + 1) % args.ckpt_every == 0:
            store.save(state, step + 1)            # async
            saved = step + 1
    store.wait()
    if saved != end:
        store.save(state, end, blocking=True)
    dt = time.time() - t0
    tok = args.steps * args.global_batch * args.seq_len
    print(f"done: {args.steps} steps, {tok/dt:,.0f} tok/s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert np.isfinite(losses[-1])
    return losses, state


def main(argv=None):
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
