"""End-to-end training example on the PyTorch port. The counterpart
of ``examples/train_e2e.py``.

    PYTHONPATH=src python examples/torch_train_e2e.py [--full] [train flags]

On the card (the default) it trains the JAX example's intended ``--full``
config: yi-9b's family at 12 layers, d_model 768, 12 heads of 64 (no GQA),
d_ff 3072 and a 32,000-token vocabulary with tied embeddings, 137,841,408
params (JAX's docstring says "~110M"), for 300 steps of 8 x 512 tokens in 2
microbatches, saved every 10 steps. The flash kernels run forward and
backward at (4, 512, 12, 12, 64) in bfloat16 a microbatch.

With ``--device cpu`` it runs the JAX example's default, its CPU demo:
``launch.train --arch yi-9b --reduced --steps 30 --global-batch 8 --seq-len
64 --ckpt-every 10``. That demo does not run on the card: the reduced head
dim of 16 is one the card's flash backward kernel does not take. ``--full``
chooses the full config on the CPU too. Without a card and without
``--device cpu`` it raises.

It departs from the JAX example in how it hands the config over. The JAX
example patches ``repro.configs.base.get_config``, but
``repro.launch.train`` imported ``get_config`` by name, so its lookup of
the transient arch imports ``repro.configs.None`` and raises
``ModuleNotFoundError``: JAX's ``--full`` never trains. Here the config is
passed to ``repro_torch.launch.train.run`` as its ``cfg``.

Flags after the example's own pass through to ``launch.train`` and override
the mode's (``--device cpu``, ``--steps 1``, ``--ckpt-dir DIR``, ...).
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.core.monitoring import Monitor
from repro_torch.device import resolve_device
from repro_torch.launch import train
from repro_torch.optim.adamw import leaves

FULL_ARCH = "train-e2e-110m"     # the JAX example's transient arch name
FULL_ARGV = ["--arch", FULL_ARCH, "--steps", "300", "--global-batch", "8",
             "--seq-len", "512", "--microbatches", "2"]
CPU_ARGV = ["--arch", "yi-9b", "--reduced", "--steps", "30",
            "--global-batch", "8", "--seq-len", "64", "--ckpt-every", "10"]


def full_config():
    """The JAX example's ``--full`` config: GPT-small scale in yi-9b's
    family."""
    return dataclasses.replace(
        get_config("yi-9b"), num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=32000,
        skip_shapes=())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the 137.8M-param config, 300 steps of 8 x 512 "
                         "(the default on the card)")
    ours, rest = ap.parse_known_args(argv)
    full = ours.full or \
        resolve_device(train.parse_args(rest).device).type != "cpu"
    args = train.parse_args((FULL_ARGV if full else CPU_ARGV) + rest)
    monitor = Monitor(name="train")
    cfg = None
    if full:
        cfg = full_config()
        print(f"full config: {cfg.param_count() / 1e6:.1f}M params")
    losses, state = train.run(args, monitor=monitor, cfg=cfg)
    step_s = [e["seconds"] for e in monitor.events("train")
              if e["event"] == "step.done"]
    return {"mode": "full" if full else "cpu demo", "arch": args.arch,
            "params": sum(t.numel() for t in leaves(state["params"])),
            "steps": args.steps, "global_batch": args.global_batch,
            "seq_len": args.seq_len, "microbatches": args.microbatches,
            "device": str(resolve_device(args.device)),
            "ckpt_dir": args.ckpt_dir, "losses": losses, "step_s": step_s}


if __name__ == "__main__":
    main()
