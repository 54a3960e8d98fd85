"""Elastic scaling / crash-restart on the PyTorch port: train, checkpoint
asynchronously, destroy the VRE ("node failure"), re-instantiate (warm
image cache), restore state, continue training — loss curve continues
where it left off. The counterpart of ``examples/elastic_restart.py``.

    PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]

Trains ``mamba2-370m`` at JAX's global batch 4 and sequence length 32: on
the card (provider ``h100``, the default) at full width and depth, on the
SSD forward and backward kernels (the 32 tokens padded to one 256-token
chunk); with ``--device cpu`` the reduced config on the host, as the JAX
example. Without a card and without ``--device cpu`` the VRE's pool check
raises.
"""
import argparse
import tempfile

import numpy as np

import repro_torch.core.services  # noqa: F401 — registers the services
from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card's pool (provider h100, full "
                         "widths); cpu: the host (reduced widths)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    provider = "cpu" if args.device == "cpu" else "h100"
    with tempfile.TemporaryDirectory() as workdir:
        cfg = VREConfig(name="elastic", mesh_shape=(1, 1),
                        services=["volumes", "data", "lm-trainer"],
                        arch="mamba2-370m", provider=provider,
                        workdir=workdir,
                        extra={"global_batch": 4, "seq_len": 32})

        vre = VirtualResearchEnvironment(cfg)
        vre.instantiate()
        trainer = vre.service("lm-trainer")
        losses1 = trainer.train_steps(vre.service("data"), 6)
        vre.service("volumes").save(trainer.state, step=6, blocking=True)
        print(f"phase 1: loss {losses1[0]:.3f} -> {losses1[-1]:.3f}; "
              f"checkpointed")

        del trainer
        vre.destroy()     # simulate preemption of the whole environment
        print("VRE destroyed (preempted)")

        vre2 = VirtualResearchEnvironment(cfg)
        rep = vre2.instantiate()
        print(f"re-instantiated in {rep.wall_s:.2f}s (warm cache)")
        try:
            t2 = vre2.service("lm-trainer")
            t2.state = vre2.service("volumes").restore(t2.state, step=6)
            losses2 = t2.train_steps(vre2.service("data"), 6)
            print(f"phase 2 (restored): loss {losses2[0]:.3f} -> "
                  f"{losses2[-1]:.3f}")
            assert np.isfinite(losses2[-1])
            assert losses2[0] < losses1[0] + 1.0, \
                "restore must continue, not restart"
        finally:
            vre2.destroy()
    print("OK")
    return {"provider": provider, "arch": cfg.arch, "losses1": losses1,
            "losses2": losses2, "reinstantiate_s": rep.wall_s}


if __name__ == "__main__":
    main()
