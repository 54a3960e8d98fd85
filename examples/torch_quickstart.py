"""Quickstart on the PyTorch port: the paper's Fig. 4 user interaction, as
a library session. The counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

init -> apply (instantiate an on-demand VRE) -> use its services
(train a few steps, run a tool workflow) -> destroy, then a second apply,
mirroring the paper's on-demand usage pattern. It prints the image cache's
hits, 0 as in the JAX example: no service of either package is built
through the cache.

With ``--device cpu`` the VRE runs on the host (provider ``cpu``) and
trains the reduced ``yi-9b``, exactly as the JAX example. On the card
(provider ``h100``, the default) it trains at full width and depth, and
the default arch departs from JAX's: a full yi-9b's train state does not
fit one 80 GB H100. Its 8.57e9 params take 12 bytes each in bf16 params
and gradients and f32 moments, ~103 GB before any activation (cut to 16
of its 48 layers, 3.03e9 params, it peaked at 42.30 GB in training on an
H100 80GB HBM3 at 700 W, ``chip_smoke.py``'s ``train_yi9b``). The card's
default is ``granite-moe-1b-a400m`` at full width and depth (1.33e9
params; the flash kernels at head dim 64, the grouped matmul forward, dx
and dw); ``--arch`` chooses another. Without a card and without
``--device cpu`` the VRE's pool check raises.
"""
import argparse
import tempfile
import time

import numpy as np

import repro_torch.core.services  # noqa: F401 — registers the services
from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment

CPU_ARCH = "yi-9b"                    # reduced on provider cpu, as in JAX
CARD_ARCH = "granite-moe-1b-a400m"    # full width and depth on the card


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card's pool (provider h100, full "
                         "widths); cpu: the host (reduced widths)")
    ap.add_argument("--arch", default=None,
                    help=f"the trainer's arch (default: {CARD_ARCH} on the "
                         f"card, {CPU_ARCH} on the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    provider = "cpu" if args.device == "cpu" else "h100"
    arch = args.arch or (CPU_ARCH if provider == "cpu" else CARD_ARCH)
    with tempfile.TemporaryDirectory() as workdir:
        cfg = VREConfig(
            name="quickstart",
            mesh_shape=(1, 1),
            services=["volumes", "data", "lm-trainer", "workflows",
                      "dashboard"],
            arch=arch, provider=provider, workdir=workdir,
            extra={"global_batch": 4, "seq_len": 32, "workers": 4},
        )

        # --- kn apply -------------------------------------------------
        vre = VirtualResearchEnvironment(cfg)
        report = vre.instantiate()
        try:
            print(f"[apply] VRE up in {report.wall_s:.2f}s "
                  f"({report.mode}, {report.nodes} nodes)")
            endpoints = list(vre.endpoints.entries().keys())
            print("[discovery]", endpoints)

            # --- use the trainer microservice -----------------------------
            trainer = vre.service("lm-trainer")
            losses = trainer.train_steps(vre.service("data"), 5)
            print(f"[train] {trainer.cfg.name}: 5 steps, loss "
                  f"{losses[0]:.3f} -> {losses[-1]:.3f}")
            vre.service("volumes").save(trainer.state, step=5, blocking=True)
            del trainer

            # --- a workflow of short-lived tools (paper §5.1 pattern) ------
            wfs = vre.service("workflows")
            wf = wfs.new("demo-analysis")
            wf.map_partitions("sumsq", lambda p: float((p ** 2).sum()),
                              np.arange(10_000, dtype=np.float64), 8,
                              reducer=sum)
            sumsq = wfs.run(wf)["sumsq:gather"]
            print(f"[workflow] sumsq over 8 partitions = {sumsq:.3e}")
            counters = list(vre.service("dashboard").summary()["counters"])
            print("[dashboard]", counters[:4])
        finally:
            vre.destroy()

        # --- destroy, then warm re-apply --------------------------------
        t0 = time.perf_counter()
        vre2 = VirtualResearchEnvironment(cfg)
        vre2.instantiate()
        reapply_s = time.perf_counter() - t0
        hits = vre2.image_cache.hits
        print(f"[re-apply] warm instantiation in {reapply_s:.2f}s "
              f"(image cache hits: {hits})")
        vre2.destroy()
    print("OK")
    return {"provider": provider, "arch": arch, "apply_s": report.wall_s,
            "endpoints": endpoints, "losses": losses, "sumsq": sumsq,
            "dashboard_counters": counters, "reapply_s": reapply_s,
            "image_cache_hits": hits}


if __name__ == "__main__":
    main()
