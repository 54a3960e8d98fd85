"""The paper's core scenario end-to-end on the PyTorch port: an on-demand
VRE running a multi-stage scientific pipeline (MTBLS233-style) with
data-split parallelization, a straggling node and a node failure — the
scheduler speculates and reschedules; the run completes with correct
results. The counterpart of ``examples/workflow_pipeline.py``.

    PYTHONPATH=src python examples/torch_workflow_pipeline.py [--device cpu]

The VRE is instantiated over the card's device pool (provider ``h100``),
or over the host with ``--device cpu``; without a card and without
``--device cpu`` the VRE's pool check raises. The tools stay numpy
functions on the host, as in the JAX example: the paper's tools are
short-lived CPU containers. No kernel runs here.
"""
import argparse
import tempfile
import time

import numpy as np

import repro_torch.core.services  # noqa: F401 — registers the services
from repro_torch.core.vre import VREConfig, VirtualResearchEnvironment


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card's pool (provider h100); cpu: the "
                         "host")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    provider = "cpu" if args.device == "cpu" else "h100"
    with tempfile.TemporaryDirectory() as workdir:
        cfg = VREConfig(name="pipeline", mesh_shape=(1, 1),
                        services=["volumes", "workflows", "dashboard"],
                        provider=provider, workdir=workdir,
                        extra={"workers": 6})
        vre = VirtualResearchEnvironment(cfg)
        vre.instantiate()
        try:
            wfs = vre.service("workflows")
            sched = wfs.scheduler

            data = np.arange(3000, dtype=np.float64)
            wf = wfs.new("mtbls233-like")
            g1 = wf.map_partitions("centroid", lambda p: p * 1.0001, data, 6)
            g2 = wf.add("align", lambda parts: np.concatenate(parts),
                        deps=[g1])
            g3 = wf.map_partitions(
                "match", lambda p: float(np.sqrt((p ** 2).mean())), data, 6,
                deps=[g2], reducer=lambda r: float(np.mean(r)))

            # inject faults: one straggler, one dead worker
            sched.make_straggler(1, speed=0.05)
            sched.kill_worker(2)

            t0 = time.time()
            res = wfs.run(wf)
            seconds = time.time() - t0
            print(f"pipeline done in {seconds:.2f}s; rms={res[g3]:.3f}")
            expected = float(np.mean([np.sqrt((p ** 2).mean())
                                      for p in np.array_split(data, 6)]))
            assert abs(res[g3] - expected) < 1e-9
            print("scheduler stats:", sched.stats)
            assert sched.stats["executed"] >= 14
        finally:
            vre.destroy()
    print("OK — failures rescheduled, stragglers mitigated, results exact")
    return {"provider": provider, "rms": res[g3], "expected": expected,
            "stats": dict(sched.stats), "seconds": seconds}


if __name__ == "__main__":
    main()
