"""Bodies of the dry-run tests that need a fake process group, each run in
a process of its own (the group is global): ``python -m torch_dryrun_cells
<name>`` from ``tests/`` prints one JSON line. No JAX here."""
from __future__ import annotations

import dataclasses
import json
import sys

from repro_torch.configs.base import ShapeConfig, get_config, reduced

MINI_ARCHS = ("gemma2-27b", "granite-moe-1b-a400m", "mamba2-370m")
MINI_SHAPE = ShapeConfig("t", 64, 8, "train")
MINI_MESH = ((2, 2, 2), ("pod", "data", "model"))
# the flash backward kernel takes head dims 64, 128 and 256 on the card and
# ``reduced()`` sets 16; the meta path follows the card, so the mini cells
# train at head dim 64 (the JAX side of the test builds the same configs)
MINI_HEAD_DIM = 64


def mini_config(arch: str):
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, head_dim=MINI_HEAD_DIM) \
        if cfg.head_dim else cfg


def _counts(stats) -> dict:
    j = stats.to_json()
    return {"flops": j["flops"], "dot_flops": j["dot_flops"],
            "hbm_bytes": j["hbm_bytes"], "collectives": j["collectives"],
            "kernel_calls": j["kernels"]["calls"],
            "kernel_flops": j["kernels"]["flops"]}


def dtensor_product() -> dict:
    """One (64, 4096) x (4096, 4096) product of DTensors on a (16, 16) mesh,
    rows over data and columns over model, counted on two calls; and the
    product's left operand moved from its rows' shards to its columns'."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import make_fake_mesh
    mesh = make_fake_mesh((16, 16), ("data", "model"))
    a = DTensor.from_local(torch.empty(4, 4096, device="meta"), mesh,
                           [Shard(0), Replicate()], shape=(64, 4096),
                           stride=(4096, 1))
    w = DTensor.from_local(torch.empty(4096, 256, device="meta"), mesh,
                           [Replicate(), Shard(1)], shape=(4096, 4096),
                           stride=(4096, 1))
    flops = [op_analysis.analyze_step(lambda a, w: a @ w, a, w)[1].dot_flops
             for _ in range(2)]
    # Shard(0) -> Shard(1) over data: on this cpu mesh DTensor would
    # all-gather and chunk; counted as the CUDA mesh's one all-to-all
    moved = op_analysis.analyze_step(
        lambda a: a.redistribute(mesh, [Shard(1), Replicate()]), a)[1]
    return {"calls": flops, "shard_to_shard": moved.coll_per_op}


def mini() -> dict:
    """JAX's mini dry-run: the reduced archs' train step on (2, 2, 2)."""
    from repro_torch.launch import dryrun
    return {arch: dryrun.run_cell(arch, "t", "mini", cfg=mini_config(arch),
                                  shape=MINI_SHAPE, mesh_shape=MINI_MESH)
            for arch in MINI_ARCHS}


def on_1x4() -> dict:
    """On a (1, 4) mesh: a reduced yi-9b decode under a "head_dim" policy
    at 1 and 2 layers, the collectives of each; and granite's train step in
    as many microbatches as rows, two traced (the second weighted by the
    rest) and every microbatch traced."""
    from repro_torch.launch import dryrun, op_analysis
    mesh = ((1, 4), ("data", "model"))
    shape = ShapeConfig("d", 32, 2, "decode")
    out = {}
    for layers in (1, 2):
        cfg = dataclasses.replace(reduced(get_config("yi-9b")),
                                  num_layers=layers)
        r = dryrun.run_cell("yi-9b", "d", "1x4", cfg=cfg, shape=shape,
                            mesh_shape=mesh)
        out[f"decode_{layers}"] = {
            "attn_mode": r["attn_mode"],
            "collectives": r["hlo_stats"]["collectives"]}
    fn, placed, extra, *_ = dryrun.prepare_cell(
        mini_config("granite-moe-1b-a400m"), MINI_SHAPE, mesh,
        microbatch_budget=1.0)
    out["microbatches"] = extra["microbatches"]
    # a first step fills the process's caches (rope's frequencies, the
    # heads' maps), which neither counted step then refills
    op_analysis.analyze_step(fn, *placed)
    for w in (True, False):
        out["weighted" if w else "unweighted"] = _counts(
            op_analysis.analyze_step(fn, *placed, weight_loops=w)[1])
    return out


if __name__ == "__main__":
    print(json.dumps(globals()[sys.argv[1]]()))
