"""Production dry-run: trace every (arch x shape x mesh) cell's step on
meta tensors, one rank of the production mesh, and count it per device.

The counterpart of the JAX package's ``launch/dryrun.py``. JAX forces 512
placeholder devices, lowers and compiles each cell's step and reads the
compiled module. The port has no compiler and no HLO: it starts a fake
process group of the mesh's size in this one process
(``launch.mesh.make_fake_mesh``), builds the cell's model, policy and step
exactly as a run on the cards would, places the step's arguments
(``launch.specs.input_specs``) as DTensors of meta tensors in their specs'
placements, and runs the step once under ``launch.op_analysis``: rank 0's
program, the dispatched torch ops and the hand-written kernels at their
own analytic counts (each kernel op reports its calls on meta and returns
empty outputs). It proves, without a card, that the distribution config is
coherent (a sharding mismatch, a shape error or a collective DTensor cannot
place fails here) and records per device:

  * FLOPs, memory bytes, collectives and kernel calls (``hlo_stats``, here
    ``op_analysis``'s stats), a train cell's microbatch loop traced for two
    microbatches, the second weighted by the rest (``op_analysis.trips``);
  * peak memory from a live-storage tracker (``memory_analysis``), against
    the card's 80 GB (``fits_device``);
  * the roofline on the H100's data-sheet rates (``launch.mesh``): compute,
    memory and collective seconds, the dominant term, the model's 6ND
    FLOPs and the share of the counted FLOPs they are.

Departures from JAX's, by design: nothing is compiled (``timings_s`` has
``build`` and ``trace``); a DTensor Shard-to-Shard redistribution is
counted as the one all-to-all a CUDA mesh issues, not the all-gather and
chunk that the fake group's ``cpu`` mesh would run; decode reads its
positions on the host (``model._write_index``), so ``pos`` is a host int32
tensor at ``seq_len - 1``, whose values choose only the slots written, not
the work. The roofline is a count, not a measurement; ``chip_smoke.py``'s
``dryrun`` phase holds the counts of small cells to runs on the card.

Usage (no card, no JAX; one process a cell):
  python -m repro_torch.launch.dryrun --arch yi-9b --shape prefill_32k --mesh single
  python -m repro_torch.launch.dryrun --all      # every runnable cell, both meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import SHAPES, all_cells, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis, specs

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "experiments" / "dryrun_torch"
SRC = Path(__file__).resolve().parents[2]

PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}

_MESH = {}


def fake_mesh(shape, axes):
    """This process's fake mesh: built at the first call, the same one
    after (one process group a process)."""
    key = (tuple(shape), tuple(axes))
    if not _MESH:
        _MESH[key] = mesh_lib.make_fake_mesh(shape, axes)
    if key not in _MESH:
        raise RuntimeError(f"this process already traces on the mesh "
                           f"{next(iter(_MESH))}; run {key} in another")
    return _MESH[key]


def build_step(cfg, shape, mesh, policy, parallel, model, aux,
               microbatch_budget=4e9):
    """(the step function of the shape's kind, extra result keys): the
    train step with ``pick_microbatches``' count (JAX's), ``model.prefill``
    to ``seq_len`` or ``model.decode``."""
    if shape.kind == "train":
        from repro_torch.optim.adamw import OptimizerConfig
        from repro_torch.training.train_step import (TrainStepConfig,
                                                     make_train_step,
                                                     pick_microbatches)
        dp = math.prod(mesh.size(list(mesh.mesh_dim_names).index(a))
                       for a in parallel.batch_axes)
        mb = pick_microbatches(cfg, shape, dp, microbatch_budget)
        opt_cfg = OptimizerConfig(
            moment_dtype=aux["moment_dtype"],
            grad_accum_dtype=("bfloat16" if (aux["moment_dtype"] != "float32"
                                             or aux.get("grad_bf16"))
                              else "float32"))
        step = make_train_step(model, cfg, opt_cfg,
                               TrainStepConfig(microbatches=mb))
        return step, {"microbatches": mb}
    if shape.kind == "prefill":
        def prefill(params, inputs):
            return model.prefill(params, inputs, shape.seq_len)
        return prefill, {}

    def decode(params, caches, inputs, pos):
        return model.decode(params, caches, inputs, pos)
    return decode, {}


def _apply_variant(cfg, variant: str):
    """Variant tokens (combine with '+'): fusedattn (the flash kernel's
    products as plain einsums, ``layers.attention_fused_proxy``), ssdproxy
    (idem for the SSD, ``mamba2.ssd_fused_proxy``), mb8/mb4/mbB6 (a larger
    microbatch residual budget: fewer microbatches), gradbf16 (bf16
    gradient accumulation), int8opt (int8 Adam moments), mesh64/mesh32 (a
    (4, 16) or (2, 16) mesh)."""
    tokens = set(variant.split("+")) if variant else set()
    overrides = {}
    if "fusedattn" in tokens:
        overrides["attn_impl"] = "fused_proxy"
    if "ssdproxy" in tokens:
        overrides["ssd_impl"] = "fused_proxy"
    cfg = dataclasses.replace(cfg, **overrides) if overrides else cfg
    knobs = {
        "microbatch_budget": 12e9 if "mb8" in tokens else
                             24e9 if "mb4" in tokens else
                             6e9 if "mbB6" in tokens else 4e9,
        "grad_bf16": "gradbf16" in tokens,
        "int8opt": "int8opt" in tokens,
        "mesh_override": (4, 16) if "mesh64" in tokens else
                         (2, 16) if "mesh32" in tokens else None,
    }
    return cfg, knobs


def _placed(tree, spec_tree, policy):
    """Meta tensors as DTensors of meta locals in their specs' placements
    (each rank's part only); a 0-dim leaf (a step count, an int8 scale)
    stays a plain meta tensor, as the optimizer keeps it."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import local_span
    from repro_torch.models.layers import contiguous_strides
    if isinstance(tree, dict):
        return {k: _placed(v, spec_tree[k], policy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placed(v, s, policy)
                          for v, s in zip(tree, spec_tree))
    if tree.ndim == 0:
        return torch.empty((), dtype=tree.dtype, device="meta")
    pl = policy.placements(spec_tree)
    shape = tuple(tree.shape)
    local = tuple(local_span(shape, policy.mesh, pl, d)[1]
                  for d in range(len(shape)))
    return DTensor.from_local(
        torch.empty(local, dtype=tree.dtype, device="meta"), policy.mesh, pl,
        shape=shape, stride=contiguous_strides(shape))


def place_args(shape, args, aux, policy):
    """``input_specs``' abstract arguments placed for the step: params,
    optimizer state and caches by their specs; a prefill or decode input
    (a (meta tensor, spec) pair) by its spec; a train batch whole, the
    same on every rank, as the port's train step takes it (it cuts the
    microbatches, then each rank's rows); decode's positions a host int32
    tensor at ``seq_len - 1``."""
    def pair(p):
        return _placed(p[0], p[1], policy)
    if shape.kind == "train":
        state, batch = args
        sh = aux["state_sh"]
        return ({"params": _placed(state["params"], sh["params"], policy),
                 "opt": _placed(state["opt"], sh["opt"], policy)},
                {k: v[0] for k, v in batch.items()})
    if shape.kind == "prefill":
        params, inputs = args
        return _placed(params, aux["params_sh"], policy), pair(inputs)
    params, caches, inputs, pos = args
    return (_placed(params, aux["params_sh"], policy),
            _placed(caches, aux["cache_sh"], policy), pair(inputs),
            torch.full(pos[0].shape, shape.seq_len - 1, dtype=torch.int32))


def roofline(stats, cfg, shape, chips: int) -> dict:
    """Compute, memory and collective seconds on the H100's rates, the
    dominant term and the model's FLOPs (6ND for train, 2ND else; N the
    active params) against the counted ones."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    per_token = 6.0 if shape.kind == "train" else 2.0
    model_global = per_token * cfg.active_param_count() * tokens
    model_dev = model_global / chips
    terms = {"compute_s": stats.compute_s,
             "memory_s": stats.hbm_bytes / mesh_lib.H100_BYTES_PER_S,
             "collective_s": (stats.coll_wire_bytes
                              / mesh_lib.H100_NVLINK_BYTES_PER_S)}
    dominant = max(terms, key=terms.get)
    slowest = terms[dominant]
    return {**terms, "dominant": dominant,
            "model_flops_global_6ND": model_global,
            "model_flops_per_device": model_dev,
            "flops_per_device": stats.flops,
            "useful_flops_ratio": (model_dev / stats.flops
                                   if stats.flops else None),
            "roofline_fraction": (model_dev / mesh_lib.H100_BF16_FLOPS
                                  / slowest if slowest else None)}


def prepare_cell(cfg, shape, mesh_shape, variant: str = "baseline",
                 microbatch_budget=None):
    """Everything a cell traces: (step, placed arguments, extra result
    keys, policy, mesh, cfg after the variant). ``microbatch_budget``
    stands in for the variant's."""
    from repro_torch.models.model import build_model
    cfg, knobs = _apply_variant(cfg, "" if variant == "baseline" else variant)
    if knobs["mesh_override"]:
        mesh_shape = (knobs["mesh_override"], ("data", "model"))
    mesh = fake_mesh(*mesh_shape)
    policy, parallel = specs.make_policy(cfg, shape, mesh)
    model = build_model(cfg, "cpu", mesh, parallel, policy)
    args, aux = specs.input_specs(cfg, shape, policy, model)
    if shape.kind == "train" and knobs["int8opt"]:
        opt, opt_sh = specs.abstract_opt_state(args[0]["params"],
                                               aux["axes"], policy, "int8")
        args = ({"params": args[0]["params"], "opt": opt}, args[1])
        aux["state_sh"] = {"params": aux["state_sh"]["params"],
                           "opt": opt_sh}
        aux["moment_dtype"] = "int8"
    if shape.kind == "train" and knobs["grad_bf16"]:
        aux["grad_bf16"] = True
    budget = microbatch_budget or knobs["microbatch_budget"]
    fn, extra = build_step(cfg, shape, mesh, policy, parallel, model, aux,
                           microbatch_budget=budget)
    return fn, place_args(shape, args, aux, policy), extra, policy, mesh, cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             variant: str = "baseline", cfg=None, shape=None,
             mesh_shape=None) -> dict:
    """One cell's result. ``cfg``, ``shape`` and ``mesh_shape`` (sizes and
    axis names) stand in for the named config, shape and production mesh
    (tests run reduced configs on small meshes)."""
    t0 = time.time()
    shape = shape or SHAPES[shape_name]
    fn, placed, extra, policy, mesh, cfg = prepare_cell(
        cfg or get_config(arch), shape, mesh_shape or PRODUCTION[mesh_kind],
        variant)
    t1 = time.time()
    _, stats = op_analysis.analyze_step(fn, *placed, weight_loops=True)
    t2 = time.time()
    chips = mesh.size()
    mem = stats.memory
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "variant": variant, "chips": chips,
        "attn_mode": policy.mode,
        "sharding_fallbacks": [list(map(str, f)) for f in policy.fallbacks],
        "timings_s": {"build": t1 - t0, "trace": t2 - t1},
        "memory_analysis": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "peak_bytes_per_device": mem["peak_bytes"],
            "fits_device": bool(mem["peak_bytes"] < mesh_lib.H100_HBM_BYTES),
        },
        "hlo_stats": stats.to_json(),
        "roofline": roofline(stats, cfg, shape, chips),
        **extra,
    }


def local_step(cfg, kind: str, batch: int, seq: int, device, seed: int = 0):
    """One unsharded step of ``kind`` ("prefill" or "train", token inputs)
    on ``device``, built as a cell's is: (step, args). On meta the params,
    state and token ids are meta tensors; elsewhere random params and ids
    from ``seed``. ``chip_smoke.py`` counts the same step on meta and on the
    card and holds the counts to each other."""
    from repro_torch.models.layers import MetaGenerator
    from repro_torch.models.model import build_model
    dev = torch.device(device)
    model = build_model(cfg, dev)
    meta = dev.type == "meta"
    gen = MetaGenerator() if meta else \
        torch.Generator(device=dev).manual_seed(seed)

    def tokens():
        if meta:
            return torch.empty((batch, seq), dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             dtype=torch.int32, device=dev)
    if kind == "prefill":
        def prefill(params, inputs):
            return model.prefill(params, inputs, seq)
        return prefill, (model.init(gen), tokens())
    if kind != "train":
        raise ValueError(f"local_step runs prefill or train, not {kind!r}")
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.training.train_step import (TrainStepConfig, init_state,
                                                 make_train_step)
    opt_cfg = OptimizerConfig()
    step = make_train_step(model, cfg, opt_cfg, TrainStepConfig())
    return step, (init_state(model, opt_cfg, gen),
                  {"inputs": tokens(), "labels": tokens()})


def _tag(arch, shape, mesh_kind, variant="baseline"):
    tag = f"{arch}__{shape}__{mesh_kind}"
    return tag if variant == "baseline" else f"{tag}__{variant}"


def run_all(out_dir: Path) -> list:
    """Every runnable cell on both production meshes, one subprocess each
    (a process holds one fake process group); a cell whose JSON is already
    written is skipped, a failed one leaves its output in ``<tag>.err``."""
    failures = []
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    for arch, shape in all_cells():
        for mesh_kind in ("single", "multi"):
            tag = _tag(arch, shape, mesh_kind)
            if (out_dir / f"{tag}.json").exists():
                print(f"[skip] {tag}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                   "--out", str(out_dir)]
            print(f"[run ] {tag}", flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True, env=env)
            if r.returncode != 0:
                failures.append(tag)
                (out_dir / f"{tag}.err").write_text(
                    r.stdout[-4000:] + "\n" + r.stderr[-8000:])
                print(f"[FAIL] {tag}", flush=True)
    return failures


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell x both meshes in "
                         "subprocesses")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        t0 = time.time()
        failures = run_all(out_dir)
        print(f"done in {time.time() - t0:.1f}s; {len(failures)} failures: "
              f"{failures}")
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape name a cell (or --all)")
    tag = _tag(args.arch, args.shape, args.mesh, args.variant)
    try:
        result = run_cell(args.arch, args.shape, args.mesh,
                          variant=args.variant)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=2))
    r, m = result["roofline"], result["memory_analysis"]
    print(f"[ok] {tag}: dominant={r['dominant']} "
          f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
          f"coll={r['collective_s']:.4f}s "
          f"peak={m['peak_bytes_per_device'] / 1e9:.2f}GB "
          f"fits={m['fits_device']} "
          f"(trace {result['timings_s']['trace']:.1f}s)")


if __name__ == "__main__":
    main()
