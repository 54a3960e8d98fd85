"""GPipe-style pipeline parallelism over a mesh axis (the ``pod`` axis of
the multi-pod mesh), ported from the JAX package's
``repro.distributed.pipeline``.

The multi-pod mesh (pod=2, data=16, model=16) can map the pod axis to
pipeline stages instead of data parallelism: each pod holds its share of
the layer stack, and microbatches stream through the stages point to point
(activations (mb, S, d) cross the slow inter-pod links instead of a whole
gradient all-reduce). The classic GPipe schedule: n_micro + n_stages - 1
ticks; bubble fraction (n_stages - 1) / (n_micro + n_stages - 1).

JAX's ``shard_map`` over the pipeline axis becomes code on each rank's
local tensors: every tick each stage sends its output to the next stage
and takes the previous stage's from it (a ring, as JAX's ``ppermute``),
and at the end the last stage's outputs go to every stage. Forward only.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import comm
from repro_torch.optim.adamw import tree_map


def _stage_slice(p, stage: int):
    """This stage's slice of a leaf whose leading dim is the stage count:
    a DTensor sharded on that dim over the pipeline axis gives its local
    shard; a full tensor, its ``stage`` row."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        local = p.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"stage params placed {p.placements}: want "
                             f"their leading dim sharded over the "
                             f"pipeline axis")
        return local[0]
    return p[stage]


@torch.no_grad()
def pipeline_forward(mesh, pp_axis: str, body: Callable, stage_params,
                     x_micro, *, layers_per_stage: int):
    """Run microbatches through the pipeline stages of ``mesh``'s
    ``pp_axis``.

    body(params_slice, h) -> h : applies ONE stage's layer block
    stage_params: tree whose leaves have leading dim n_stages (DTensors
                  sharded on it over ``pp_axis``, or full tensors)
    x_micro: (n_micro, mb, S, d) microbatched activations, the same on
             every stage (only stage 0's input matters)
    Returns (n_micro, mb, S, d): the last stage's outputs, on every stage.
    ``layers_per_stage`` is the body's own business (kept for JAX's
    signature).
    """
    group = comm.axis_group(mesh, pp_axis)
    n_stages = comm.group_size(group)
    stage = comm.group_rank(group)
    n_micro = x_micro.shape[0]
    params = tree_map(lambda p: _stage_slice(p, stage), stage_params)
    carry = torch.zeros_like(x_micro[0])
    outputs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        # stage 0 takes microbatch t (while there is one), the others
        # their carry
        h_in = x_micro[min(t, n_micro - 1)] if stage == 0 else carry
        valid = 0 <= t - stage < n_micro
        h_out = body(params, h_in) if valid else h_in
        if stage == n_stages - 1 and valid:
            outputs[t - (n_stages - 1)] = h_out
        if n_stages > 1:
            # shift the activations one stage on (a ring, as JAX's ppermute)
            carry = comm.send_recv(h_out, (stage + 1) % n_stages,
                                   (stage - 1) % n_stages, group)
    return comm.broadcast(outputs, n_stages - 1, group)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
