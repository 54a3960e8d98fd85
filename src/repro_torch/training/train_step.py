"""Loss and train step with microbatched gradient accumulation, ported from
the JAX package's ``repro.training.train_step``.

The state keeps JAX's tree, ``{"params", "opt": {"m", "v", "count"[,
"m_scale", "v_scale"]}}``, so either package's ``CheckpointStore`` restores
the other's train state. Every config trains: dense, MoE, pure SSM
(``mamba2-370m``), the hybrid (``zamba2-1.2b``) and the ``embeddings``
input mode (``musicgen-medium``, ``internvl2-26b``: a batch's inputs are
(B, S, d) float embeddings, which carry no gradient; the tied table gets
its gradient through the unembedding alone). A step differentiates the
params with each stacked leaf split into its layers
(``model.split_blocks``: views of the stacked storage; the transformer's
super-blocks, the Mamba2 layers), so each layer's gradient is its own
tensor; the gradients are stacked back into the params' layout for the
optimizer, which updates the state in place (JAX donates it).

A model built under a sharding policy (the dense and MoE transformers on a
``torch.distributed`` device mesh) trains the same step on DTensors: the
state in the policy's placements (``init_state``, ``distribute_state``),
the loss over vocab-sharded logits on each rank's shards
(``_sharded_cross_entropy``), each gradient reduced into its param's
placements, AdamW on the local shards.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import comm
from repro_torch.launch.op_analysis import trips
from repro_torch.models.layers import replicated_like
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_map


def cross_entropy(logits, labels, vocab_size: int, label_mask=None):
    """logits: (B, S, Vp) f32; labels: (B, S) int. Masks the padded vocab
    to -1e30; with ``label_mask`` the mean over the masked-in labels.
    Logits as a DTensor (a model under a sharding policy) take
    ``_sharded_cross_entropy``."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels, vocab_size, label_mask)
    vp = logits.shape[-1]
    if vp > vocab_size:
        pad_mask = torch.arange(vp, device=logits.device) < vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if label_mask is not None:
        label_mask = label_mask.to(nll.dtype)
        return torch.sum(nll * label_mask) / torch.clamp(label_mask.sum(),
                                                         min=1)
    return torch.mean(nll)


def _sharded_cross_entropy(logits, labels, vocab_size: int, label_mask=None):
    """``cross_entropy`` of DTensor logits, batch- and vocab-sharded, on
    each rank's local tensors: the log-sum-exp from each rank's part of
    the vocab (a max and a sum over the vocab's ranks), the label's logit
    from the rank that holds it, the mean over the global batch. Returns a
    replicated DTensor scalar. The logits are never gathered whole."""
    mesh = logits.device_mesh
    names = list(mesh.mesh_dim_names)
    local = logits.to_local()
    vloc = local.shape[-1]
    v0, vocab_groups, batch_groups = 0, [], []
    for i, p in enumerate(logits.placements):
        g = comm.axis_group(mesh, names[i])
        if p.is_shard() and p.dim == logits.ndim - 1:
            v0 += comm.group_rank(g) * vloc * math.prod(
                mesh.size(j) for j in range(i + 1, mesh.ndim)
                if logits.placements[j].is_shard()
                and logits.placements[j].dim == logits.ndim - 1)
            vocab_groups.append(g)
        elif p.is_shard() and p.dim == 0:
            batch_groups.append(g)
        elif p.is_shard() or p.is_partial():
            raise ValueError(f"logits placed {logits.placements}: want "
                             f"batch and vocab shards only")
    vid = v0 + torch.arange(vloc, device=local.device)
    if logits.shape[-1] > vocab_size:
        local = torch.where(vid < vocab_size, local, -1e30)
    m = local.detach().amax(-1, keepdim=True)
    for g in vocab_groups:
        m = comm.all_reduce(m.contiguous(), g, torch.distributed.ReduceOp.MAX)
    sumexp = torch.exp(local - m).sum(-1)
    rows = _local_rows(labels, logits, batch_groups)
    hit = (rows.long()[..., None] == vid)
    ll = torch.where(hit, local, 0.0).sum(-1)
    for g in vocab_groups:
        sumexp = comm.sum_over(sumexp, g)
        ll = comm.sum_over(ll, g)
    nll = torch.log(sumexp) + m[..., 0] - ll
    if label_mask is not None:
        mask = _local_rows(label_mask, logits, batch_groups).to(nll.dtype)
        num, den = torch.sum(nll * mask), mask.sum()
    else:
        num = torch.sum(nll)
        den = torch.tensor(float(nll.numel()), device=nll.device)
    for g in batch_groups:
        num = comm.sum_over(num, g)
        den = comm.all_reduce(den.clone(), g)
    loss = num / torch.clamp(den, min=1)
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim)


def _local_rows(x, logits, batch_groups):
    """This rank's batch rows of ``x`` (a full (B, S) tensor or a DTensor)
    as the logits' batch shards split them."""
    if isinstance(x, DTensor):
        return x.to_local()
    x = x.to(logits.device)
    mesh = logits.device_mesh
    for i, p in enumerate(logits.placements):
        if p.is_shard() and p.dim == 0:
            x = x.chunk(mesh.size(i), dim=0)[mesh.get_local_rank(i)]
    return x


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig, dp: int,
                      hbm_budget_bytes: float = 4e9) -> int:
    """Smallest power-of-two microbatch count whose per-device residual
    footprint (L x (B/mb/dp) x S x d x 2B) fits the budget."""
    if shape.kind != "train":
        return 1
    b_loc = max(shape.global_batch // dp, 1)
    per_mb = cfg.num_layers * shape.seq_len * cfg.d_model * 2
    if cfg.ssm is not None:
        # SSD dual-form working set: L/M decay matrices are
        # (nc, nh, c, c) f32 per layer = S*c*nh*4 bytes (x2 tensors),
        # alive during each layer's bwd recompute
        nh = cfg.ssm.num_heads(cfg.d_model)
        layers_live = cfg.num_layers if cfg.family == "hybrid" else 4
        per_mb += 2 * shape.seq_len * cfg.ssm.chunk_size * nh * 4 * layers_live
    mb = 1
    while mb < b_loc and b_loc // mb * per_mb > hbm_budget_bytes:
        mb *= 2
    return mb


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    aux_coef: float = 0.01


def make_loss_fn(model, cfg: ModelConfig, ts: TrainStepConfig):
    """loss_fn(params, inputs, labels) -> (loss + aux_coef * aux, (loss,
    aux))."""
    def loss_fn(params, inputs, labels):
        logits, aux = model.forward(params, inputs)
        loss = cross_entropy(logits, labels, cfg.vocab_size)
        return loss + ts.aux_coef * aux, (loss, aux)
    return loss_fn


def _like_param(g, leaf):
    """A DTensor gradient in its leaf's placements (the gradient reduced
    over the ranks where it is a partial sum)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(
            leaf.placements):
        return g.redistribute(leaf.device_mesh, leaf.placements)
    return g


def _plain(x):
    """A replicated DTensor scalar's value; a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _grad_leaves(model, params):
    """The tensors a step differentiates: ``model.split_blocks(params)``
    with every leaf detached (sharing the params' storage) and requiring
    grad."""
    split = model.split_blocks(params)
    return tree_map(lambda t: t.detach().requires_grad_(), split)


def _stacked(grads_split):
    """Per-layer gradients back in the params' layout: each split stacked
    leaf (the transformer's ``"blocks"``, per sub a list of super-blocks;
    the Mamba2 stack's ``"mamba"``, a list of layers) stacked on its layer
    axis, leaf by leaf, each layer's tensors dropped once their stack is
    made."""
    def stack(per_layer):
        if isinstance(per_layer[0], dict):
            return {k: stack([d.pop(k) for d in per_layer])
                    for k in list(per_layer[0])}
        out = torch.stack(per_layer)
        per_layer.clear()
        return out
    out = dict(grads_split)
    if "blocks" in out:
        out["blocks"] = [stack(layers) for layers in out["blocks"]]
    if "mamba" in out:
        out["mamba"] = stack(out["mamba"])
    return out


def make_train_step(model, cfg: ModelConfig, opt_cfg: adamw.OptimizerConfig,
                    ts: TrainStepConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": ..., "opt": ...}, updated in place; batch =
    {"inputs": (B, S) token ids or (B, S, d) embeddings, "labels": (B, S)}
    on the model's device. B must be
    divisible by ``ts.microbatches``; with more than one, the gradients
    are summed in ``grad_accum_dtype``, each divided by the count, as JAX
    sums them. metrics: ``loss``, ``aux_loss``, ``grad_norm``, ``lr`` as
    0-dim tensors on the device. Padded-head archs get their padded q-head
    slices grad-masked (``model.grad_masks``: a model under a policy in
    ``"expand"`` mode with padded heads).

    Under a sharding policy (``model.policy``) the state's params and
    moments are DTensors in the policy's placements (``init_state``,
    ``distribute_state``) and the batch is the full batch on every rank;
    each gradient is reduced into its param's placements, the optimizer
    updates each rank's local shards, and the metrics are the global
    ones."""
    loss_fn = make_loss_fn(model, cfg, ts)
    adt = getattr(torch, opt_cfg.grad_accum_dtype)

    def mask(g, m):
        if isinstance(m, float):
            return g if m == 1.0 else g * m
        return g * replicated_like(g, m.to(device=g.device, dtype=g.dtype))

    def mask_grads(params, grads):
        masks = getattr(model, "grad_masks", lambda p: None)(params)
        if masks is None:
            return grads
        return tree_map(mask, grads, masks)

    def grad(params, inputs, labels):
        """(per-super-block grads in the split layout, each in its leaf's
        placements under a policy, loss, aux)."""
        split = _grad_leaves(model, params)
        flat = adamw.leaves(split)
        with torch.enable_grad():
            tot, (loss, aux) = loss_fn(split, inputs, labels)
            # a param the loss does not reach gets zeros, as from jax.grad
            # (the dry-run's SSD proxy reads no dt)
            grads = torch.autograd.grad(tot, flat, allow_unused=True,
                                        materialize_grads=True)
        it = iter([_like_param(g, p) for g, p in zip(grads, flat)])
        del grads, flat
        return (tree_map(lambda _: next(it), split), _plain(loss.detach()),
                _plain(aux.detach()))

    def accumulate(params, batch):
        n = ts.microbatches
        mbs = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
               for k, v in batch.items()}
        g_acc = tree_map(lambda p: torch.zeros_like(
            p, dtype=adt, memory_format=torch.contiguous_format), params)
        dev = adamw.leaves(params)[0].device
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
        # a dry-run that weights loops traces two microbatches, the second
        # counted n - 1 times (``op_analysis.trips``)
        for i in trips(n):
            g, loss, aux = grad(params, mbs["inputs"][i], mbs["labels"][i])
            acc_split = model.split_blocks(g_acc)
            tree_map(lambda a, gi: a.add_(gi.to(adt) / n), acc_split, g)
            del g
            loss_acc = loss_acc + loss / n
            aux_acc = aux_acc + aux / n
        return g_acc, loss_acc, aux_acc

    def train_step(state, batch):
        params = state["params"]
        if ts.microbatches > 1:
            grads, loss, aux = accumulate(params, batch)
        else:
            g, loss, aux = grad(params, batch["inputs"], batch["labels"])
            grads = _stacked(g)
        grads = mask_grads(params, grads)
        new_params, new_opt, stats = adamw.update(
            grads, state["opt"], params, opt_cfg)
        metrics = {"loss": loss, "aux_loss": aux, **stats}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(model, opt_cfg: adamw.OptimizerConfig,
               gen: torch.Generator = None) -> dict:
    """A fresh train state: ``model.init(gen)`` params and zero moments;
    under a sharding policy (``model.policy``) the full params, the same
    on every rank, distributed into the policy's placements first. (JAX's
    also returns the params' logical axes: here ``model.axes()``, and
    ``state_axes(model.axes())`` the whole state's.)"""
    params = model.init(gen)
    if model.policy is not None:
        params = model.distribute(params)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def distribute_state(model, state) -> dict:
    """A full train state (the same on every rank, e.g. bridged from the
    JAX package) in ``model.policy``'s placements: params and moments by
    the params' axes; the step count and int8 scales stay as they are."""
    axes = state_axes(model.axes())
    opt_axes = {k: axes["opt"]["m"] if k in ("m", "v") else ()
                for k in state["opt"]}
    place = model.policy.distribute_tree
    return {"params": place(state["params"], axes["params"]),
            "opt": {k: (place(v, opt_axes[k]) if k in ("m", "v") else v)
                    for k, v in state["opt"].items()}}


def state_axes(params_axes):
    """Logical axes for the full train state given the params axes tree."""
    return {
        "params": params_axes,
        "opt": {"m": params_axes, "v": params_axes, "count": ()},
    }
