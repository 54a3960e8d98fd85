"""Loss and train step with microbatched gradient accumulation, ported from
the JAX package's ``repro.training.train_step``.

The state keeps JAX's tree, ``{"params", "opt": {"m", "v", "count"[,
"m_scale", "v_scale"]}}``, so either package's ``CheckpointStore`` restores
the other's train state. Every family trains: dense, MoE, pure SSM
(``mamba2-370m``) and the hybrid (``zamba2-1.2b``); only the ``embeddings``
input mode raises (ROADMAP A.7c). A step differentiates the params with
each stacked leaf split into its layers (``model.split_blocks``: views of
the stacked storage; the transformer's super-blocks, the Mamba2 layers), so
each layer's gradient is its own tensor; the gradients are stacked back
into the params' layout for the optimizer, which updates the state in place
(JAX donates it).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import check_trainable
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_map


def cross_entropy(logits, labels, vocab_size: int, label_mask=None):
    """logits: (B, S, Vp) f32; labels: (B, S) int. Masks the padded vocab
    to -1e30; with ``label_mask`` the mean over the masked-in labels."""
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
    {"inputs": (B, S), "labels": (B, S)} on the model's device. B must be
    divisible by ``ts.microbatches``; with more than one, the gradients
    are summed in ``grad_accum_dtype``, each divided by the count, as JAX
    sums them. metrics: ``loss``, ``aux_loss``, ``grad_norm``, ``lr`` as
    0-dim tensors on the device. Padded-head archs get their padded q-head
    slices grad-masked (``model.grad_masks``; none on one card)."""
    check_trainable(cfg)
    loss_fn = make_loss_fn(model, cfg, ts)
    adt = getattr(torch, opt_cfg.grad_accum_dtype)

    def mask_grads(params, grads):
        masks = getattr(model, "grad_masks", lambda p: None)(params)
        if masks is None:
            return grads
        return tree_map(lambda g, m: g * torch.as_tensor(m, dtype=g.dtype),
                        grads, masks)

    def grad(params, inputs, labels):
        """(per-super-block grads in the split layout, loss, aux)."""
        split = _grad_leaves(model, params)
        flat = adamw.leaves(split)
        with torch.enable_grad():
            tot, (loss, aux) = loss_fn(split, inputs, labels)
            grads = torch.autograd.grad(tot, flat)
        it = iter(grads)
        del grads, flat
        return (tree_map(lambda _: next(it), split), loss.detach(),
                aux.detach())

    def accumulate(params, batch):
        n = ts.microbatches
        mbs = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
               for k, v in batch.items()}
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                               device=p.device), params)
        dev = adamw.leaves(params)[0].device
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n):
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
    """A fresh train state: ``model.init(gen)`` params and zero moments.
    (JAX also returns the params' logical axes; the port has none until
    the distributed slice, ROADMAP A.8.)"""
    params = model.init(gen)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def state_axes(params_axes):
    """Logical axes for the full train state given the params axes tree."""
    return {
        "params": params_axes,
        "opt": {"m": params_axes, "v": params_axes, "count": ()},
    }
