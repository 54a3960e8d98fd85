"""Mamba2 (SSD, state-space duality) block, ported from the JAX package's
``repro.models.mamba2``: the training path (``mamba_block``) and the
prefill path on the chunked SSD op (the CUDA intra-chunk kernels on the
card, forward and backward), the O(1)-state decode path, and the
sequential-scan oracle of the tests.

Shapes follow the JAX package: d_inner = expand * d_model, SSM heads =
d_inner / head_dim, one B/C group shared by every head. Params keep its
layouts and dtypes: ``A_log``, ``D`` and ``dt_bias`` are f32 in any model
dtype, and ``dt`` is f32 from the projection on.

Under a sharding policy (params and activations DTensors) the params
shard as JAX's: ``w_z``, ``w_x``,
``conv_x``, ``norm`` and ``out_proj`` over ``d_inner``, ``w_dt``,
``A_log``, ``D`` and ``dt_bias`` over ``ssm_heads`` (both on ``model``),
``w_B``, ``w_C``, ``conv_B`` and ``conv_C`` replicated. The block runs as
one local region on each rank's channels and SSM heads, B and C whole: the
projections, convs, the SSD op (its kernels forward and backward) and
decode's state update on local tensors, with the collectives of
``_Ranks``: the gated norm over the whole ``d_inner`` sums its squares
over the ranks (GSPMD's all-reduce in JAX), ``out_proj``'s partial sums
are all-reduced, and the inputs every rank shares take their gradients'
sums.

``ssd_fused_proxy`` is JAX's dry-run lowering proxy: the chunked SSD's
products without its decay chains, taken by ``mamba_block`` where
``cfg.ssd_impl == "fused_proxy"`` (the dry-run's ``ssdproxy`` variant), as
JAX's is. It is not a numerical SSD.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import comm
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models.layers import (contiguous_strides, dense_init,
                                       rms_norm_from)

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def mamba_init(gen, cfg, dtype, stack: int):
    """One Mamba2 block's params, stacked on a leading ``stack`` axis."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    ds = s.d_state
    dev = gen.device

    def const(row):          # the same f32 row for every layer
        return row.to(device=dev).expand(stack, -1).contiguous()

    return {
        "w_z": dense_init(gen, (d, di), dtype, stack=stack),
        "w_x": dense_init(gen, (d, di), dtype, stack=stack),
        "w_B": dense_init(gen, (d, ds), dtype, stack=stack),
        "w_C": dense_init(gen, (d, ds), dtype, stack=stack),
        "w_dt": dense_init(gen, (d, nh), dtype, stack=stack),
        "conv_x": dense_init(gen, (s.conv_width, di), dtype, scale=0.5,
                             stack=stack),
        "conv_B": dense_init(gen, (s.conv_width, ds), dtype, scale=0.5,
                             stack=stack),
        "conv_C": dense_init(gen, (s.conv_width, ds), dtype, scale=0.5,
                             stack=stack),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh))),
        "D": const(torch.ones(nh)),
        "dt_bias": const(torch.zeros(nh)),
        "norm": torch.zeros((stack, di), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype, stack=stack),
    }


def mamba_axes() -> dict:
    """Logical axes of ``mamba_init``'s params (unstacked), as JAX's."""
    return {"w_z": ("embed", "d_inner"), "w_x": ("embed", "d_inner"),
            "w_B": ("embed", "ssm_state"), "w_C": ("embed", "ssm_state"),
            "w_dt": ("embed", "ssm_heads"),
            "conv_x": ("conv", "d_inner"), "conv_B": ("conv", "ssm_state"),
            "conv_C": ("conv", "ssm_state"),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "dt_bias": ("ssm_heads",),
            "norm": ("d_inner",), "out_proj": ("d_inner", "embed")}


# ---------------------------------------------------------------------------
# Depthwise causal conv
# ---------------------------------------------------------------------------


def causal_conv(x, w):
    """x: (B, S, C); w: (W, C): depthwise causal conv + silu, as W shifted
    multiply-adds in x's dtype."""
    s = x.shape[1]
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for k in range(width):
        out = out + xp[:, k:k + s, :] * w[k].to(x.dtype)
    return F.silu(out)


def conv_step(conv_state, x_t, w):
    """Single-token conv. conv_state: (B, W-1, C); x_t: (B, C). Returns (the
    new state, the silu'd output)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)     # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float()).to(x_t.dtype)
    return window[:, 1:], F.silu(out)


# ---------------------------------------------------------------------------
# SSD cores
# ---------------------------------------------------------------------------


def ssd_ref(x, dt, A, B, C, initial_state=None):
    """Sequential oracle. x: (b,s,nh,hd); dt: (b,s,nh); A: (nh,) (negative);
    B, C: (b,s,ds). Returns (y, final_state (b,nh,hd,ds))."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    state = initial_state if initial_state is not None else torch.zeros(
        (b, nh, hd, ds), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state, y = _ssd_update(state, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


def _ssd_update(state, x_t, dt_t, A, B_t, C_t):
    da = torch.exp(dt_t * A)                                   # (b,nh)
    upd = torch.einsum("bnh,bs,bn->bnhs", x_t.float(), B_t.float(), dt_t)
    state = state * da[..., None, None] + upd
    y = torch.einsum("bnhs,bs->bnh", state, C_t.float())
    return state, y


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Decode. state: (b,nh,hd,ds) f32; x_t: (b,nh,hd); dt_t: (b,nh);
    B_t/C_t: (b,ds). Returns (state, y (b,nh,hd))."""
    state, y = _ssd_update(state, x_t, dt_t, A, B_t, C_t)
    return state, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


def ssd_fused_proxy(x, dt, A, B, C, chunk: int):
    """DRY-RUN lowering proxy (JAX's ``ssd_fused_proxy``, see
    ``ModelConfig.ssd_impl``): the chunked SSD's products with the same
    dimensions and FLOPs, without the decay and segment-sum chains, all in
    x's dtype. Not a numerical SSD: ``dt`` and ``A`` are not read, and the
    chunks' states decay by 0.9. x: (b, s, nh, hd), s a multiple of
    ``chunk``; B/C: (b, s, ds). Returns (y (b, s, nh, hd), final state
    (b, nh, hd, ds) f32)."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, nh, hd)
    Bc = B.reshape(b, nc, chunk, ds)
    Cc = C.reshape(b, nc, chunk, ds)
    scores = torch.einsum("bncs,bnks->bnck", Cc, Bc)
    y_intra = torch.einsum("bnck,bnkhp->bnchp", scores, xc)
    s_loc = torch.einsum("bncs,bnchp->bnhps", Bc, xc)
    decay = torch.tensor(0.9, dtype=x.dtype, device=x.device)
    state = torch.zeros((b, nh, hd, ds), dtype=x.dtype, device=x.device)
    prev = []
    for n in range(nc):
        prev.append(state)
        state = state * decay + s_loc[:, n]
    s_prev = torch.stack(prev)                           # (nc, b, nh, hd, ds)
    y_inter = torch.einsum("bncs,nbhps->bnchp", Cc, s_prev)
    return (y_intra + y_inter).reshape(b, s, nh, hd), state.float()


class _Whole:
    """The collectives of an unsharded block: none."""
    @staticmethod
    def enter(t):
        return t

    total = out = enter


_WHOLE = _Whole()


class _Ranks:
    """The collectives of a block whose ``d_inner`` and SSM heads the ranks
    of ``group`` (the ``model`` axis) shard in contiguous blocks, each rank
    computing its own channels and heads on local tensors:

      enter(t)   t is the same on every rank and each uses it for its own
                 channels (h into z's, x's and dt's projections; B and C
                 into the SSD): identity, its gradient all-reduced
      total(ss)  the gated norm's sums of squares over every rank's
                 channels: all-reduced, and so is its gradient (each rank's
                 block adds its own part of it)
      out(t)     ``out_proj``'s partial sums: all-reduced, the gradient as
                 it is (the residual stream is the same on every rank)

    Forward, one small all-reduce and one of (B, S, d) a layer; backward,
    one of (B, S, d), two of (B, S, d_state) and a small one."""
    def __init__(self, group):
        self.group = group

    def enter(self, t):
        return comm.enter(t, self.group)

    def total(self, ss):
        return comm.enter(comm.sum_over(ss, self.group), self.group)

    def out(self, t):
        return comm.sum_over(t, self.group)


def _proj(p, h, r):
    he = r.enter(h)
    z = he @ p["w_z"]
    x = he @ p["w_x"]
    B = h @ p["w_B"]
    C = h @ p["w_C"]
    dt = (he @ p["w_dt"]).float()
    return z, x, B, C, dt


def _out(p, cfg, y, x, z, r):
    """D skip, gate, norm over the whole ``d_inner`` and out projection.
    y, x: (..., nh, hd)."""
    y = y + x * p["D"][:, None].to(y.dtype)
    y = y.reshape(*y.shape[:-2], -1)
    g = y * F.silu(z)
    ss = torch.sum(torch.square(g.float()), dim=-1, keepdim=True)
    var = r.total(ss) / cfg.ssm.d_inner(cfg.d_model)
    return r.out(rms_norm_from(g, p["norm"], var, cfg.norm_eps)
                 @ p["out_proj"])


def _run(p, cfg, h, r, states: bool):
    """The full-sequence block on (local) tensors: (out, the prefill cache
    when ``states``, else None)."""
    s_cfg = cfg.ssm
    hd = s_cfg.head_dim
    b, s, _ = h.shape
    z, x, B, C, dt = _proj(p, h, r)
    cache = None
    if states:
        w = s_cfg.conv_width
        cache = {"conv": {"x": _conv_state(x, w), "B": _conv_state(B, w),
                          "C": _conv_state(C, w)}}
    x = causal_conv(x, p["conv_x"])
    B = r.enter(causal_conv(B, p["conv_B"]))
    C = r.enter(causal_conv(C, p["conv_C"]))
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, s, -1, hd)
    if not states and cfg.ssd_impl == "fused_proxy" and \
            s % s_cfg.chunk_size == 0:
        y, final = ssd_fused_proxy(xh, dt, A, B, C, s_cfg.chunk_size)
    else:
        y, final = ssd_chunked(xh, dt, A, B, C, s_cfg.chunk_size)
    if states:
        cache["ssd"] = final
    return _out(p, cfg, y, xh, z, r), cache


def _step(p, cfg, h_t, cache, r):
    """One decode step on (local) tensors: (out (B, 1, d), the new
    cache)."""
    b = h_t.shape[0]
    z, x, B, C, dt = (v[:, 0] for v in _proj(p, h_t, r))
    conv = cache["conv"]
    cs_x, x = conv_step(conv["x"], x, p["conv_x"])
    cs_B, B = conv_step(conv["B"], B, p["conv_B"])
    cs_C, C = conv_step(conv["C"], C, p["conv_C"])
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, -1, cfg.ssm.head_dim)
    state, y = ssd_step(cache["ssd"], xh, dt, A, B, C)
    out = _out(p, cfg, y, xh, z, r)
    return out[:, None, :], {"conv": {"x": cs_x, "B": cs_B, "C": cs_C},
                             "ssd": state}


def _local(p, cfg, policy):
    """(this rank's params, gathered whole over the FSDP axes, and the
    block's ``_Ranks`` over the ``model`` axis). The block's channels and
    heads must shard alike."""
    par = policy.parallel
    lp = {k: comm.local_whole(w, par) for k, w in p.items()}
    if lp["w_x"].shape[-1] != lp["A_log"].shape[-1] * cfg.ssm.head_dim:
        raise ValueError(f"{cfg.name}: d_inner and the SSM heads shard "
                         f"differently over {par.tp_axis!r}")
    group = comm.axis_group(policy.mesh, par.tp_axis) if par.tp_axis \
        else None
    return lp, _Ranks(group)


def _like(t, h):
    """A local output as a DTensor placed as h (all-reduced over
    ``model``)."""
    return DTensor.from_local(t, h.device_mesh, h.placements, shape=h.shape,
                              stride=contiguous_strides(h.shape))


def _placed_cache(cache, cfg, policy, batch: int):
    """Each rank's cache parts as DTensors in the policy's placements for
    ``mamba_cache_axes()``."""
    s = cfg.ssm
    di, w = s.d_inner(cfg.d_model), s.conv_width - 1
    shapes = {"conv": {"x": (batch, w, di), "B": (batch, w, s.d_state),
                       "C": (batch, w, s.d_state)},
              "ssd": (batch, s.num_heads(cfg.d_model), s.head_dim,
                      s.d_state)}

    def place(t, shape, axes):
        return DTensor.from_local(
            t.contiguous(), policy.mesh, policy.placements_for(shape, axes),
            shape=shape, stride=contiguous_strides(shape))
    ax = mamba_cache_axes()
    return {"conv": {k: place(cache["conv"][k], shapes["conv"][k],
                              ax["conv"][k]) for k in ("x", "B", "C")},
            "ssd": place(cache["ssd"], shapes["ssd"], ax["ssd"])}


def mamba_block(p, cfg, h, policy=None):
    """Full-sequence Mamba2 block, the training path. h: (B, S, d) ->
    (B, S, d), differentiable (on the card through the SSD op's forward and
    backward kernels). With a ``policy``, p and h are DTensors and the
    block runs on each rank's local channels and SSM heads (``_Ranks``).

    Every length runs the chunked SSD op, a tail short of a chunk padded
    with dt = 0 inside it; the JAX package runs its sequential scan
    instead when S is not a chunk multiple, with the same values and
    gradients. ``cfg.ssd_impl == "fused_proxy"`` takes ``ssd_fused_proxy``
    where S is a chunk multiple (JAX's dispatch)."""
    if policy is None:
        return _run(p, cfg, h, _WHOLE, states=False)[0]
    lp, r = _local(p, cfg, policy)
    return _like(_run(lp, cfg, h.to_local(), r, states=False)[0], h)


def _conv_state(v, width: int):
    """The last ``width - 1`` rows of v (B, S, C) before the conv, with
    zeros in front of a prompt shorter than that (the conv's own padding)."""
    return F.pad(v, (0, 0, max(0, width - 1 - v.shape[1]), 0))[
        :, -(width - 1):]


def mamba_prefill(p, cfg, h, policy=None):
    """h: (B, S, d) -> (out (B, S, d), {"conv": {"x", "B", "C"}, "ssd"}).
    With a ``policy``, on each rank's channels and heads as
    ``mamba_block``; the cache as DTensors, the conv state's x by its
    ``d_inner`` shards and the SSD state by its heads.

    Every length runs the chunked SSD op: a tail short of a chunk is padded
    with dt = 0 inside it (the JAX package runs its sequential scan
    instead when S is not a chunk multiple)."""
    if policy is None:
        return _run(p, cfg, h, _WHOLE, states=True)
    lp, r = _local(p, cfg, policy)
    out, cache = _run(lp, cfg, h.to_local(), r, states=True)
    return _like(out, h), _placed_cache(cache, cfg, policy, h.shape[0])


def mamba_decode(p, cfg, h_t, cache, policy=None):
    """Single-token decode. h_t: (B, 1, d); cache: {"conv": {...}, "ssd"}.
    Returns (out (B, 1, d), the new cache). With a ``policy``, on each
    rank's channels and heads as ``mamba_block`` (the cache DTensors)."""
    if policy is None:
        return _step(p, cfg, h_t, cache, _WHOLE)
    lp, r = _local(p, cfg, policy)
    local = {"conv": {k: v.to_local() for k, v in cache["conv"].items()},
             "ssd": cache["ssd"].to_local()}
    out, new = _step(lp, cfg, h_t.to_local(), local, r)
    return _like(out, h_t), _placed_cache(new, cfg, policy, h_t.shape[0])


def mamba_cache_axes() -> dict:
    """Logical axes of ``init_mamba_cache``'s caches (unstacked), as
    JAX's."""
    return {"conv": {"x": ("batch", "conv", "d_inner"),
                     "B": ("batch", "conv", "ssm_state"),
                     "C": ("batch", "conv", "ssm_state")},
            "ssd": ("batch", "ssm_heads", "head_dim_ssm", "ssm_state")}


def init_mamba_cache(cfg, batch: int, dtype, device, stack: int):
    """Zeroed caches stacked on a leading ``stack`` (layer) axis: conv
    windows in the model dtype, the SSD state in f32."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    w = s.conv_width

    def zeros(*shape, dt=dtype):
        return torch.zeros((stack, batch, *shape), dtype=dt, device=device)

    return {"conv": {"x": zeros(w - 1, di), "B": zeros(w - 1, s.d_state),
                     "C": zeros(w - 1, s.d_state)},
            "ssd": zeros(nh, s.head_dim, s.d_state, dt=torch.float32)}
