"""Mamba2 (SSD, state-space duality) block, ported from the JAX package's
``repro.models.mamba2``: the training path (``mamba_block``) and the
prefill path on the chunked SSD op (the CUDA intra-chunk kernels on the
card, forward and backward), the O(1)-state decode path, and the
sequential-scan oracle of the tests.

Shapes follow the JAX package: d_inner = expand * d_model, SSM heads =
d_inner / head_dim, one B/C group shared by every head. Params keep its
layouts and dtypes: ``A_log``, ``D`` and ``dt_bias`` are f32 in any model
dtype, and ``dt`` is f32 from the projection on.

Not ported: ``ssd_fused_proxy``, a dry-run lowering, which comes with the
dry-run tools (ROADMAP A.8); ``mamba_block`` raises on a config that asks
for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models.layers import dense_init, rms_norm

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


def _proj(p, h):
    z = h @ p["w_z"]
    x = h @ p["w_x"]
    B = h @ p["w_B"]
    C = h @ p["w_C"]
    dt = (h @ p["w_dt"]).float()
    return z, x, B, C, dt


def _out(p, cfg, y, x, z):
    """D skip, gate, norm and out projection. y, x: (..., nh, hd)."""
    y = y + x * p["D"][:, None].to(y.dtype)
    y = y.reshape(*y.shape[:-2], -1)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba_block(p, cfg, h):
    """Full-sequence Mamba2 block, the training path. h: (B, S, d) ->
    (B, S, d), differentiable (on the card through the SSD op's forward and
    backward kernels).

    Every length runs the chunked SSD op, a tail short of a chunk padded
    with dt = 0 inside it; the JAX package runs its sequential scan
    instead when S is not a chunk multiple, with the same values and
    gradients."""
    if cfg.ssd_impl == "fused_proxy":
        raise ValueError(f"{cfg.name}: ssd_impl 'fused_proxy' is a dry-run "
                         f"lowering, not ported (ROADMAP A.8)")
    s_cfg = cfg.ssm
    nh, hd = s_cfg.num_heads(cfg.d_model), s_cfg.head_dim
    b, s, _ = h.shape
    z, x, B, C, dt = _proj(p, h)
    x = causal_conv(x, p["conv_x"])
    B = causal_conv(B, p["conv_B"])
    C = causal_conv(C, p["conv_C"])
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, s, nh, hd)
    y, _ = ssd_chunked(xh, dt, A, B, C, s_cfg.chunk_size)
    return _out(p, cfg, y, xh, z)


def _conv_state(v, width: int):
    """The last ``width - 1`` rows of v (B, S, C) before the conv, with
    zeros in front of a prompt shorter than that (the conv's own padding)."""
    return F.pad(v, (0, 0, max(0, width - 1 - v.shape[1]), 0))[
        :, -(width - 1):]


def mamba_prefill(p, cfg, h):
    """h: (B, S, d) -> (out (B, S, d), {"conv": {"x", "B", "C"}, "ssd"}).

    Every length runs the chunked SSD op: a tail short of a chunk is padded
    with dt = 0 inside it (the JAX package runs its sequential scan
    instead when S is not a chunk multiple)."""
    s_cfg = cfg.ssm
    nh, hd = s_cfg.num_heads(cfg.d_model), s_cfg.head_dim
    b, s, _ = h.shape
    z, x, B, C, dt = _proj(p, h)
    w = s_cfg.conv_width
    conv_state = {"x": _conv_state(x, w), "B": _conv_state(B, w),
                  "C": _conv_state(C, w)}
    x = causal_conv(x, p["conv_x"])
    B = causal_conv(B, p["conv_B"])
    C = causal_conv(C, p["conv_C"])
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, s, nh, hd)
    y, final = ssd_chunked(xh, dt, A, B, C, s_cfg.chunk_size)
    return _out(p, cfg, y, xh, z), {"conv": conv_state, "ssd": final}


def mamba_decode(p, cfg, h_t, cache):
    """Single-token decode. h_t: (B, 1, d); cache: {"conv": {...}, "ssd"}.
    Returns (out (B, 1, d), the new cache)."""
    s_cfg = cfg.ssm
    nh, hd = s_cfg.num_heads(cfg.d_model), s_cfg.head_dim
    b = h_t.shape[0]
    z, x, B, C, dt = (v[:, 0] for v in _proj(p, h_t))
    conv = cache["conv"]
    cs_x, x = conv_step(conv["x"], x, p["conv_x"])
    cs_B, B = conv_step(conv["B"], B, p["conv_B"])
    cs_C, C = conv_step(conv["C"], C, p["conv_C"])
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, nh, hd)
    state, y = ssd_step(cache["ssd"], xh, dt, A, B, C)
    out = _out(p, cfg, y, xh, z)
    new_cache = {"conv": {"x": cs_x, "B": cs_B, "C": cs_C}, "ssd": state}
    return out[:, None, :], new_cache


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
