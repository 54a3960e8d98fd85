"""What each hand-written kernel costs, by its analytic count, and the
reports of the kernels' calls to an active step analysis.

One function a kernel and direction gives the work of one call: the FLOPs
the function needs (2 a multiply-add), the bytes it must move (each input
read once, each output written once) and the seconds its operations take
at the card's peak for their instruction class. ``*_bound_ms`` turn that
into the least time a call can take on the card, the larger of the
operations' time and the bytes over the memory rate. ``chip_smoke.py``
prints these bounds beside each kernel's measured time, and
``launch.op_analysis`` counts every kernel call at the same cost, so the
dry-run and the kernels line share one count.

The kernel ops report each call (``report``): on the card beside the
launch, on the meta device in its place (shapes and dtypes, no data: the
dry-run). A report goes to every step analysis that is recording
(``recording``) and costs nothing when none is. Reports are not launches:
each op's ``launches`` counters count the card's launches only.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.launch.mesh import (H100_BF16_FLOPS, H100_BYTES_PER_S,
                                     H100_F32_FLOPS, H100_TF32_FLOPS)


class Cost(NamedTuple):
    """One call's work: FLOPs (2 a multiply-add), bytes moved, and the
    seconds of its operations at the peak of the kernel's instruction
    class."""
    flops: float
    bytes: float
    ops_s: float


def bound_ms(cost: Cost) -> tuple[float, str]:
    """The least time for the work, in ms, and what bounds it: the larger
    of the operations' time at their peak and the bytes over the memory
    rate."""
    t_bytes = cost.bytes / H100_BYTES_PER_S
    return 1e3 * max(cost.ops_s, t_bytes), ("operations"
                                            if cost.ops_s >= t_bytes
                                            else "bytes")


def _width(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _peak(dtype) -> float:
    """The tensor cores' bf16 peak for bf16, the CUDA cores' for f32."""
    return H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS


def attention_pairs(s, window) -> int:
    """Unmasked (q, k) pairs of causal attention over S positions: each
    query sees itself and the keys before it, at most ``window`` of them
    when a window is set."""
    s, w = int(s), int(window)
    if not w or w >= s:
        return s * (s + 1) // 2
    return w * (w + 1) // 2 + (s - w) * w


def attention_cost(b, s, h, kv, d, window, dtype) -> Cost:
    """Causal attention: QK^T and PV on the unmasked (q, k) pairs; q, k, v
    read once and o written once."""
    flops = 4.0 * d * b * h * attention_pairs(s, window)
    nbytes = b * s * (2 * h + 2 * kv) * d * _width(dtype)
    return Cost(flops, nbytes, flops / _peak(dtype))


def attention_bwd_cost(b, s, h, kv, d, window, dtype) -> Cost:
    """The flash backward: the five products the gradient needs on the
    unmasked pairs (S = Q.K^T recomputed, dP = dO.V^T, dV, dK, dQ); q, k,
    v, o, dO and the f32 lse read once, dq, dk, dv written once."""
    flops = 10.0 * d * b * h * attention_pairs(s, window)
    nbytes = b * s * (4 * h + 4 * kv) * d * _width(dtype) + 4 * b * h * s
    return Cost(flops, nbytes, flops / _peak(dtype))


def gmm_cost(e, c, d, f, dtype) -> Cost:
    """Grouped matmul (E, C, d) @ (E, d, f): 2 E C d f flops; x and w read
    once, out written once. The backward's dx = dy.w^T is the product
    (E, C, f) @ (E, f, d), its dw = x^T.dy the product (E, d, C) @
    (E, C, f)."""
    flops = 2.0 * e * c * d * f
    nbytes = (e * c * d + e * d * f + e * c * f) * _width(dtype)
    return Cost(flops, nbytes, flops / _peak(dtype))


def gmm_bwd_cost(e, c, d, f, dtype) -> Cost:
    """The grouped matmul's backward as one function: dx = dy.w^T and dw =
    x^T.dy, 4 E C d f flops; x, w, dy read once, dx, dw written once."""
    flops = 4.0 * e * c * d * f
    nbytes = (2 * e * c * d + 2 * e * d * f + e * c * f) * _width(dtype)
    return Cost(flops, nbytes, flops / _peak(dtype))


def ssd_cost(b, nh, nc, c, hd, ds, peak=H100_TF32_FLOPS, passes=3) -> Cost:
    """SSD intra-chunk, f32: the least work the function needs. C.B^T on
    the causal triangle once per (batch, chunk), since B and C are shared
    by every head; per head, the weighted triangle times xdt and the
    (ds x hd) state. a, xdt, B, C read once; y and S written once. The
    operations' time by default for the kernel's instruction class, split
    TF32: three TF32 products for each f32 one at the TF32 peak;
    ``peak=H100_F32_FLOPS, passes=1`` gives it on the CUDA cores."""
    pairs = c * (c + 1) // 2
    flops = (b * nc * 2.0 * pairs * ds
             + b * nh * nc * (2.0 * pairs * hd + 2.0 * c * ds * hd))
    nbytes = 4 * (b * nh * nc * c + 2 * b * nh * nc * c * hd
                  + 2 * b * nc * c * ds + b * nh * nc * ds * hd)
    return Cost(flops, nbytes, passes * flops / peak)


def ssd_bwd_cost(b, nh, nc, c, hd, ds) -> Cost:
    """The SSD intra-chunk backward, f32: the least work the gradient
    needs. C.B^T on the causal triangle once per (batch, chunk); per head
    dy.xdt^T and M^T.dy on the triangle, B.dS and xdt.dS^T; per (batch,
    chunk) dC = dG.B and dB = dG^T.C on the triangle. a, xdt, B, C, dy and
    dS read once; da, dxdt, dB and dC written once. In split TF32, the
    kernel's instruction class."""
    pairs = c * (c + 1) // 2
    flops = (b * nc * 3 * 2.0 * pairs * ds
             + b * nh * nc * (4.0 * pairs * hd + 4.0 * c * ds * hd))
    nbytes = 4 * (2 * b * nh * nc * c + 3 * b * nh * nc * c * hd
                  + 4 * b * nc * c * ds + b * nh * nc * ds * hd)
    return Cost(flops, nbytes, 3 * flops / H100_TF32_FLOPS)


def attention_bound_ms(b, s, h, kv, d, window, dtype) -> tuple[float, str]:
    return bound_ms(attention_cost(b, s, h, kv, d, window, dtype))


def attention_bwd_bound_ms(b, s, h, kv, d, window, dtype) -> tuple[float,
                                                                   str]:
    return bound_ms(attention_bwd_cost(b, s, h, kv, d, window, dtype))


def gmm_bound_ms(e, c, d, f, dtype) -> tuple[float, str]:
    return bound_ms(gmm_cost(e, c, d, f, dtype))


def gmm_bwd_bound_ms(e, c, d, f, dtype) -> tuple[float, str]:
    return bound_ms(gmm_bwd_cost(e, c, d, f, dtype))


def ssd_bound_ms(b, nh, nc, c, hd, ds, peak=H100_TF32_FLOPS,
                 passes=3) -> tuple[float, str]:
    return bound_ms(ssd_cost(b, nh, nc, c, hd, ds, peak, passes))


def ssd_bwd_bound_ms(b, nh, nc, c, hd, ds) -> tuple[float, str]:
    return bound_ms(ssd_bwd_cost(b, nh, nc, c, hd, ds))


def model_flops(cfg, params, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (no recompute counted): 6 per
    token per weight of every product a token passes through (the tied
    unembedding included, the embedding lookup not; of an MoE layer's
    experts the top_k it is routed to) and three times each layer's causal
    attention products (forward, and the backward's two), a local layer's
    (``local_global_pattern``) on the pairs its window leaves. ``params`` is
    the transformer's tree (whole tensors, DTensors or meta tensors: only
    shapes are read)."""
    def weights(tree, moe=False):
        n = 0
        for k, v in tree.items():
            if isinstance(v, dict):
                n += weights(v, moe or k == "moe")
            elif v.ndim >= 3:     # stacked matrices, not stacked norms
                active = moe and k in ("wi", "wg", "wo") and v.ndim == 4
                n += v.numel() * (cfg.moe.top_k / cfg.moe.num_experts
                                  if active else 1)
        return n
    w = sum(weights(bp) for bp in params["blocks"])
    w += params["embed"]["tok"].numel()
    local = 0
    if cfg.local_global_pattern:
        lp, gp = cfg.local_global_pattern
        local = cfg.num_layers // (lp + gp) * lp
    pairs = local * attention_pairs(seq, cfg.sliding_window) + \
        (cfg.num_layers - local) * attention_pairs(seq, 0)
    attn = 3 * 4.0 * cfg.head_dim * cfg.num_heads * pairs
    return 6.0 * w * tokens + attn * tokens / seq


# -- reports of kernel calls ------------------------------------------------

_SINKS: list = []


def recording() -> bool:
    """Whether a step analysis takes reports now."""
    return bool(_SINKS)


def report(kernel: str, direction: str, shapes: tuple, cost: Cost):
    """One call of ``kernel`` in ``direction`` ("fwd", "bwd"; the grouped
    matmul's backward "dx", "dw") on inputs of ``shapes``, at ``cost``, to
    every recording analysis."""
    for sink in _SINKS:
        sink(kernel, direction, shapes, cost)


@contextlib.contextmanager
def reports_to(sink):
    """Send every kernel report made inside to ``sink(kernel, direction,
    shapes, cost)``."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)
