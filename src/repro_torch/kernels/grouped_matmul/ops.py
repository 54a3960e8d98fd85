"""Public grouped (per-expert) matmul op: ``x[e] @ w[e]`` for every expert.

CPU tensors take the plain version (``ref.grouped_matmul_ref``); CUDA tensors
launch a hand-written kernel in ``csrc/grouped_matmul.cu`` or raise. There
is no fallback from the card to the plain version. On the card, bf16 takes
one of two tensor-core kernels by the capacity C (``_plan``): the tile
kernel for prefill-sized C, the weight-streaming kernel for decode-sized C;
f32 takes the CUDA-core kernel.

Where autograd records the call (grad enabled and an input that requires
grad), the CUDA path runs ``GroupedMatmul``, whose backward computes
``dx = gmm(dy, w^T)`` and ``dw = gmm(x^T, dy)`` through the same kernels, on
contiguous transposed copies (the capacity, dw's contraction, zero-padded
to a multiple of 8 for the bf16 kernels). CPU tensors are differentiated
through the plain version by autograd.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# bf16 calls with C at most this take the streaming kernel (its rows: the
# C rows of x[e] zero-filled to 16), larger C the tile kernel
STREAM_MAX_C = 16

# forward launches in this process, backward launches (two a backward: dx
# and dw), and every launch per kernel ("tile", "stream" for bf16, "f32");
# a run resets them to show which calls went through which kernel
launches = 0
bwd_launches = 0
launches_by_variant = {"tile": 0, "stream": 0, "f32": 0}
_lib = None


def _plan(c: int, d: int, f: int) -> str:
    """The bf16 kernel that serves x (E, c, d) @ w (E, d, f): "stream" for
    decode-sized c, "tile" above. Raises unless d and f are multiples of 8
    (the kernels copy 16-byte rows)."""
    if d % 8 or f % 8:
        raise ValueError(f"the kernels take d and f in multiples of 8, not "
                         f"d={d}, f={f}")
    return "stream" if c <= STREAM_MAX_C else "tile"


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with its C
    signature declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(SOURCE)
    fn = lib.grouped_matmul_fwd
    # x, w, o; dtype, E, C, D, F; stream
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.grouped_matmul_stream_fwd
    # x, w, o; E, C, D, F; stream
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(x, w):
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError("grouped_matmul wants x (E, C, d) and w (E, d, f)")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise ValueError(f"mixed dtypes {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")


def _launch(x, w):
    """One launch of the kernel that ``_plan`` picks for x @ w (CUDA
    tensors, checked by the caller): (E, C, f) in x's dtype."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel reads x and w in place: pass contiguous "
                         "tensors")
    e, c, d = x.shape
    f = w.shape[2]
    variant = "f32"
    if x.dtype == torch.bfloat16:
        variant = _plan(c, d, f)
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("the bf16 kernels copy 16-byte rows: x and w "
                             "must start on a 16-byte boundary")
    lib = load_library()
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if variant == "stream":
            err = lib.grouped_matmul_stream_fwd(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                stream)
        else:
            err = lib.grouped_matmul_fwd(
                x.data_ptr(), w.data_ptr(), out.data_ptr(),
                _DTYPE_CODE[x.dtype], e, c, d, f, stream)
    if err:
        raise RuntimeError(f"grouped_matmul {variant} kernel launch failed "
                           f"with CUDA error {err} (E={e}, C={c}, d={d}, "
                           f"f={f}, {x.dtype})")
    launches_by_variant[variant] += 1
    return out


def grouped_matmul_bwd(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """(dx, dw) of x @ w for the output gradient ``dy`` on the kernels:
    dx = dy @ w^T (E, C, d), dw = x^T @ dy (E, d, f), each through ``w^T``
    or ``x^T`` copied contiguous; dw's contraction (the capacity C) is
    zero-padded to a multiple of 8 for bf16, which adds nothing to the sum.
    An output not needed is None and not launched."""
    global bwd_launches
    dy = dy.contiguous()
    dx = dw = None
    if need_dx:
        dx = _launch(dy, w.transpose(1, 2).contiguous())
        bwd_launches += 1
    if need_dw:
        xt = x.transpose(1, 2).contiguous()                   # (E, d, C)
        pad = -x.shape[1] % 8 if x.dtype == torch.bfloat16 else 0
        if pad:
            xt, dy = F.pad(xt, (0, pad)), F.pad(dy, (0, 0, 0, pad))
        dw = _launch(xt, dy)
        bwd_launches += 1
    return dx, dw


class GroupedMatmul(torch.autograd.Function):
    """The kernel as a differentiable op on CUDA tensors: its backward is
    ``grouped_matmul_bwd`` (two more launches of the kernels)."""

    @staticmethod
    def forward(ctx, x, w):
        global launches
        ctx.save_for_backward(x, w)
        out = _launch(x, w)
        launches += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return grouped_matmul_bwd(x, w, dy, *ctx.needs_input_grad)


def grouped_matmul(x, w):
    """x: (E, C, d); w: (E, d, f). Returns (E, C, f) in x's dtype, summed
    over d in f32. Differentiable: on the card through ``GroupedMatmul``,
    on the CPU through the plain version."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda, not "
                         f"{x.device.type}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w)
    out = _launch(x, w)
    launches += 1
    return out
