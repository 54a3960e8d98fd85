"""Public grouped (per-expert) matmul op: ``x[e] @ w[e]`` for every expert.

CPU tensors take the plain version (``ref.grouped_matmul_ref``); CUDA tensors
launch a hand-written kernel in ``csrc/grouped_matmul.cu`` or raise. There
is no fallback from the card to the plain version. On the card, bf16 takes
one of two tensor-core kernels by the capacity C (``_plan``): the tile
kernel for prefill-sized C, the weight-streaming kernel for decode-sized C;
f32 takes the CUDA-core kernel.

Where autograd records the call (grad enabled and an input that requires
grad), the CUDA path runs ``GroupedMatmul``, whose backward computes
``dx = dy . w^T`` and ``dw = x^T . dy`` on two more launches
(``_bwd_calls``): in bf16 the tile kernel's dx and dw variants, which read
dy, w and x where they lie (no transposed or padded copy); in f32 (the
parity path, off the timed path) the f32 kernel on contiguous transposed
copies. CPU tensors are differentiated through the plain version by
autograd.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# bf16 calls with C at most this take the streaming kernel (its rows: the
# C rows of x[e] zero-filled to 16), larger C the tile kernel
STREAM_MAX_C = 16

# forward launches in this process, backward launches (two a backward: dx
# and dw), and every launch per kernel ("tile", "stream" for the bf16
# forward, "dx", "dw" for the bf16 backward, "f32"); a run resets them to
# show which calls went through which kernel
launches = 0
bwd_launches = 0
launches_by_variant = {"tile": 0, "stream": 0, "dx": 0, "dw": 0, "f32": 0}
_lib = None


def _check_rows(d: int, f: int):
    """Raises unless d and f are multiples of 8 (the bf16 kernels copy
    16-byte rows)."""
    if d % 8 or f % 8:
        raise ValueError(f"the kernels take d and f in multiples of 8, not "
                         f"d={d}, f={f}")


def _plan(c: int, d: int, f: int) -> str:
    """The bf16 kernel that serves x (E, c, d) @ w (E, d, f): "stream" for
    decode-sized c, "tile" above. Raises unless d and f are multiples of
    8."""
    _check_rows(d, f)
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
    # the streaming kernel (x, w, o) and the backward's dx (dy, w, dx) and
    # dw (x, dy, dw); then E, C, D, F; stream
    for fn in (lib.grouped_matmul_stream_fwd, lib.grouped_matmul_bwd_dx,
               lib.grouped_matmul_bwd_dw):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
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


# each variant's exported function; all take (a, b, out, E, C, d, f,
# stream) for the product (E, C, d) @ (E, d, f), grouped_matmul_fwd ("tile"
# and "f32") with the dtype code after out
_FUNCTIONS = {"tile": "grouped_matmul_fwd", "f32": "grouped_matmul_fwd",
              "stream": "grouped_matmul_stream_fwd",
              "dx": "grouped_matmul_bwd_dx", "dw": "grouped_matmul_bwd_dw"}


def _launch(variant, a, b, e, c, d, f):
    """One launch of ``variant``'s kernel (CUDA tensors, checked by the
    caller) for the product (E, C, d) @ (E, d, f): the product itself (E,
    C, f) from a = x, b = w ("tile", "stream", "f32"), dx (E, C, d) from a
    = dy, b = w ("dx"), or dw (E, d, f) from a = x, b = dy ("dw")."""
    if a.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel reads its tensors in place: pass "
                         "contiguous tensors")
    if a.dtype == torch.bfloat16 and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("the bf16 kernels copy 16-byte rows: x, w and dy "
                         "must start on a 16-byte boundary")
    lib = load_library()
    shape = {"dx": (e, c, d), "dw": (e, d, f)}.get(variant, (e, c, f))
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    dtype = [_DTYPE_CODE[a.dtype]] if variant in ("tile", "f32") else []
    with torch.cuda.device(a.device):
        err = getattr(lib, _FUNCTIONS[variant])(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), *dtype, e, c, d, f,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"grouped_matmul {variant} kernel launch failed "
                           f"with CUDA error {err} (E={e}, C={c}, d={d}, "
                           f"f={f}, {a.dtype})")
    launches_by_variant[variant] += 1
    return out


def _forward(x, w):
    """x @ w on the kernel that ``_plan`` picks (CUDA tensors, checked by
    the caller): (E, C, f) in x's dtype."""
    e, c, d = x.shape
    f = w.shape[2]
    variant = _plan(c, d, f) if x.dtype == torch.bfloat16 else "f32"
    return _launch(variant, x, w, e, c, d, f)


def _bwd_calls(x, w, dy, need_dx: bool, need_dw: bool) -> dict:
    """The launches of the backward of x (E, C, d) @ w (E, d, f) for the
    output gradient dy (E, C, f), by gradient: (variant, a, b, (E, C, d,
    f) of the product the variant computes), ``_launch``'s arguments. bf16
    takes the tile kernel's "dx" (dy, w) and "dw" (x, dy) variants on the
    tensors themselves; float32, the parity path, takes the f32 kernel on
    w^T and x^T copied contiguous. Raises for bf16 unless d and f are
    multiples of 8. A gradient not needed is not launched."""
    e, c, d = x.shape
    f = w.shape[2]
    if x.dtype == torch.bfloat16:
        _check_rows(d, f)
        calls = {"dx": ("dx", dy, w, (e, c, d, f)),
                 "dw": ("dw", x, dy, (e, c, d, f))}
    else:
        calls = {"dx": ("f32", dy, w.transpose(1, 2).contiguous(),
                        (e, c, f, d)),
                 "dw": ("f32", x.transpose(1, 2).contiguous(), dy,
                        (e, d, c, f))}
    return {g: call for g, call in calls.items()
            if {"dx": need_dx, "dw": need_dw}[g]}


def grouped_matmul_bwd(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """(dx, dw) of x @ w for the output gradient ``dy`` on the kernels
    (CUDA tensors): dx = dy @ w^T (E, C, d), dw = x^T @ dy (E, d, f), one
    launch each as ``_bwd_calls`` plans them. An output not needed is
    None."""
    global bwd_launches
    grads = {}
    for g, (variant, a, b, dims) in _bwd_calls(x, w, dy.contiguous(), need_dx,
                                               need_dw).items():
        grads[g] = _launch(variant, a, b, *dims)
        bwd_launches += 1
    return grads.get("dx"), grads.get("dw")


class GroupedMatmul(torch.autograd.Function):
    """The kernel as a differentiable op on CUDA tensors: its backward is
    ``grouped_matmul_bwd`` (two more launches of the kernels)."""

    @staticmethod
    def forward(ctx, x, w):
        global launches
        ctx.save_for_backward(x, w)
        out = _forward(x, w)
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
    out = _forward(x, w)
    launches += 1
    return out
