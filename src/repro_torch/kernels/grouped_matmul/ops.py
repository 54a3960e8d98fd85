"""Public grouped (per-expert) matmul op: ``x[e] @ w[e]`` for every expert.

CPU tensors take the plain version (``ref.grouped_matmul_ref``); CUDA tensors
launch the hand-written kernel in ``csrc/grouped_matmul.cu`` or raise. There
is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches in this process; a run resets it to show which calls went
# through the kernel
launches = 0
_lib = None


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


def grouped_matmul(x, w):
    """x: (E, C, d); w: (E, d, f). Returns (E, C, f) in x's dtype, summed
    over d in f32."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda, not "
                         f"{x.device.type}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel reads x and w in place: pass contiguous "
                         "tensors")
    e, c, d = x.shape
    f = w.shape[2]
    lib = load_library()
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.grouped_matmul_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
            e, c, d, f, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"grouped_matmul kernel launch failed with CUDA "
                           f"error {err} (E={e}, C={c}, d={d}, f={f}, "
                           f"{x.dtype})")
    launches += 1
    return out
