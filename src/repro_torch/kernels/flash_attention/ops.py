"""Public flash attention op in the model's (B, S, H, D) layout.

CPU tensors take the plain version (``ref.attention_ref``); CUDA tensors
launch the hand-written kernel in ``csrc/flash_attention.cu`` or raise. There
is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
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
    fn = lib.flash_attention_fwd
    # q, k, v, o; dtype, B, S, H, KV, D, causal, window; softcap; stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention wants q (B,S,H,D), k/v (B,S,KV,D)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads do not group over {k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, S, H, D); k/v: (B, S, KV, D). Returns (B, S, H, D) in q's
    dtype. ``window`` > 0 keeps keys with qpos - kpos < window; ``softcap``
    > 0 applies ``tanh(s / cap) * cap`` to the scaled scores."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device.type}")
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel reads q, k, v in place: pass contiguous "
                         "tensors")
    lib = load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, s, h, k.shape[2], d, int(bool(causal)),
            int(window), float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err} (B={b}, S={s}, H={h}, "
                           f"KV={k.shape[2]}, D={d}, {q.dtype})")
    launches += 1
    return out
