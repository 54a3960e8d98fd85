"""Public flash attention op in the model's (B, S, H, D) layout.

CPU tensors take the plain version (``ref.attention_ref``, differentiated
by autograd); CUDA tensors launch the hand-written kernels in
``csrc/flash_attention.cu`` or raise. There is no fallback from the card to
the plain version. Where autograd records the call (grad enabled and an
input that requires grad), the CUDA path runs ``FlashAttention``: its
forward launches the kernel with each row's log-sum-exp and saves (q, k, v,
o, lse), its backward launches the backward kernel. ``launches`` counts
forward launches (serving and training), ``bwd_launches`` backward ones.

Meta tensors (the dry-run: shapes and dtypes, no data) take the CUDA path
with its checks and allocations, but where the card would launch a kernel
the op returns the kernel's outputs empty on the meta device; it never
runs the plain version there. Each call, launched or on meta, is reported
with its cost (``kernels.costs.attention_cost``, ``attention_bwd_cost``)
to a recording step analysis; a meta call is not a launch.

The backward of bf16 at head dims 64 and 128 runs on the tensor cores in
one pass over the scores and sums dQ into an f32 buffer by atomics, so its
dQ's summation order varies from run to run; f32 (the parity path) and
head dim 256 run on the CUDA cores, deterministic. The library says which
(``flash_attention_bwd_sums_dq``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)
# the backward sums dQ into a zeroed f32 buffer for bf16 at these head dims
# (the library's ``flash_attention_bwd_sums_dq``, which a meta call cannot
# ask)
SUMS_DQ_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches in this process, forward and backward; a run resets them
# to show which calls went through the kernels
launches = 0
bwd_launches = 0
_lib = None


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with its C
    signature declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_fwd
    # q, k, v, o, lse; dtype, B, S, H, KV, D, causal, window; softcap; stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_bwd
    # q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv; dtype, B, S, H, KV,
    # D, causal, window; softcap; stream
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # dtype, D: 1 where the backward sums dQ into a zeroed f32 buffer
    fn = lib.flash_attention_bwd_sums_dq
    fn.argtypes = [ctypes.c_int] * 2
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


def _check_cuda(q, k, v, head_dims=HEAD_DIMS):
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if q.shape[3] not in head_dims:
        raise ValueError(f"the kernel takes head dims {head_dims}, not "
                         f"{q.shape[3]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel reads q, k, v in place: pass contiguous "
                         "tensors")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the bf16 kernel copies 16-byte rows: q, k and v "
                         "must start on a 16-byte boundary")


def _report(direction: str, q, k, window):
    if costs.recording():
        b, s, h, d = q.shape
        cost = (costs.attention_cost if direction == "fwd"
                else costs.attention_bwd_cost)
        costs.report("flash_attention", direction,
                     (tuple(q.shape), tuple(k.shape)),
                     cost(b, s, h, k.shape[2], d, window, q.dtype))


def _forward(q, k, v, causal, window, softcap, with_lse: bool):
    """Launch the forward kernel: (out, lse or None); on meta tensors
    their empty outputs."""
    global launches
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _report("fwd", q, k, window)
    if q.device.type == "meta":
        return out, lse
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, s, h, k.shape[2], d, int(bool(causal)),
            int(window), float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err} (B={b}, S={s}, H={h}, "
                           f"KV={k.shape[2]}, D={d}, {q.dtype})")
    launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True, window=0,
                        softcap=0.0):
    """Launch the backward kernel: (dq, dk, dv) in q's dtype for the output
    gradient ``dout``, from the forward's ``out`` and ``lse`` (B, H, S) f32.
    CUDA tensors (meta tensors: their empty outputs); head dims
    ``BWD_HEAD_DIMS``. The kernels allocate nothing: the wrapper gives them
    delta's (B, H, S) f32 scratch and, where the library's
    ``flash_attention_bwd_sums_dq`` says so (bf16 at head dims
    ``SUMS_DQ_HEAD_DIMS``), the zeroed f32 buffer dQ is summed into."""
    global bwd_launches
    _check(q, k, v)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError("the backward kernel runs on cuda tensors; the plain "
                         "backward is ref.attention_ref_bwd")
    _check_cuda(q, k, v, BWD_HEAD_DIMS)
    b, s, h, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, H, S) = {(b, h, s)} float32")
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    meta = q.device.type == "meta"
    lib = None if meta else load_library()
    sums_dq = (q.dtype == torch.bfloat16 and d in SUMS_DQ_HEAD_DIMS) if meta \
        else lib.flash_attention_bwd_sums_dq(_DTYPE_CODE[q.dtype], d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq_acc = (torch.zeros(q.shape, dtype=torch.float32, device=q.device)
              if sums_dq else None)
    _report("bwd", q, k, window)
    if meta:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], b, s, h,
            k.shape[2], d, int(bool(causal)), int(window), float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed with "
                           f"CUDA error {err} (B={b}, S={s}, H={h}, "
                           f"KV={k.shape[2]}, D={d}, {q.dtype})")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op on CUDA tensors: forward
    with the log-sum-exp, saving (q, k, v, o, lse); backward on the
    backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, S, H, D); k/v: (B, S, KV, D). Returns (B, S, H, D) in q's
    dtype. ``window`` > 0 keeps keys with qpos - kpos < window; ``softcap``
    > 0 applies ``tanh(s / cap) * cap`` to the scaled scores.
    Differentiable: on the card (and on meta) through ``FlashAttention``
    (head dims ``BWD_HEAD_DIMS``), on the CPU through the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, not "
                         f"{q.device.type}")
    _check_cuda(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.shape[3] not in BWD_HEAD_DIMS:
            raise ValueError(f"the backward kernel takes head dims "
                             f"{BWD_HEAD_DIMS}, not {q.shape[3]}")
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, with_lse=False)[0]
