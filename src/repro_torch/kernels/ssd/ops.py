"""Public SSD ops: the intra-chunk kernel and the chunked scan around it.

``ssd_intra_chunk`` is the counterpart of the JAX package's
``ssd_intra_chunk``: CPU tensors take the plain version
(``ref.ssd_intra_chunk_ref``, which autograd differentiates); CUDA tensors
launch the hand-written kernels in ``csrc/ssd.cu`` (split TF32 on the
tensor cores: C·Bᵀ once per (batch, chunk) and the state product in a
first grid, y in a second, one head a block) or raise. With grad enabled
and an input that requires grad, a CUDA call goes through
``SSDIntraChunk``, whose backward launches the backward kernels
(``ssd_intra_chunk_bwd``: four grids in split TF32 on the tensor cores, the
heads' dG summed on chip and every sum in a fixed order), so a CUDA result
never lacks the gradient of the intra-chunk term.
``ssd_chunked`` is the counterpart of ``ssd_chunked_pallas``: the kernel for
the intra-chunk dual form, the short inter-chunk recurrence in torch.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
HEAD_DIMS = (16, 32, 64, 128)

TILE = 64           # rows of y a block computes
KEY_PART = 128      # keys a block of y reduces over; y adds up the parts

# kernel launches in this process (forward, backward); a run resets them to
# show which calls went through the kernels
launches = 0
bwd_launches = 0
MAX_BWD_CHUNK = 1024    # chunk rows the backward's per-head grid keeps
# heads in a part of the backward's head term: the wrapper sizes that
# workspace, so it passes the kernel the part count rather than the kernel
# fixing it
HEADS_PER_PART = 8
_lib = None


def _y_units(c: int) -> int:
    """Blocks of y for one (batch, chunk, head): for each 64-row tile, one
    for each part of ``KEY_PART`` keys it reduces over (a row tile reaches
    the keys up to its last row)."""
    return sum(-(-min(r0 + TILE, c) // KEY_PART) for r0 in range(0, c, TILE))


def y_blocks(b: int, nh: int, nc: int, c: int) -> int:
    """Blocks in the kernels' grid of y, the larger of their two grids: one
    head a block, ``_y_units(c)`` blocks for each (batch, chunk, head)."""
    return b * nc * nh * _y_units(c)


def bwd_workspace(b: int, nh: int, nc: int, c: int, ds: int) -> dict:
    """Shapes of the backward's workspaces: C·Bᵀ and the heads' summed dG
    (b, nc, c, c) each, the cumsums (b, nh, nc, c), each head's row and
    column sums of P on each causal (row tile, key tile) pair (b, nc, nh,
    pairs, 2, 64), and the head term's parts of ``HEADS_PER_PART`` heads
    (b, nc, parts, c, ds)."""
    tiles = -(-c // TILE)
    parts = -(-nh // HEADS_PER_PART)
    return {"cb": (b, nc, c, c), "dg": (b, nc, c, c), "acs": (b, nh, nc, c),
            "sums": (b, nc, nh, tiles * (tiles + 1) // 2, 2, TILE),
            "hparts": (b, nc, parts, c, ds)}


def bwd_workspace_bytes(b: int, nh: int, nc: int, c: int, ds: int) -> int:
    """Bytes the backward's wrapper allocates besides its outputs."""
    return 4 * sum(math.prod(s) for s in
                   bwd_workspace(b, nh, nc, c, ds).values())


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with its C
    signature declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(SOURCE)
    fn = lib.ssd_intra_chunk_fwd
    # a, xdt, B, C, y, S, workspaces for C·Bᵀ and the cumsums; b, nh, nc,
    # c, hd, ds; stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.ssd_intra_chunk_bwd
    # a, xdt, B, C, dy, dS, da, dxdt, dB, dC, the workspaces of
    # bwd_workspace in its order; b, nh, nc, c, hd, ds, parts; stream
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(a, xdt, B, C):
    if a.ndim != 4 or xdt.ndim != 5 or B.ndim != 4 or C.ndim != 4:
        raise ValueError("ssd_intra_chunk wants a (b,nh,nc,c), xdt "
                         "(b,nh,nc,c,hd), B/C (b,nc,c,ds)")
    b, nh, nc, c = a.shape
    if xdt.shape[:4] != (b, nh, nc, c) or B.shape != C.shape or \
            B.shape[:3] != (b, nc, c):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, xdt "
                         f"{tuple(xdt.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    if not all(t.dtype == torch.float32 for t in (a, xdt, B, C)):
        raise ValueError("ssd_intra_chunk takes float32 tensors")
    if not all(t.device == a.device for t in (xdt, B, C)):
        raise ValueError("a, xdt, B and C must be on one device")


def _check_cuda(a, xdt, B, C):
    if a.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cpu or cuda, not "
                         f"{a.device.type}")
    hd = xdt.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {hd}")
    if not all(t.is_contiguous() for t in (a, xdt, B, C)):
        raise ValueError("the kernel reads its inputs in place: pass "
                         "contiguous tensors")


def _forward(a, xdt, B, C):
    """Launch the forward kernels on checked CUDA inputs: (y, S)."""
    global launches
    b, nh, nc, c = a.shape
    hd, ds = xdt.shape[-1], B.shape[-1]
    lib = load_library()
    y = torch.empty_like(xdt)
    S = torch.empty((b, nh, nc, ds, hd), dtype=torch.float32, device=a.device)
    # the kernels' workspace: C·Bᵀ (b, nc, c, c), then the cumsums of a
    n_cb = b * nc * c * c
    ws = torch.empty(n_cb + a.numel(), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.ssd_intra_chunk_fwd(
            a.data_ptr(), xdt.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), S.data_ptr(), ws.data_ptr(),
            ws.data_ptr() + 4 * n_cb, b, nh, nc, c, hd, ds,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed with CUDA "
                           f"error {err} (b={b}, nh={nh}, nc={nc}, c={c}, "
                           f"hd={hd}, ds={ds})")
    launches += 1
    return y, S


def ssd_intra_chunk_bwd(a, xdt, B, C, dy, dS):
    """Launch the backward kernels: (da, dxdt, dB, dC) for the output
    gradients ``dy`` (b, nh, nc, c, hd) and ``dS`` (b, nh, nc, ds, hd), f32.
    CUDA tensors only; head dims ``HEAD_DIMS``, chunks up to
    ``MAX_BWD_CHUNK``. The kernels allocate nothing: the wrapper gives them
    the workspaces of ``bwd_workspace``."""
    global bwd_launches
    _check(a, xdt, B, C)
    if a.device.type != "cuda":
        raise ValueError("the backward kernel runs on cuda tensors; the "
                         "plain backward is ref.ssd_intra_chunk_ref_bwd")
    _check_cuda(a, xdt, B, C)
    b, nh, nc, c = a.shape
    hd, ds = xdt.shape[-1], B.shape[-1]
    if dy.shape != xdt.shape or dS.shape != (b, nh, nc, ds, hd) or \
            dy.dtype != torch.float32 or dS.dtype != torch.float32 or \
            dy.device != a.device or dS.device != a.device:
        raise ValueError(f"dy must be {tuple(xdt.shape)} and dS "
                         f"{(b, nh, nc, ds, hd)}, float32 on {a.device}")
    if c > MAX_BWD_CHUNK:
        raise ValueError(f"the backward kernel takes chunks up to "
                         f"{MAX_BWD_CHUNK}, not {c}")
    dy, dS = dy.contiguous(), dS.contiguous()
    lib = load_library()
    da, dxdt = torch.empty_like(a), torch.empty_like(xdt)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    ws = [torch.empty(shape, dtype=torch.float32, device=a.device)
          for shape in bwd_workspace(b, nh, nc, c, ds).values()]
    with torch.cuda.device(a.device):
        err = lib.ssd_intra_chunk_bwd(
            a.data_ptr(), xdt.data_ptr(), B.data_ptr(), C.data_ptr(),
            dy.data_ptr(), dS.data_ptr(), da.data_ptr(), dxdt.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), *(w.data_ptr() for w in ws),
            b, nh, nc, c, hd, ds, ws[-1].shape[2],
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_intra_chunk backward launch failed with "
                           f"CUDA error {err} (b={b}, nh={nh}, nc={nc}, "
                           f"c={c}, hd={hd}, ds={ds})")
    bwd_launches += 1
    return da, dxdt, dB, dC


class SSDIntraChunk(torch.autograd.Function):
    """The kernel pair as one differentiable op on CUDA tensors: the forward
    kernels, saving (a, xdt, B, C); the backward kernels."""

    @staticmethod
    def forward(ctx, a, xdt, B, C):
        y, S = _forward(a, xdt, B, C)
        ctx.save_for_backward(a, xdt, B, C)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        # an output the loss does not reach comes as zeros (autograd
        # materialises the gradients of a Function by default)
        return ssd_intra_chunk_bwd(*ctx.saved_tensors, dy, dS)


def ssd_intra_chunk(a, xdt, B, C):
    """a: (b, nh, nc, c) log-decays; xdt: (b, nh, nc, c, hd); B/C:
    (b, nc, c, ds); float32. Returns (y_intra (b, nh, nc, c, hd), S_local
    (b, nh, nc, ds, hd)), float32. Differentiable: on the card through
    ``SSDIntraChunk`` (chunks up to ``MAX_BWD_CHUNK``), on the CPU through
    the plain version."""
    _check(a, xdt, B, C)
    if a.device.type == "cpu":
        return ssd_intra_chunk_ref(a, xdt, B, C)
    _check_cuda(a, xdt, B, C)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (a, xdt, B, C)):
        if a.shape[-1] > MAX_BWD_CHUNK:
            raise ValueError(f"the backward kernel takes chunks up to "
                             f"{MAX_BWD_CHUNK}, not {a.shape[-1]}")
        return SSDIntraChunk.apply(a, xdt, B, C)
    return _forward(a, xdt, B, C)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD for any length. x: (b, s, nh, hd); dt: (b, s, nh) f32
    (after softplus); A: (nh,) negative; B/C: (b, s, ds). Returns (y
    (b, s, nh, hd) in x's dtype, final state (b, nh, hd, ds) f32).

    A tail that does not fill a chunk is padded with dt = 0: there the log
    decay ``dt * A`` and the input ``dt * x`` are 0, so the outputs at real
    positions and the final state are those of the unpadded sequence."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    f32 = torch.float32
    dtc = dt.reshape(b, nc, chunk, nh).to(f32)
    a = (dtc * A).permute(0, 3, 1, 2).contiguous()            # (b,nh,nc,c)
    xc = x.reshape(b, nc, chunk, nh, hd)
    xdt = (xc.to(f32) * dtc[..., None]).permute(0, 3, 1, 2, 4).contiguous()
    Bc = B.reshape(b, nc, chunk, ds).to(f32).contiguous()
    Cc = C.reshape(b, nc, chunk, ds).to(f32).contiguous()

    y_intra, s_loc = ssd_intra_chunk(a, xdt, Bc, Cc)

    # inter-chunk recurrence: S_n = exp(acs_n[-1]) S_{n-1} + S_n_local
    acs = torch.cumsum(a, dim=-1)
    chunk_decay = torch.exp(acs[..., -1])                      # (b,nh,nc)
    state = torch.zeros((b, nh, ds, hd), dtype=f32, device=x.device)
    prev = []
    for n in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, n, None, None] + s_loc[:, :, n]
    s_prev = torch.stack(prev, dim=2)                          # (b,nh,nc,ds,hd)
    y_inter = torch.einsum("bncs,bhnsp->bhncp", Cc, s_prev) \
        * torch.exp(acs)[..., None]
    y = (y_intra + y_inter).permute(0, 2, 3, 1, 4).reshape(b, s + pad, nh, hd)
    # the final state in the model's (b, nh, hd, ds) layout
    return y[:, :s].to(x.dtype), state.transpose(-1, -2)
