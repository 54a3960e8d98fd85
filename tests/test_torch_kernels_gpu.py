"""The CUDA flash attention kernel against its plain version on the card
(``pytest -m gpu``). Needs no JAX; skips without a card, decided inside the
test so every worker collects the same tests."""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

# (B, S, H, KV, D, window, softcap): the sweep of tests/test_kernels.py, the
# reduced configs' head dim and the yi-9b prefill shape
CASES = [
    (2, 128, 4, 4, 32, 0, 0.0),
    (2, 192, 4, 2, 64, 0, 0.0),
    (2, 128, 4, 2, 32, 48, 0.0),
    (2, 128, 2, 2, 64, 0, 30.0),
    (2, 96, 8, 1, 32, 32, 50.0),
    (3, 37, 4, 2, 16, 0, 0.0),
    (1, 300, 2, 1, 256, 0, 0.0),
    (4, 1024, 32, 4, 128, 0, 0.0),
]


def _tol(dtype, s):
    # f32: summation order only (longer rows at S=1024); bf16: output
    # rounding, the kernel keeps probabilities in f32
    if dtype == torch.bfloat16:
        return 2e-2
    return 1e-4 if s >= 1024 else 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,win,cap", CASES)
def test_cuda_kernel_matches_plain_version(b, s, h, kv, d, win, cap, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
               for n in (h, kv, kv))
    before = ops.launches
    out = ops.flash_attention(q, k, v, window=win, softcap=cap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = attention_ref(q, k, v, window=win, softcap=cap)
    tol = _tol(dtype, s)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
