"""The port's CUDA flash-attention forward against its plain version, on the
card.  Marked ``gpu``; every test skips without a CUDA device.  Imports no
JAX, so on the card's machine it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_cuda.py

Tolerance: out atol = rtol = 2e-2 (P is rounded to bf16 before P.V and sums
run in another order), lse atol 1e-3 (fp32 throughout).
"""

import importlib

import pytest
import torch

tfa = importlib.import_module("tpu_parallel_torch.ops.flash_attention")

pytestmark = pytest.mark.gpu

# name: (B, H, H_KV, S, D, kwargs) — shapes (a), (b) and (e) of the card check
SHAPES = {
    "a_gpt2_main_path": (8, 12, 12, 1024, 64, dict(causal=True)),
    "b_gqa_d128": (2, 16, 4, 2048, 128, dict(causal=True)),
    "e_chunk_ahead": (2, 4, 4, 1024, 64, dict(causal=False, q_offset=512, window=640)),
    "e_chunk_behind_empty_rows": (2, 4, 4, 1024, 64, dict(causal=False, q_offset=-512, window=640)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_plain_version(cuda, name):
    b, h, h_kv, s, d, kw = SHAPES[name]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, h, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, h_kv, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, h_kv, s, d, device=cuda, generator=gen).to(torch.bfloat16)
    before = tfa.flash_fwd_launches
    with torch.inference_mode():
        out, lse = tfa._flash_fwd(q, k, v, **kw)
        want_out, want_lse = tfa.flash_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_launches == before + 1
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


def test_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tfa._flash_fwd(q, q, q)
    q16 = torch.zeros(1, 2, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._flash_fwd(q16, q16, q16)
    g = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa._flash_fwd(g, g, g)
