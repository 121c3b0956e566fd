"""Tests that need an NVIDIA GPU: the CUDA kernels have no CPU mode.

They import neither JAX nor the JAX package, so they also run where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from leccr_torch.ops.fused_cross_attention import (
    fused_cross_attention,
    fused_cross_attention_reference,
)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    _, exp = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(4, 200), (145, 4), (4, 145)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(lq, lk, dtype):
    """The kernel against its plain version at the flagship shapes (B=64,
    H=8, Dh=64) on head-split views, with a fully padded row: f32 atol
    1e-5, bf16 atol 1e-5 plus 1 bf16 ulp of the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(lq + lk)
    q, k, v = (torch.randn(64, n, 8, 64, device="cuda", generator=g)
               .to(dtype).transpose(1, 2) for n in (lq, lk, lk))
    pad = torch.rand(64, lk, device="cuda", generator=g) < 0.3
    pad[0] = True
    before = fused_cross_attention.launches
    got = fused_cross_attention(q, k, v, pad).float()
    assert fused_cross_attention.launches == before + 1
    want = fused_cross_attention_reference(q, k, v, pad).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert ((got - want).abs() <= 1e-5 + _bf16_ulp(want)).all()
