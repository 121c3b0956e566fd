"""Tests that need an NVIDIA GPU: the CUDA kernels have no CPU mode.

The fused cross-attention kernel (eval), the single-block flash
tower-attention kernels 2/3 and the chunked kernels 4/5 (training, forward
and backward) against their plain versions on the card, and the launch
counters that show a path went through them.

They import neither JAX nor the JAX package, so they also run where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from chip_smoke import BF16_K, bf16_k_needed, flash_term_scales
from leccr_torch.ops.flash_attention import (
    flash_chunked_attention_bwd,
    flash_chunked_attention_bwd_reference,
    flash_chunked_attention_fwd,
    flash_chunked_attention_fwd_reference,
    flash_tower_attention,
    flash_tower_attention_bwd,
    flash_tower_attention_bwd_reference,
    flash_tower_attention_fwd,
    flash_tower_attention_fwd_reference,
)
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


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _flash_inputs(batch, length, dtype, masked, seed=0, heads=12, dh=64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    # the path's layout: [B, L, H, Dh] storage seen as [B, H, L, Dh]
    q, k, v, grad = (torch.randn(batch, length, heads, dh, device="cuda",
                                 generator=g).to(dtype).transpose(1, 2)
                     for _ in range(4))
    pad = None
    if masked:
        pad = torch.rand(batch, length, device="cuda", generator=g) < 0.3
        pad[0] = True  # a fully padded row
        pad[1] = False
    return q, k, v, grad, pad


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["vision", "text"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_versions(shape, dtype):
    """Kernels 2 and 3 against their plain versions: the vision shape (145
    tokens, no mask, rate 0) and the text shape (64 tokens, padding with a
    fully padded row, rate 0.1) at 12 heads of 64, batch cut to 8.  f32:
    out and lse atol 1e-5, grads atol 1e-4; bf16: lse atol 1e-5, out and
    grads within 1e-5 + BF16_K bf16 ulps of the sum of the absolute values
    of each element's terms (chip_smoke.flash_term_scales)."""
    _needs_card()
    length, rate, masked = (145, 0.0, False) if shape == "vision" else (
        64, 0.1, True)
    q, k, v, grad, pad = _flash_inputs(8, length, dtype, masked)
    seed = 4242
    out, lse = flash_tower_attention_fwd(q, k, v, pad, seed, rate)
    grads = flash_tower_attention_bwd(q, k, v, pad, lse, grad, seed, rate)
    want_out, want_lse = flash_tower_attention_fwd_reference(
        q, k, v, pad, seed, rate)
    want_grads = flash_tower_attention_bwd_reference(
        q, k, v, pad, want_lse, grad, seed, rate)
    torch.cuda.synchronize()
    assert (lse - want_lse).abs().max().item() <= 1e-5
    pairs = {"out": (out, want_out),
             **dict(zip(("dq", "dk", "dv"), zip(grads, want_grads)))}
    assert all(torch.isfinite(a).all() for a, _ in pairs.values())
    if dtype == torch.float32:
        for name, (got, want) in pairs.items():
            tol = 1e-5 if name == "out" else 1e-4
            assert (got - want).abs().max().item() <= tol, name
    else:
        scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed, rate)
        for name, (got, want) in pairs.items():
            assert bf16_k_needed(got, want, scales[name]) <= BF16_K, name


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 32])
@pytest.mark.parametrize("shape", ["vision", "text"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_kernels_match_plain_versions(shape, dtype, dh):
    """Kernels 4 and 5 against their plain versions: ViT-L/14 @336 (577
    tokens, 16 heads, no mask, rate 0) and the 200-token text bucket (key
    padding with a fully padded row, rate 0.1), batch cut to 4; bf16 at
    Dh=64 takes the tensor-core kernels, every other case the scalar ones.
    Tolerances as kernels 2/3's, with the chunked rounding points in the
    term sums."""
    _needs_card()
    length, rate, masked = (577, 0.0, False) if shape == "vision" else (
        200, 0.1, True)
    q, k, v, grad, pad = _flash_inputs(4, length, dtype, masked, heads=16,
                                       dh=dh)
    seed = 4242
    out, lse = flash_chunked_attention_fwd(q, k, v, pad, seed, rate)
    grads = flash_chunked_attention_bwd(q, k, v, pad, out, lse, grad, seed,
                                        rate)
    want_out, want_lse = flash_chunked_attention_fwd_reference(
        q, k, v, pad, seed, rate)
    want_grads = flash_chunked_attention_bwd_reference(
        q, k, v, pad, want_out, want_lse, grad, seed, rate)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(lse), torch.isfinite(want_lse))
    real = torch.isfinite(want_lse)
    assert (lse[real] - want_lse[real]).abs().max().item() <= 1e-5
    pairs = {"out": (out, want_out),
             **dict(zip(("dq", "dk", "dv"), zip(grads, want_grads)))}
    assert all(torch.isfinite(a).all() for a, _ in pairs.values())
    if dtype == torch.float32:
        for name, (got, want) in pairs.items():
            tol = 1e-5 if name == "out" else 1e-4
            assert (got - want).abs().max().item() <= tol, name
    else:
        scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed, rate,
                                   out=want_out)
        for name, (got, want) in pairs.items():
            assert bf16_k_needed(got, want, scales[name]) <= BF16_K, name


@pytest.mark.cuda
def test_flash_launch_counters():
    """One forward launch per call, one backward per backward (its two
    launches count once), none for a backward under no_grad, each on the
    counters of its regime; shapes past fits_chunked (the tiled kernels
    6–8) raise on the card too."""
    _needs_card()
    counters = ("fwd_launches", "bwd_launches", "chunk_fwd_launches",
                "chunk_bwd_launches")
    for length, want in ((64, (2, 1, 0, 0)), (577, (0, 0, 2, 1))):
        q, k, v, _, pad = _flash_inputs(2, length, torch.bfloat16, True,
                                        heads=16)
        before = [getattr(flash_tower_attention, c) for c in counters]
        qg = q.detach().requires_grad_(True)
        flash_tower_attention(qg, k, v, pad, 1, 0.1).float().sum().backward()
        with torch.no_grad():
            flash_tower_attention(q, k, v, pad, 1, 0.1)
        torch.cuda.synchronize()
        assert tuple(getattr(flash_tower_attention, c) - b
                     for c, b in zip(counters, before)) == want
        assert qg.grad is not None and torch.isfinite(qg.grad).all()
    long = torch.zeros(1, 2, 4096, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="6–8"):
        flash_tower_attention(long, long, long, None, 0, 0.1)
