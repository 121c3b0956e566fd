"""The shape rule that picks the body of the tiled backward kernels 7/8
(`tiled_variant`) and the TMA eligibility of its operands, checked on the
CPU against the shapes they are given.  The kernels themselves run only on
the card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from leccr_torch.ops.flash_attention import (
    flash_tiled_attention_dkv,
    flash_tiled_attention_dq,
    flash_tower_attention,
    regime,
    tiled_variant,
    tma_eligible,
)


def _path(b, h, l, dh, dtype=torch.bfloat16):
    """[B, L, H, Dh] storage seen as [B, H, L, Dh], as the towers pass it."""
    return torch.zeros(b, l, h, dh, dtype=dtype).transpose(1, 2)


def _packed(b, h, l, dh=64):
    """q, k, v as strided views of one [B, L, 3, H, Dh] projection."""
    x = torch.zeros(b, l, 3, h, dh, dtype=torch.bfloat16)
    return tuple(x[:, :, i].transpose(1, 2) for i in range(3))


def _unaligned(b, h, l, dh=64):
    """The path layout in storage one element past a 16-byte boundary."""
    buf = torch.zeros(b * l * h * dh + 1, dtype=torch.bfloat16)[1:]
    return buf.view(b, l, h, dh).transpose(1, 2)


@pytest.mark.parametrize("case,want", [
    ("path-bf16-64", "wgmma"),
    ("packed-qkv", "wgmma"),
    ("contiguous-bhld", "wgmma"),
    ("f32", "scalar"),
    ("dh32", "scalar"),
    ("dh128", "scalar"),
    ("unaligned-q", "scalar"),
    ("unaligned-out", "scalar"),
    ("expanded-g", "scalar"),
])
def test_tiled_variant(case, want):
    b, h, l = 2, 4, 300
    dtype, dh = torch.bfloat16, 64
    if case == "f32":
        dtype = torch.float32
    elif case == "dh32":
        dh = 32
    elif case == "dh128":
        dh = 128
    q, k, v = (_path(b, h, l, dh, dtype) for _ in range(3))
    g, out = _path(b, h, l, dh, dtype), _path(b, h, l, dh, dtype)
    if case == "packed-qkv":
        q, k, v = _packed(b, h, l)
    elif case == "contiguous-bhld":
        q, k, v, g, out = (torch.zeros(b, h, l, dh, dtype=dtype)
                           for _ in range(5))
    elif case == "unaligned-q":
        q = _unaligned(b, h, l)
    elif case == "unaligned-out":
        out = _unaligned(b, h, l)
    elif case == "expanded-g":
        g = torch.zeros(1, 1, 1, dh, dtype=dtype).expand(b, h, l, dh)
    assert tiled_variant(q, k, v, g, out) == want


def test_tiled_variant_at_the_high_resolution_shape():
    """ViT-L/14 @728 (2705 tokens, 16 heads) in bf16 is tiled, and every
    operand the step passes takes the wgmma variant; the same tower's
    packed projection at 2561 tokens, just past fits_chunked, too."""
    q, k, v = (_path(1, 16, 2705, 64) for _ in range(3))
    assert regime(q, k) == "tiled"
    assert tiled_variant(q, k, v, _path(1, 16, 2705, 64)) == "wgmma"
    q, k, v = _packed(1, 16, 2561)
    assert regime(q, k) == "tiled"
    assert tiled_variant(q, k, v, _path(1, 16, 2561, 64)) == "wgmma"


@pytest.mark.parametrize("sl,sh,sb,sd,eligible", [
    (16 * 64, 64, 16 * 64 * 2705, 1, True),     # [B, L, H, Dh] storage
    (64, 2705 * 64, 16 * 2705 * 64, 1, True),   # [B, H, L, Dh] contiguous
    (3 * 16 * 64, 64, 3 * 16 * 64 * 2705, 1, True),  # packed q/k/v
    (16 * 64 + 4, 64, 16 * 64 * 2705, 1, False),  # rows 8 bytes apart
    (16 * 64, 0, 16 * 64 * 2705, 1, False),       # a broadcast head dim
    (16 * 64, 64, 16 * 64 * 2705, 2, False),      # strided features
])
def test_tma_eligible(sl, sh, sb, sd, eligible):
    """TMA boxes need a 16-byte aligned base, unit feature stride and
    positive 16-byte multiple outer strides (element strides of L, H, B
    and Dh of a [B, H, L, Dh] view)."""
    base = torch.zeros(2 * 16 * 2705 * 64 * 3 + 64, dtype=torch.bfloat16)
    t = base.as_strided((2, 16, 2705, 64), (sb, sh, sl, sd))
    assert tma_eligible(t) == eligible


def test_cpu_tensors_count_no_wgmma_launch():
    """On CPU tensors the wrappers run the plain versions: no launch is
    counted, on either counter of kernels 7/8."""
    torch.manual_seed(0)
    b, h, l = 1, 2, 40
    q, k, v, g = (torch.randn(b, l, h, 64).bfloat16().transpose(1, 2)
                  for _ in range(4))
    out = torch.randn(b, l, h, 64).bfloat16().transpose(1, 2)
    lse = torch.randn(b, h, l)
    counters = ("tiled_dq_launches", "tiled_dkv_launches",
                "tiled_dq_wgmma_launches", "tiled_dkv_wgmma_launches")
    before = [getattr(flash_tower_attention, c) for c in counters]
    _, delta = flash_tiled_attention_dq(q, k, v, None, out, lse, g, 3, 0.1)
    flash_tiled_attention_dkv(q, k, v, None, lse, delta, g, 3, 0.1)
    assert [getattr(flash_tower_attention, c) for c in counters] == before
