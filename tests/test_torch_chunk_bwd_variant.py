"""The chunked backward (kernel 5) on the wgmma passes: the views that the
long-sequence step hands it take the wgmma variant (`tiled_variant` of q,
k, v, g and out, the pick `_launch_chunk_bwd` makes), other dtypes, head
dims and unaligned views the scalar one, CPU tensors count no launch, and
its plain version still equals the JAX package's `_chunk_bwd_kernel` in
interpret mode at ragged lengths, with key padding and dropout, at an even
head count (dropout head group 2) and an odd one (1).  The kernels
themselves run only on the card (tests/test_torch_cuda.py).

Tolerances (f32): gradients rtol 1e-4 / atol 5e-5, as
tests/test_torch_flash_chunked.py (products of three f32 sums taken in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.models import clip
from leccr_torch.ops import flash_attention as port
from leccr_torch.ops.attention import set_compute_dtype
from leccr_torch.ops.flash_attention import (
    chunk_head_group,
    flash_chunked_attention_bwd,
    flash_chunked_attention_bwd_reference,
    flash_tower_attention,
    regime,
    tiled_variant,
)
from leccr_tpu.ops import flash_attention as jfa

WIDTH, HEADS = 1024, 16  # ViT-L/14: 16 heads of 64


def test_step_views_take_the_wgmma_backward(monkeypatch):
    """ViT-L/14 @336 (577 tokens) at full width in bf16: the q, k, v views
    of CLIP's packed in-projection, the saved output and the gradient that
    autograd hands the chunked backward are all TMA-eligible, so kernel 5
    runs the wgmma passes."""
    seen = []

    def record(q, k, v, mask, out, lse, g, seed, rate, heads):
        assert heads == (0, HEADS)  # a dense block's: all the layer's heads
        seen.append((regime(q, k), tiled_variant(q, k, v, g, out), q.dtype))
        return tuple(torch.zeros_like(t) for t in (q, k, v))

    monkeypatch.setitem(port._RUNNERS, "chunked",
                        (port._RUNNERS["chunked"][0], record))
    attn = clip._CLIPAttention(WIDTH, HEADS, fused=True)
    set_compute_dtype(attn, torch.bfloat16)
    x = torch.zeros(1, 577, WIDTH, dtype=torch.bfloat16)
    attn(x, deterministic=False).float().sum().backward()
    assert seen == [("chunked", "wgmma", torch.bfloat16)]


def _path(b, h, l, dh, dtype=torch.bfloat16):
    """[B, L, H, Dh] storage seen as [B, H, L, Dh], as the towers pass it."""
    return torch.zeros(b, l, h, dh, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("case,want", [
    ("path-bf16-64", "wgmma"),
    ("f32", "scalar"),
    ("dh32", "scalar"),
    ("unaligned-q", "scalar"),
    ("odd-stride-g", "scalar"),
])
def test_backward_variant(case, want):
    """Kernel 5's variant from q, k, v, g and out alone: bf16 at Dh = 64 in
    the path's layout is "wgmma"; f32, Dh 32, a view not aligned to 16
    bytes and a g whose outer strides are odd (rows 130 bytes apart) are
    "scalar"."""
    b, h, l = 2, 16, 577
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    dh = 32 if case == "dh32" else 64
    q, k, v, g, out = (_path(b, h, l, dh, dtype) for _ in range(5))
    if case == "unaligned-q":
        buf = torch.zeros(b * l * h * dh + 1, dtype=dtype)[1:]
        q = buf.view(b, l, h, dh).transpose(1, 2)
    elif case == "odd-stride-g":
        g = torch.zeros(b, l, h, dh + 1, dtype=dtype)[..., :dh]
        g = g.transpose(1, 2)
        assert g.stride(-1) == 1 and g.stride(1) % 2 == 1
    assert tiled_variant(q, k, v, g, out) == want


def test_cpu_tensors_count_no_backward_launch():
    """On CPU tensors kernel 5's wrapper runs the plain version: no launch
    is counted, on chunk_bwd_launches or chunk_bwd_wgmma_launches."""
    torch.manual_seed(0)
    q, k, v, g, out = (torch.randn(1, 40, 2, 64).bfloat16().transpose(1, 2)
                       for _ in range(5))
    lse = torch.randn(1, 2, 40)
    counters = ("chunk_bwd_launches", "chunk_bwd_wgmma_launches")
    before = [getattr(flash_tower_attention, c) for c in counters]
    dq, dk, dv = flash_chunked_attention_bwd(q, k, v, None, out, lse, g, 3,
                                             0.1)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert [getattr(flash_tower_attention, c) for c in counters] == before


@pytest.mark.parametrize("h", [4, 3])
@pytest.mark.parametrize("length", [65, 129])
def test_reference_matches_interpret(monkeypatch, length, h):
    """The plain chunked backward against JAX's `_chunk_bwd_kernel` in
    interpret mode (through `_flash_bwd`, forced into the chunked regime)
    at a ragged length, key padding with a fully padded row, dropout 0.1,
    from the same forward residuals (JAX's out and lse); H = 4 takes
    dropout head group 2, H = 3 group 1."""
    monkeypatch.setattr(jfa, "fits_vmem", lambda *a: False)
    assert chunk_head_group(h) == (2 if h % 2 == 0 else 1)
    rs = np.random.RandomState(length + h)
    b, d, seed, rate = 2, 16, 91, 0.1
    q, k, v, g = (rs.randn(b, h, length, d).astype(np.float32)
                  for _ in range(4))
    pad = (rs.rand(b, length) < 0.3).astype(np.int32)
    pad[0] = 1  # a fully padded row: zero gradients
    pad[1] = 0
    out, res = jfa._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                              jnp.asarray(pad), seed, rate, True)
    want = jfa._flash_bwd(rate, True, res, jnp.asarray(g))[:3]
    lse = np.array(res[5])[:, :, :length]
    got = flash_chunked_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(pad != 0), torch.from_numpy(np.array(out)),
        torch.from_numpy(lse), torch.from_numpy(g), seed, rate)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=5e-5,
                                   err_msg=name)
        assert (a[0] == 0).all(), name
