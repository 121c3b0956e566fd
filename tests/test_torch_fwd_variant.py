"""The variant of the streamed forwards (kernels 4 and 6): the q, k, v
views that the long-sequence and high-resolution steps' CLIP tower builds
take the wgmma body (`tiled_variant`), other dtypes, head dims and
unaligned views the scalar one, and CPU tensors count no launch.  Also
chip_smoke's reading of ptxas' report, which holds every wgmma kernel to
0 spill bytes.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import pytest
import torch

import chip_smoke
from leccr_torch.models import clip
from leccr_torch.ops.attention import set_compute_dtype
from leccr_torch.ops.flash_attention import (
    flash_chunked_attention_fwd,
    flash_tiled_attention_fwd,
    flash_tower_attention,
    regime,
    tiled_variant,
)

WIDTH, HEADS = 1024, 16  # ViT-L/14: 16 heads of 64


@pytest.mark.parametrize("length,want_regime", [(577, "chunked"),
                                                (2705, "tiled")])
def test_step_views_take_the_wgmma_forward(monkeypatch, length, want_regime):
    """ViT-L/14 @336 (577 tokens: kernel 4) and @728 (2705: kernel 6) at
    full width in bf16: the views of CLIP's packed in-projection that the
    block hands to flash_tower_attention are TMA-eligible, so the forward
    runs the wgmma body."""
    seen = []

    def record(q, k, v, mask, seed, rate, head_offset, num_heads):
        # a dense block's call spans all of the layer's heads
        assert (head_offset, num_heads) == (0, HEADS)
        seen.append((regime(q, k, num_heads), tiled_variant(q, k, v),
                     q.dtype))
        return torch.zeros_like(q)

    monkeypatch.setattr(clip, "flash_tower_attention", record)
    attn = clip._CLIPAttention(WIDTH, HEADS, fused=True)
    set_compute_dtype(attn, torch.bfloat16)
    x = torch.zeros(1, length, WIDTH, dtype=torch.bfloat16)
    with torch.no_grad():
        attn(x, deterministic=False)
    assert seen == [(want_regime, "wgmma", torch.bfloat16)]


def _path(b, h, l, dh, dtype=torch.bfloat16):
    """[B, L, H, Dh] storage seen as [B, H, L, Dh], as the towers pass it."""
    return torch.zeros(b, l, h, dh, dtype=dtype).transpose(1, 2)


def _unaligned(b, h, l, dh=64):
    """The path layout in storage one element past a 16-byte boundary."""
    buf = torch.zeros(b * l * h * dh + 1, dtype=torch.bfloat16)[1:]
    return buf.view(b, l, h, dh).transpose(1, 2)


@pytest.mark.parametrize("case,want", [
    ("path-bf16-64", "wgmma"),
    ("f32", "scalar"),
    ("dh32", "scalar"),
    ("unaligned-k", "scalar"),
    ("unaligned-v", "scalar"),
])
def test_forward_variant(case, want):
    """The forward's variant from q, k, v alone: bf16 at Dh = 64 in the
    path's layout is "wgmma"; f32, Dh 32 and an unaligned bf16 view are
    "scalar"."""
    b, h, l = 2, 16, 577
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    dh = 32 if case == "dh32" else 64
    q, k, v = (_path(b, h, l, dh, dtype) for _ in range(3))
    if case == "unaligned-k":
        k = _unaligned(b, h, l)
    elif case == "unaligned-v":
        v = _unaligned(b, h, l)
    assert tiled_variant(q, k, v) == want


@pytest.mark.parametrize("fwd", [flash_chunked_attention_fwd,
                                 flash_tiled_attention_fwd],
                         ids=["kernel4", "kernel6"])
def test_cpu_tensors_count_no_forward_launch(fwd):
    """On CPU tensors the forwards run their plain versions: no launch is
    counted, on the forward counters or their wgmma ones."""
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 40, 2, 64).bfloat16().transpose(1, 2)
               for _ in range(3))
    counters = ("chunk_fwd_launches", "tiled_fwd_launches",
                "chunk_fwd_wgmma_launches", "tiled_fwd_wgmma_launches")
    before = [getattr(flash_tower_attention, c) for c in counters]
    out, lse = fwd(q, k, v, None, 3, 0.1)
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    assert [getattr(flash_tower_attention, c) for c in counters] == before


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122chunk_fwd_wgmma_kernelENS_7FwdMapsENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122chunk_fwd_wgmma_kernelENS_7FwdMapsENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 1536 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121tiled_dq_wgmma_kernelENS_6WgMapsENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121tiled_dq_wgmma_kernelENS_6WgMapsENS_6ParamsE
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 1536 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    """chip_smoke.ptxas_report finds each wgmma kernel by its name inside
    the mangled one, with its registers and spill bytes, and None for a
    kernel the log does not show."""
    got = chip_smoke.ptxas_report(_PTXAS_LOG, chip_smoke.WGMMA_KERNELS)
    assert got["chunk_fwd_wgmma_kernel"] == {
        "registers": 168, "spill_stores": 0, "spill_loads": 0}
    assert got["tiled_dq_wgmma_kernel"] == {
        "registers": 168, "spill_stores": 12, "spill_loads": 16}
    assert got["tiled_fwd_wgmma_kernel"] is None
    assert got["tiled_dkv_wgmma_kernel"] is None
    assert got["chunk_bwd_dq_wgmma_kernel"] is None
