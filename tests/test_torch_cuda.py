"""Tests that need an NVIDIA GPU: the CUDA kernels have no CPU mode.

The fused cross-attention kernel (eval; its few-queries, few-keys,
key-tiles and general bodies), the single-block flash tower-attention kernels 2/3, the
chunked kernels 4/5 and the tiled kernels 6/7/8 (training, forward and
backward; 4-8 on their wgmma variant in bf16, the backward passes on their
persistent schedule), and the fused InfoNCE kernels 9-11 against their
plain versions on the card, and the launch counters that show a path went
through them.

They import neither JAX nor the JAX package, so they also run where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from chip_smoke import (
    BF16_K,
    INT8_CARD_SHAPES,
    WGMMA_OF,
    bf16_k_needed,
    chunk_bwd_masks,
    flash_term_scales,
    fwd_masks,
    infonce_check,
    infonce_deterministic,
    int8_matches_cpu,
    path_layout,
    single_masks,
    tc_counts,
    tiled_masks,
    tp_kernel_check,
    wgmma_counts,
    wgmma_launched,
)
from leccr_torch.ops import infonce
from leccr_torch.ops.flash_attention import (
    _launch_tiled_dkv,
    _launch_tiled_dq,
    chunk_head_group,
    flash_chunked_attention_bwd,
    flash_chunked_attention_bwd_reference,
    flash_chunked_attention_fwd,
    flash_chunked_attention_fwd_reference,
    flash_tiled_attention_bwd,
    flash_tiled_attention_bwd_reference,
    flash_tiled_attention_fwd,
    flash_tiled_attention_fwd_reference,
    flash_tower_attention,
    flash_tower_attention_bwd,
    flash_tower_attention_bwd_reference,
    flash_tower_attention_fwd,
    flash_tower_attention_fwd_reference,
    head_group,
    keep_mask,
    single_block_variant,
    tile_keep_mask,
    tiled_variant,
)
from leccr_torch.ops.fused_cross_attention import (
    fused_body,
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


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,aligned,body", [
    (1, 200, True, "few_queries"), (16, 200, True, "few_queries"),
    (4, 145, True, "few_queries"), (145, 1, True, "few_keys"),
    (145, 16, True, "few_keys"), (4, 4, True, "few_keys"),
    (17, 4, True, "few_keys"), (145, 17, True, "general"),
    (4, 200, False, "general")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bodies_match_plain_version(lq, lk, aligned, body, dtype):
    """Each body of kernel 1 at the edges of its class (one query, 16
    queries, one key, 16 keys, 17 queries against 4 keys; 17 keys and an
    unaligned view on the general body) against its plain version, B=8,
    H=8, Dh=64, head-split views, a fully padded row (the mean of v): f32
    atol 1e-5, bf16 atol 1e-5 plus 1 bf16 ulp of the output.  The launch
    counts on the body `fused_body` picks."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(lq * 7 + lk)
    q, k, v = (torch.randn(8, n, 8, 64, device="cuda", generator=g)
               .to(dtype) for n in (lq, lk, lk))
    if not aligned:  # rows one element past a 16-byte boundary
        buf = k.new_empty(k.numel() + 1)[1:]
        k = buf.view(k.shape).copy_(k)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    pad = torch.rand(8, lk, device="cuda", generator=g) < 0.3
    pad[0] = True
    pad[1] = False
    assert fused_body(lq, lk, 64, q.element_size(), aligned) == body
    before = dict(fused_cross_attention.launches_by_body)
    got = fused_cross_attention(q, k, v, pad).float()
    assert {n: c - before[n] for n, c in
            fused_cross_attention.launches_by_body.items()
            if c != before[n]} == {body: 1}
    want = fused_cross_attention_reference(q, k, v, pad).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    mean_v = v[0].float().mean(dim=1, keepdim=True).expand(-1, lq, -1)
    assert (got[0] - mean_v).abs().max().item() <= 1e-2
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert ((got - want).abs() <= 1e-5 + _bf16_ulp(want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh", [
    (2, 200, 512), (32, 2, 512), (2, 32, 512), (1, 1, 512), (17, 33, 512),
    (4, 16, 512), (5, 17, 256), (2, 200, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_key_tiles_body_matches_plain_version(lq, lk, dh, dtype):
    """The key-tiles body (wide heads) at the video model's shapes (Dh =
    512: slots x caption tokens, frames x slots, slots x frames) and the
    edges of its tiles (one key; 16, 17 and 33 keys; 17 rows: two row
    tiles), B=8, H=8, head-split views, a fully padded row (the mean of
    v): f32 atol 1e-5, bf16 atol 1e-5 plus 1 bf16 ulp of the output."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(lq * 13 + lk + dh)
    q, k, v = (torch.randn(8, n, 8, dh, device="cuda", generator=g)
               .to(dtype).transpose(1, 2) for n in (lq, lk, lk))
    pad = torch.rand(8, lk, device="cuda", generator=g) < 0.3
    pad[0] = True
    pad[1] = False
    assert fused_body(lq, lk, dh, q.element_size(), True) == "key_tiles"
    before = dict(fused_cross_attention.launches_by_body)
    got = fused_cross_attention(q, k, v, pad).float()
    assert {n: c - before[n] for n, c in
            fused_cross_attention.launches_by_body.items()
            if c != before[n]} == {"key_tiles": 1}
    want = fused_cross_attention_reference(q, k, v, pad).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    mean_v = v[0].float().mean(dim=1, keepdim=True).expand(-1, lq, -1)
    assert (got[0] - mean_v).abs().max().item() <= 1e-2
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert ((got - want).abs() <= 1e-5 + _bf16_ulp(want)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [16, 3])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 129, 577])
def test_persistent_chunked_backward_matches_plain_version(length, heads):
    """Kernel 5 on the wgmma passes' persistent schedule (bf16, Dh = 64,
    the path's layout) at ragged lengths around the 64-row tiles and
    128-row items, key padding with a fully padded row, dropout 0.1, 16
    heads (head group 2) and 3 (head group 1), batch 2 (fewer items than
    SMs) and 24 (more): the bf16 term-sum tolerance of the chunked rules;
    its dq-pass and dk/dv-pass dropout masks, read back bit for bit, equal
    the plain hash."""
    _needs_card()
    seed, rate = 77, 0.1
    for batch in (2, 24):
        q, k, v, grad, pad = _flash_inputs(batch, length, torch.bfloat16,
                                           True, seed=length, heads=heads)
        before = wgmma_counts()
        out, lse = flash_chunked_attention_fwd(q, k, v, pad, seed, rate)
        assert tiled_variant(q, k, v, grad, out) == "wgmma"
        grads = flash_chunked_attention_bwd(q, k, v, pad, out, lse, grad,
                                            seed, rate)
        assert wgmma_launched(before, chunk_fwd=1, chunk_bwd=1)
        want_out, want_lse = flash_chunked_attention_fwd_reference(
            q, k, v, pad, seed, rate)
        want_grads = flash_chunked_attention_bwd_reference(
            q, k, v, pad, want_out, want_lse, grad, seed, rate)
        torch.cuda.synchronize()
        assert all((d[0] == 0).all() for d in grads)
        scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed, rate,
                                   out=want_out)
        for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
            assert torch.isfinite(got).all()
            assert bf16_k_needed(got, want, scales[name]) <= BF16_K, name
    want = tile_keep_mask(seed, 2, heads, length, length, rate,
                          device="cuda", hg=chunk_head_group(heads)) != 0
    for got in chunk_bwd_masks(2, heads, length, torch.bfloat16, rate, seed):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("length,masked,rate", [(2705, False, 0.0),
                                                (1000, True, 0.1)])
def test_tiled_backward_schedules_agree(length, masked, rate):
    """Kernels 7 and 8 on the persistent grid and on one block per item
    give the same bits: each output row is summed by one block in the same
    order either way."""
    _needs_card()
    q, k, v, grad, pad = _flash_inputs(2, length, torch.bfloat16, masked,
                                       heads=16)
    mask = None if pad is None else pad.contiguous()
    out, lse = flash_tiled_attention_fwd(q, k, v, pad, 5, rate)
    results = []
    for persistent in (False, True):
        dq, delta = _launch_tiled_dq(q, k, v, mask, out, lse, grad, 5, rate,
                                     persistent)
        dk, dv = _launch_tiled_dkv(q, k, v, mask, lse, delta, grad, 5, rate,
                                   persistent)
        results.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*results):
        assert torch.equal(a, b)


def _flash_inputs(batch, length, dtype, masked, seed=0, heads=12, dh=64,
                  packed=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    # the path's layout: [B, L, H, Dh] storage seen as [B, H, L, Dh]
    q, k, v, grad = (torch.randn(batch, length, heads, dh, device="cuda",
                                 generator=g).to(dtype).transpose(1, 2)
                     for _ in range(4))
    if packed:  # q, k, v as strided views of one [B, L, 3, H, Dh] projection
        qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], dim=2)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
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
@pytest.mark.parametrize("batch,heads,lq,lk,aligned", [
    (4, 12, 1, 1, True), (4, 12, 17, 17, True), (4, 12, 145, 145, True),
    (4, 12, 168, 168, True), (16, 12, 64, 64, True), (2, 1, 700, 64, True),
    (2, 2, 300, 300, True), (16, 12, 64, 64, False)],
    ids=["L1", "L17", "L145", "L168", "text", "q700-k64", "L300-h2",
         "text-unaligned"])
def test_single_block_variants_match_plain_versions(batch, heads, lq, lk,
                                                    aligned):
    """Kernels 2/3 in bf16 at heads of 64 against their plain versions, with
    key padding, a fully padded row and dropout 0.1, each on the variant
    single_block_variant names: the tensor-core one at 12 heads at ragged
    lengths up to the longest within fits_vmem (168; a chunk of 32 keys is
    rounded up past Lk, and those keys must count for nothing), at the text
    shape and at 700 queries against 64 keys (22 query chunks in the dk/dv
    pass); the scalar one past the tensor-core forward's 192 keys (2 heads,
    300 tokens) and for the text shape with its rows 2 bytes off 16-byte
    alignment.  Tolerances as test_flash_kernels_match_plain_versions (lse
    atol 1e-5; out and grads within 1e-5 + BF16_K bf16 ulps of their term
    sums)."""
    _needs_card()
    rate = 0.1
    g = torch.Generator(device="cuda").manual_seed(lq + lk)
    q, k, v, grad = (path_layout(torch.randn(
        batch, n, heads, 64, device="cuda", generator=g).to(torch.bfloat16),
        aligned) for n in (lq, lk, lk, lq))
    pad = torch.rand(batch, lk, device="cuda", generator=g) < 0.3
    pad[0] = True  # a fully padded row: the mean of v over the Lk keys
    pad[1] = False
    tc = aligned and lk <= 192
    assert single_block_variant(q, k, v, grad) == ("tc" if tc else "scalar")
    seed = 77
    before = tc_counts()
    out, lse = flash_tower_attention_fwd(q, k, v, pad, seed, rate)
    grads = flash_tower_attention_bwd(q, k, v, pad, lse, grad, seed, rate)
    launched = tuple(a - b for a, b in zip(tc_counts(), before))
    assert launched == ((1, 1) if tc else (0, 0))
    want_out, want_lse = flash_tower_attention_fwd_reference(
        q, k, v, pad, seed, rate)
    want_grads = flash_tower_attention_bwd_reference(
        q, k, v, pad, want_lse, grad, seed, rate)
    torch.cuda.synchronize()
    assert (lse - want_lse).abs().max().item() <= 1e-5
    pairs = {"out": (out, want_out),
             **dict(zip(("dq", "dk", "dv"), zip(grads, want_grads)))}
    assert all(torch.isfinite(a).all() for a, _ in pairs.values())
    scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed, rate)
    for name, (got, want) in pairs.items():
        assert bf16_k_needed(got, want, scales[name]) <= BF16_K, name


@pytest.mark.cuda
def test_single_block_masks_are_the_plain_hash():
    """The dropout masks that kernel 2 and kernel 3's two passes apply, read
    back bit for bit over three key blocks (145 tokens), equal keep_mask."""
    _needs_card()
    want = keep_mask(7, 2, 12, 145, 145, 0.2, device="cuda") != 0
    for got in single_masks(2, 12, 145, torch.bfloat16, 0.2, 7):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 32])
@pytest.mark.parametrize("shape", ["vision", "text"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_kernels_match_plain_versions(shape, dtype, dh):
    """Kernels 4 and 5 against their plain versions: ViT-L/14 @336 (577
    tokens, 16 heads, no mask, rate 0) and the 200-token text bucket (key
    padding with a fully padded row, rate 0.1), batch cut to 4; bf16 at
    Dh=64 takes the wgmma kernels, every other case the scalar ones.
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
@pytest.mark.parametrize("regime,heads,length,world", [
    ("single", 12, 145, 4), ("chunked", 16, 577, 4),
    ("tiled", 16, 2705, 4), ("tiled", 12, 2705, 4)])
def test_kernels_on_a_rank_heads_equal_the_dense_heads(regime, heads, length,
                                                       world):
    """Tensor parallelism: each rank's heads through kernels 2-8 at its
    offset and the layer's H (dropout 0.1) equal the dense call's heads
    bit for bit, and the masks on rank 1's heads, read back, are the plain
    hash at the offset (head_group(16) = 8 and head_group(12) = 6 span two
    ranks of 4 and 3 heads)."""
    _needs_card()
    checks = tp_kernel_check("test", regime, 2, heads, length, False, world,
                             seed=11)
    assert checks["bit_equal"]


@pytest.mark.cuda
def test_flash_launch_counters():
    """One forward launch per call, one backward per backward (its two
    launches count once; the tiled dq and dk/dv launches count on their own
    counters), none for a backward under no_grad, each on the counters of
    its regime; shapes past fits_chunked (bf16 at 4096 tokens) take the
    tiled kernels 6-8 on the card."""
    _needs_card()
    counters = ("fwd_launches", "bwd_launches", "chunk_fwd_launches",
                "chunk_bwd_launches", "tiled_fwd_launches",
                "tiled_dq_launches", "tiled_dkv_launches")
    for length, want in ((64, (2, 1, 0, 0, 0, 0, 0)),
                         (577, (0, 0, 2, 1, 0, 0, 0)),
                         (4096, (0, 0, 0, 0, 2, 1, 1))):
        q, k, v, _, pad = _flash_inputs(2, length, torch.bfloat16, True,
                                        heads=16)
        before = [getattr(flash_tower_attention, c) for c in counters]
        before_tc, before_wgmma = tc_counts(), wgmma_counts()
        qg = q.detach().requires_grad_(True)
        flash_tower_attention(qg, k, v, pad, 1, 0.1).float().sum().backward()
        with torch.no_grad():
            flash_tower_attention(q, k, v, pad, 1, 0.1)
        torch.cuda.synchronize()
        assert tuple(getattr(flash_tower_attention, c) - b
                     for c, b in zip(counters, before)) == want
        # bf16 at Dh = 64: every single-block launch is a tensor-core one,
        # every launch of kernels 4, 6, 7, 8 a wgmma one
        assert tuple(a - b for a, b in zip(tc_counts(), before_tc)) == want[:2]
        assert wgmma_launched(before_wgmma, *(want[i] for i in WGMMA_OF))
        assert qg.grad is not None and torch.isfinite(qg.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("length,packed", [(2705, False), (2561, True)])
@pytest.mark.parametrize("dh", [64, 32])
@pytest.mark.parametrize("heads", [16, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_kernels_match_plain_versions(dtype, heads, dh, length,
                                            packed):
    """Kernels 6, 7 and 8 against their plain versions at 2705 tokens (ViT-L
    /14 @728, not a multiple of 64) and at 2561, just past fits_chunked,
    with q, k and v strided views of one packed [B, L, 3, H, Dh]
    projection; key padding, a fully padded row and dropout 0.1, batch 2,
    16 heads (head group 8) and 12 (head group 6).  bf16 at Dh=64 takes the
    wgmma kernels 6-8, every other case the scalar ones.  Tolerances as
    kernels 4/5's, with the tiled head group in the term sums."""
    _needs_card()
    q, k, v, grad, pad = _flash_inputs(2, length, dtype, True, heads=heads,
                                       dh=dh, packed=packed)
    seed, rate = 99, 0.1
    before = wgmma_counts()
    out, lse = flash_tiled_attention_fwd(q, k, v, pad, seed, rate)
    want_variant = ("wgmma" if dtype == torch.bfloat16 and dh == 64
                    else "scalar")
    assert tiled_variant(q, k, v, grad, out) == want_variant
    grads = flash_tiled_attention_bwd(q, k, v, pad, out, lse, grad, seed,
                                      rate)
    n = int(want_variant == "wgmma")
    assert wgmma_launched(before, 0, n, n, n)
    want_out, want_lse = flash_tiled_attention_fwd_reference(
        q, k, v, pad, seed, rate)
    want_grads = flash_tiled_attention_bwd_reference(
        q, k, v, pad, want_out, want_lse, grad, seed, rate)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(lse), torch.isfinite(want_lse))
    real = torch.isfinite(want_lse)
    assert (lse[real] - want_lse[real]).abs().max().item() <= 1e-5
    assert (out[0] == 0).all() and all((d[0] == 0).all() for d in grads)
    pairs = {"out": (out, want_out),
             **dict(zip(("dq", "dk", "dv"), zip(grads, want_grads)))}
    assert all(torch.isfinite(a).all() for a, _ in pairs.values())
    if dtype == torch.float32:
        for name, (got, want) in pairs.items():
            tol = 1e-5 if name == "out" else 1e-4
            assert (got - want).abs().max().item() <= tol, name
    else:
        scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed, rate,
                                   out=want_out, hg=head_group(heads))
        for name, (got, want) in pairs.items():
            assert bf16_k_needed(got, want, scales[name]) <= BF16_K, name


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [16, 12, 3])
def test_tiled_masks_are_the_plain_hash(heads):
    """The dropout masks kernels 6, 7 and 8 apply, read back bit for bit,
    equal the plain tile hash at head_group(H); in bf16 every launch of
    kernels 6, 7 and 8 that reads them back is a wgmma one."""
    _needs_card()
    want = tile_keep_mask(7, 2, heads, 300, 300, 0.2, device="cuda",
                          hg=head_group(heads)) != 0
    before = wgmma_counts()
    for got in tiled_masks(2, heads, 300, torch.bfloat16, 0.2, 7):
        assert torch.equal(got, want)
    blocks = -(-300 // 64)  # one launch of each per 64-key block
    assert wgmma_launched(before, 0, blocks + 1, blocks, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [16, 12])
def test_chunked_forward_mask_is_the_plain_hash(heads):
    """The dropout mask kernel 4 applies on its wgmma variant, read back bit
    for bit, equals the plain tile hash at the chunked head group (2)."""
    _needs_card()
    want = tile_keep_mask(7, 2, heads, 300, 300, 0.2, device="cuda",
                          hg=chunk_head_group(heads)) != 0
    before = wgmma_counts()
    got = fwd_masks(flash_chunked_attention_fwd, 2, heads, 300,
                    torch.bfloat16, 0.2, 7)
    assert torch.equal(got, want)
    assert wgmma_launched(before, chunk_fwd=-(-300 // 64))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["chunked", "tiled"])
@pytest.mark.parametrize("heads", [16, 12])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,lk,masked", [
    (577, 577, False), (2705, 2705, False), (200, 200, True),
    (129, 129, False), (100, 700, True), (33, 1, False)])
def test_wgmma_forward_matches_plain_version(lq, lk, masked, rate, heads,
                                             kernel):
    """The wgmma forward body as kernel 4 (head group 2) and kernel 6
    (head_group(H)) against its plain version, bf16 at Dh = 64 in the
    path's layout, batch 2: ViT-L/14 @336 (577 tokens) and @728 (2705),
    200 tokens with key padding and a fully padded row (out 0, lse -inf),
    129 (one key past a 128-key tile), 100 queries against 700 padded
    keys, and 33 queries against one key.  lse atol 1e-5; out within
    1e-5 + BF16_K bf16 ulps of its term sums."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(lq + lk)
    q, k, v, grad = (path_layout(torch.randn(
        2, n, heads, 64, device="cuda", generator=g).to(torch.bfloat16))
        for n in (lq, lk, lk, lq))
    pad = None
    if masked:
        pad = torch.rand(2, lk, device="cuda", generator=g) < 0.3
        pad[0] = True  # a fully padded row: out 0, lse -inf
        pad[1] = False
    seed = 31
    fwd, ref, hg = {
        "chunked": (flash_chunked_attention_fwd,
                    flash_chunked_attention_fwd_reference,
                    chunk_head_group(heads)),
        "tiled": (flash_tiled_attention_fwd,
                  flash_tiled_attention_fwd_reference, head_group(heads)),
    }[kernel]
    assert tiled_variant(q, k, v) == "wgmma"
    before = wgmma_counts()
    out, lse = fwd(q, k, v, pad, seed, rate)
    assert wgmma_launched(before, int(kernel == "chunked"),
                          int(kernel == "tiled"))
    want_out, want_lse = ref(q, k, v, pad, seed, rate)
    torch.cuda.synchronize()
    real = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), real)
    assert (lse[real] - want_lse[real]).abs().max().item() <= 1e-5
    if masked:
        assert (out[0] == 0).all() and not real[0].any()
    assert torch.isfinite(out).all()
    scales = flash_term_scales(q, k, v, pad, want_lse, grad, seed, rate,
                               out=want_out, hg=hg)
    assert bf16_k_needed(out, want_out, scales["out"]) <= BF16_K


@pytest.mark.cuda
@pytest.mark.parametrize("e", [4, 68, 256])
@pytest.mark.parametrize("m,n,ids", [(4096, 4096, "arange"),
                                     (1000, 1000, "ragged"),
                                     (256, 32768, "ring"),
                                     (33, 4097, "half"),
                                     (1, 1, "arange")])
def test_infonce_kernels_match_plain_versions(m, n, ids, e):
    """Kernels 9, 10 and 11 against their plain versions (chip_smoke's
    `infonce_check`: inv_temp 1/0.07 as a device tensor; lse and pos_sum
    within 1e-5 of max(1, |x|), pos_cnt exact, dq_raw and dk_raw within
    1e-4 of their largest element) at E = 4, 68 and 256: the large-batch
    step's [4096]², a ragged [1000]² with every id three times, a ring
    block [256] x [32768] whose q ids are a subset of k's with some rows
    that have no positive (launched on more than one split), [33] x [4097]
    with every id twice (a ragged last tile, a last split of one column)
    and [1] x [1]; one counted launch each."""
    _needs_card()
    before = (infonce.stats_launches, infonce.dq_launches,
              infonce.dk_launches)
    _, _, pc, errs, grid = infonce_check(m, n, ids, e=e)
    assert (infonce.stats_launches, infonce.dq_launches,
            infonce.dk_launches) == tuple(b + 1 for b in before)
    assert errs["pos_cnt"] == 0
    assert errs["lse"] <= 1e-5 and errs["pos_sum"] <= 1e-5, errs
    assert errs["dq"] <= 1e-4 and errs["dk"] <= 1e-4, errs
    if ids == "ring":
        assert (pc == 0).any() and (pc == 1).any()
        assert grid["stats"][1] > 1 and grid["dq"][1] > 1, grid


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,ids", [(4096, 4096, "arange"),
                                     (256, 32768, "ring")])
def test_infonce_kernels_are_deterministic(m, n, ids):
    """Two calls of each of kernels 9, 10 and 11 give the same bits at
    [4096]² (each on several splits, on an H100) and at the ring block
    (kernel 11 on one): no atomics, and the merges go in split order."""
    _needs_card()
    args, lse, pc = infonce_check(m, n, ids)[:3]
    assert infonce_deterministic(args, lse, pc)


@pytest.mark.cuda
def test_infonce_loss_gradients_through_kernels():
    """infonce_loss on the card (kernels 9-11, two launches of each: one
    per direction) against the same loss on the CPU (the plain versions):
    value within 1e-5 of max(1, |loss|), the gradients in a, b and temp
    within 1e-4 of their largest element."""
    _needs_card()
    g = torch.Generator().manual_seed(5)
    a, b = (torch.nn.functional.normalize(torch.randn(700, 256, generator=g),
                                          dim=-1) for _ in range(2))
    idx = torch.randint(0, 300, (700,), generator=g)
    temp = torch.tensor(0.07)
    results = {}
    for device in ("cpu", "cuda"):
        leaves = [t.to(device).requires_grad_(True) for t in (a, b, temp)]
        before = infonce.stats_launches
        loss = infonce.infonce_loss(*leaves, idx.to(device))
        results[device] = (loss.detach().cpu(), [
            x.cpu() for x in torch.autograd.grad(loss, leaves)])
        assert infonce.stats_launches - before == (2 if device == "cuda"
                                                   else 0)
    (loss, grads), (want, want_grads) = results["cuda"], results["cpu"]
    assert (loss - want).abs().item() <= 1e-5 * max(1.0, want.abs().item())
    for got, ref in zip(grads, want_grads):
        assert ((got - ref).abs().max() <= 1e-4 * ref.abs().max()).item()


@pytest.mark.cuda
def test_device_prefetch_copies_batches_to_the_card():
    """device_prefetch's side-stream copies: every array arrives on the
    card equal to the host batch (counts pass through), batches stay
    valid after later copies were queued, and an exception upstream is
    raised in the consumer after the batches before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned side-stream copy path")
    import numpy as np

    from leccr_torch.data.pipeline import device_prefetch

    rs = np.random.RandomState(0)
    host = [({"vision": rs.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8),
              "flip": rs.rand(8) < 0.5,
              "ids": rs.randint(0, 999, (8, 32)).astype(np.int32)}, k)
            for k in range(6)]

    class Broken(Exception):
        pass

    def source(fail_at=None):
        for k, item in enumerate(host):
            if k == fail_at:
                raise Broken(k)
            yield item

    got = list(device_prefetch(source(), torch.device("cuda"), depth=3))
    torch.cuda.synchronize()
    assert [count for _, count in got] == list(range(6))
    for (batch, _), (want, _) in zip(got, host):
        for key, value in want.items():
            assert batch[key].device.type == "cuda"
            assert np.array_equal(batch[key].cpu().numpy(), value), key
    seen = []
    with pytest.raises(Broken):
        for batch, count in device_prefetch(source(fail_at=4),
                                            torch.device("cuda")):
            seen.append(count)
    assert seen == [0, 1, 2, 3]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,e", INT8_CARD_SHAPES)
def test_int8_serving_on_the_card_equals_the_cpu(b, n, e):
    """`torch._int_mm`'s CUDA shape rules met by `_int8_mm`'s zero
    padding: quantization, int8 sums and dequantized scores on the card
    equal the CPU's bit for bit (and those equal the JAX package's,
    tests/test_torch_serve_index.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's CUDA path")
    int8_matches_cpu(b, n, e)
