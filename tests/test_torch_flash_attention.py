"""The port's flash tower attention (plain versions + CPU wrapper + autograd
Function) against the JAX package's single-block Pallas kernels run in
interpret mode, whose dropout mask is the same counter hash.

Tolerances (f32): out and lse atol 1e-5 (the same f32 math summed in
another order); gradients atol 5e-5 / rtol 1e-4 (products of three such
sums).  bf16: 4 bf16 ulps at the scale of the largest output, since both
sides round p (and ds) to bf16 and f32 noise can land a rounding the other
way.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLASH_SHAPES, flash_kernel_of
from leccr_torch.ops import flash_attention as port
from leccr_torch.ops.flash_attention import (
    fits_vmem,
    flash_tower_attention,
    flash_tower_attention_bwd,
    flash_tower_attention_bwd_reference,
    flash_tower_attention_fwd,
    flash_tower_attention_fwd_reference,
    keep_mask,
    single_block_variant,
)
from leccr_tpu.ops import flash_attention as jfa

B, H, D = 3, 2, 16


def _inputs(lq, lk, seed, masked=True):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, lq, D).astype(np.float32)
    k = rs.randn(B, H, lk, D).astype(np.float32)
    v = rs.randn(B, H, lk, D).astype(np.float32)
    pad = None
    if masked:
        pad = (rs.rand(B, lk) < 0.3).astype(np.int32)
        pad[0] = 1  # a fully padded row
        pad[1] = 0
    return q, k, v, pad


def _jax_fwd(q, k, v, pad, seed, rate, dtype=jnp.float32):
    out, res = jfa._flash_fwd(
        *(jnp.asarray(x, dtype) for x in (q, k, v)),
        None if pad is None else jnp.asarray(pad), seed, rate, True)
    return np.asarray(out.astype(jnp.float32)), np.asarray(res[5])


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(
        dtype if x.dtype == np.float32 else torch.int32)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.2, 7), (0.2, 123456)])
@pytest.mark.parametrize("masked", [True, False])
def test_forward_matches_interpret(rate, seed, masked):
    q, k, v, pad = _inputs(12, 12, seed=seed + int(masked), masked=masked)
    want_out, want_lse = _jax_fwd(q, k, v, pad, seed, rate)
    out, lse = flash_tower_attention_fwd_reference(
        _t(q), _t(k), _t(v), _t(pad), seed, rate)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
    if masked and rate == 0.0:  # the fully padded row is the mean of v
        np.testing.assert_allclose(
            out[0].numpy(), np.broadcast_to(v[0].mean(1, keepdims=True),
                                            out[0].shape), atol=1e-5)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.2, 7)])
@pytest.mark.parametrize("lq,lk", [(12, 12), (9, 20)])
def test_grads_match_jax_grad(rate, seed, lq, lk):
    """jax.grad of sum(out · cos(out)) through the JAX custom VJP against
    the port's autograd Function on CPU (its plain backward), with key
    padding and a fully padded row."""
    q, k, v, pad = _inputs(lq, lk, seed=lq + lk + seed)

    def loss(q, k, v):
        out = jfa.flash_tower_attention(q, k, v, jnp.asarray(pad), seed,
                                        rate, True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = flash_tower_attention(qt, kt, vt, _t(pad), seed, rate)
    (out * torch.cos(out)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=5e-5)


def test_bf16_plain_versions_match_interpret():
    q, k, v, pad = _inputs(12, 12, seed=5)
    seed, rate = 11, 0.2
    want_out, _ = _jax_fwd(q, k, v, pad, seed, rate, jnp.bfloat16)

    def loss(q, k, v):
        out = jfa.flash_tower_attention(q, k, v, jnp.asarray(pad), seed,
                                        rate, True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    want_grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    qt, kt, vt = (_t(x, torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    out = flash_tower_attention(qt, kt, vt, _t(pad), seed, rate)
    assert out.dtype == torch.bfloat16
    (out.float() ** 2).sum().backward()
    pairs = [(out, want_out)] + [
        (g, np.asarray(w.astype(jnp.float32)))
        for g, w in zip((qt.grad, kt.grad, vt.grad), want_grads)]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=0, atol=4 * ulp)


def test_keep_mask_is_the_interpret_hash():
    """Bit for bit the numpy replica of the JAX interpret-mode mask."""
    from test_flash_attention import _interpret_keep_mask

    for seed, rate in ((7, 0.2), (2 ** 31 - 2, 0.1), (0, 0.5)):
        want = _interpret_keep_mask(seed, 4, 3, 5, 7, rate)
        got = keep_mask(seed, 4, 3, 5, 7, rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_backward_plain_version_is_the_hand_vjp():
    """The plain backward called directly (the function the kernel is held
    against) equals the Function's gradients, and the dropout mask it
    regenerates is the forward's."""
    q, k, v, pad = (_t(x) for x in _inputs(10, 10, seed=3))
    g = torch.from_numpy(np.random.RandomState(4).randn(B, H, 10, D)
                         .astype(np.float32))
    out, lse = flash_tower_attention_fwd(q, k, v, pad, 99, 0.3)
    grads = flash_tower_attention_bwd(q, k, v, pad, lse, g, 99, 0.3)
    want = flash_tower_attention_bwd_reference(q, k, v, pad, lse, g, 99, 0.3)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    flash_tower_attention(qt, kt, vt, pad, 99, 0.3).backward(g)
    for a, b in zip((qt.grad, kt.grad, vt.grad), grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_path_launches_nothing_and_no_grad_saves_nothing():
    q, k, v, pad = (_t(x) for x in _inputs(8, 8, seed=1))
    fwd, bwd = (flash_tower_attention.fwd_launches,
                flash_tower_attention.bwd_launches)
    qt = q.clone().requires_grad_(True)
    flash_tower_attention(qt, k, v, pad, 5, 0.1).sum().backward()
    with torch.no_grad():
        out = flash_tower_attention(qt, k, v, pad, 5, 0.1)
    assert out.grad_fn is None
    torch.testing.assert_close(
        out, flash_tower_attention_fwd_reference(q, k, v, pad, 5, 0.1)[0],
        rtol=0, atol=0)
    assert (flash_tower_attention.fwd_launches,
            flash_tower_attention.bwd_launches) == (fwd, bwd) == (0, 0)


def test_head_split_views_need_no_copy():
    """BERT passes [B, L, H, Dh] storage seen as [B, H, L, Dh]; CLIP passes
    chunks of the packed in_proj output (row stride 3W)."""
    q, k, v, pad = (_t(x) for x in _inputs(8, 8, seed=2))
    want = flash_tower_attention_fwd_reference(q, k, v, pad, 3, 0.2)[0]
    bert = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    packed = torch.cat([x.transpose(1, 2).reshape(B, 8, H * D)
                        for x in (q, k, v)], dim=-1)
    clip = [t.view(B, 8, H, D).transpose(1, 2)
            for t in packed.chunk(3, dim=-1)]
    for views in (bert, clip):
        assert not views[0].is_contiguous()
        got = flash_tower_attention(*views, pad, 3, 0.2)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_fits_vmem_is_the_jax_dispatch_and_longer_shapes_raise():
    """The dispatch is the JAX package's: a 200-token H=12 shape is past
    fits_vmem and computes through the chunked regime (kernels 4/5), which
    the single-block wrappers (kernels 2/3) refuse, and a shape past
    fits_chunked (4096 tokens in bf16) no longer raises: it computes through
    the tiled regime (kernels 6-8) and equals its plain version."""
    for h, lq, lk, d in ((12, 145, 145, 64), (12, 128, 128, 64),
                         (12, 169, 169, 64), (12, 170, 170, 64),
                         (16, 577, 577, 64), (1, 640, 640, 16)):
        assert fits_vmem(h, lq, lk, d) == jfa.fits_vmem(h, lq, lk, d)
    q, k, v = (torch.from_numpy(np.random.RandomState(i).randn(1, 12, 200, 64)
                                .astype(np.float32)) for i in range(3))
    assert port.regime(q, k) == "chunked"
    assert port.regime(q[:, :, :145], k[:, :, :145]) == "single"
    out = flash_tower_attention(q, k, v, None, 3, 0.1)
    want = port.flash_chunked_attention_fwd_reference(q, k, v, None, 3, 0.1)
    torch.testing.assert_close(out, want[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="past fits_vmem"):
        flash_tower_attention_fwd(q, k, v, None, 3, 0.1)
    with pytest.raises(ValueError, match="past fits_vmem"):
        flash_tower_attention_bwd(q, k, v, None, want[1], q, 3, 0.1)
    long = torch.from_numpy(np.random.RandomState(5).randn(1, 2, 4096, 64)
                            .astype(np.float32)).to(torch.bfloat16)
    assert port.regime(long, long) == "tiled"
    got = flash_tower_attention(long, long, long, None, 0, 0.1)
    want = port.flash_tiled_attention_fwd_reference(long, long, long, None,
                                                    0, 0.1)
    torch.testing.assert_close(got, want[0], rtol=0, atol=0)


@pytest.mark.parametrize("case", ["dtype", "shape", "mask", "rate", "stride"])
def test_wrapper_rejects_bad_inputs(case):
    q, k, v, pad = (_t(x) for x in _inputs(8, 8, seed=1))
    rate = 0.1
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "shape":
        k = k[..., :8]
    elif case == "mask":
        pad = pad[:, :5]
    elif case == "rate":
        rate = 1.0
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        flash_tower_attention(q, k, v, pad, 0, rate)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A tensor on another device than the CPU goes to the kernels (or
    raises); the plain versions are for CPU tensors only."""
    q, k, v, pad = (_t(x).to("meta") for x in _inputs(8, 8, seed=1))
    monkeypatch.setattr(port, "flash_tower_attention_fwd_reference",
                        lambda *a: pytest.fail("plain version taken"))
    with pytest.raises(ValueError, match="no flash_tower_attention kernel"):
        flash_tower_attention(q, k, v, pad, 0, 0.1)


def _path_view(b, h, length, d=64, dtype=torch.bfloat16, offset=0):
    """An empty [B, H, L, D] view of [B, L, H, D] storage (the towers'
    layout), starting `offset` elements into its buffer."""
    buf = torch.empty(b * length * h * d + offset, dtype=dtype)
    return buf[offset:].view(b, length, h, d).transpose(1, 2)


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: s[0])
def test_path_shapes_take_the_tensor_core_variant(shape):
    """Every call of kernels 2/3 that the train steps make (chip_smoke's
    FLASH_SHAPES, in bf16 and the towers' layout) runs on the Hopper
    kernels (wgmma and TMA): the views are TMA-eligible."""
    _, b, h, length, *_ = shape
    q, k, v, g = (_path_view(b, h, length) for _ in range(4))
    assert fits_vmem(h, length, length, 64)
    assert all(port.tma_eligible(t) for t in (q, k, v, g))
    assert single_block_variant(q, k, v) == "wgmma"
    assert single_block_variant(q, k, v, g) == "wgmma"


@pytest.mark.parametrize("case", ["f32", "dh32", "row_stride", "offset"])
def test_other_calls_take_the_scalar_variant(case):
    """f32 (TF32 would break its tolerance), head dims other than 64 and
    rows that are not 16-byte aligned keep the scalar kernels."""
    kw = {"f32": {"dtype": torch.float32}, "dh32": {"d": 32},
          "row_stride": {}, "offset": {"offset": 1}}[case]
    q = _path_view(2, 12, 64, **kw)
    if case == "row_stride":  # rows 65 elements apart: 130 bytes
        q = torch.empty(2, 64, 12, 65, dtype=torch.bfloat16)[..., :64]
        q = q.transpose(1, 2)
    k = _path_view(2, 12, 64, **{n: x for n, x in kw.items()
                                 if n != "offset"})
    assert single_block_variant(q, k, k) == "scalar"
    assert single_block_variant(k, q, k) == "scalar"


def test_views_tma_cannot_read_take_the_scalar_variant():
    """A view whose rows are 16-byte aligned but which TMA cannot read (a
    batch broadcast by expand: outer stride 0) takes the scalar kernels,
    on either side of the call; its materialised copy takes the Hopper
    ones."""
    q = _path_view(2, 12, 64)
    k = _path_view(1, 12, 64).expand(2, -1, -1, -1)
    assert k.stride(0) == 0 and not port.tma_eligible(k)
    assert port._aligned((q, k), 2)
    assert single_block_variant(q, k, k) == "scalar"
    assert single_block_variant(k, q, q) == "scalar"
    assert single_block_variant(q, q, q, k) == "scalar"
    assert single_block_variant(q, k.contiguous(), q) == "wgmma"


@pytest.mark.parametrize("lk", [1, 17, 64, 65, 145, 192, 193])
def test_key_count_alone_bounds_the_hopper_variant(lk):
    """Against 64 queries, every key count up to TC_MAX_KEYS (192) takes
    the Hopper kernels and 193 the scalar ones: their shared memory fits a
    block at every key count they take (csrc/flash_single_layout.h asserts
    it at build time), so no other figure decides."""
    q, k = _path_view(2, 12, 64), _path_view(2, 12, lk)
    want = "wgmma" if lk <= port.TC_MAX_KEYS else "scalar"
    assert port.TC_MAX_KEYS == 192
    assert single_block_variant(q, k, k) == want
    assert single_block_variant(q, k, k, q) == want


@pytest.mark.parametrize("heads", [12, 2])
def test_longest_single_block_length_takes_a_variant(heads):
    """The longest self-attention length within fits_vmem takes a variant
    without raising: 168 at 12 heads, within the Hopper kernels' 192 keys,
    the Hopper one; 469 at 2 heads, past those
    192 keys, the scalar one (which raises at launch where its shared
    memory does not fit); so do cross shapes past the keys' limit."""
    longest = max(n for n in range(1, 1000) if fits_vmem(heads, n, n, 64))
    assert not fits_vmem(heads, longest + 1, longest + 1, 64)
    q = _path_view(1, heads, longest)
    want = "wgmma" if longest <= port.TC_MAX_KEYS else "scalar"
    assert (longest, single_block_variant(q, q, q, q)) == (
        {12: 168, 2: 469}[heads], want)
    lk = max(n for n in range(1, 8000) if fits_vmem(1, 1, n, 64))
    q, k = _path_view(1, 1, 1), _path_view(1, 1, lk)
    assert single_block_variant(q, k, k) == "scalar"
    # many queries against few keys: the queries stream through the Hopper
    # kernels, whose shared memory depends on the keys alone, so 800 take
    # them as 768 do (the mma.sync dk/dv pass staged every query row and
    # sent 800 to the scalar kernels)
    k = _path_view(1, 1, 64)
    for lq, want in ((768, "wgmma"), (800, "wgmma")):
        q = _path_view(1, 1, lq)
        assert fits_vmem(1, lq, 64, 64)
        assert single_block_variant(q, k, k) == want


def test_bf16_plain_versions_match_interpret_at_flagship_width():
    """The plain versions the card holds the tensor-core kernels to, in
    bf16 at the flagship's ragged width (L = 145, Dh = 64) with key padding,
    a fully padded example and dropout 0.1, against the JAX kernels in
    interpret mode: forward and gradients within 4 bf16 ulps of the largest
    output."""
    rs = np.random.RandomState(21)
    b, h, length, d = 3, 2, 145, 64
    q, k, v = (rs.randn(b, h, length, d).astype(np.float32)
               for _ in range(3))
    pad = (rs.rand(b, length) < 0.3).astype(np.int32)
    pad[0] = 1  # a fully padded example: out is the mean of v
    pad[1] = 0
    seed, rate = 17, 0.1
    want_out, _ = _jax_fwd(q, k, v, pad, seed, rate, jnp.bfloat16)

    def loss(q, k, v):
        out = jfa.flash_tower_attention(q, k, v, jnp.asarray(pad), seed,
                                        rate, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.cos(
            out.astype(jnp.float32)))

    want_grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    qt, kt, vt = (_t(x, torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    out = flash_tower_attention(qt, kt, vt, _t(pad), seed, rate)
    (out.float() * torch.cos(out.float())).sum().backward()
    pairs = [(out, want_out)] + [
        (g, np.asarray(w.astype(jnp.float32)))
        for g, w in zip((qt.grad, kt.grad, vt.grad), want_grads)]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=0, atol=4 * ulp)


def test_profiled_kernel_names_map_to_their_kernels():
    """chip_smoke's profile sums kernels 2/3 by their function names, the
    scalar variant's and the Hopper one's (templates) alike, kernels
    4-8 in their scalar and wgmma variants (kernel 5's and kernels 7/8's
    wrappers of the shared wgmma passes apart), kernels 9-11 with their
    merge passes, and keeps kernels 4-11 and library kernels apart."""
    ns = "(anonymous namespace)"
    names = {
        f"void {ns}::fwd_kernel<__nv_bfloat16, 64>({ns}::Params)":
            "single_fwd",
        f"void {ns}::single_fwd_wgmma_kernel<10>({ns}::SbMaps, "
        f"{ns}::Params)": "single_fwd",
        f"void {ns}::bwd_dq_kernel<float, 64>({ns}::Params)": "single_bwd",
        f"void {ns}::bwd_dkv_kernel<__nv_bfloat16, 32>({ns}::Params)":
            "single_bwd",
        f"void {ns}::single_bwd_wgmma_kernel<3>({ns}::SbMaps, "
        f"{ns}::Params)": "single_bwd",
        f"void {ns}::single_bwd_wgmma_kernel<1>({ns}::SbMaps, "
        f"{ns}::Params)": "single_bwd",
        f"void {ns}::chunk_fwd_wgmma_kernel({ns}::FwdMaps, {ns}::Params)":
            "chunked",
        f"void {ns}::chunk_bwd_dq_wgmma_kernel({ns}::WgMaps, {ns}::Params)":
            "chunked",
        f"void {ns}::chunk_bwd_dkv_wgmma_kernel({ns}::WgMaps, {ns}::Params)":
            "chunked",
        f"void {ns}::chunk_bwd_dkv_kernel<float, 64>({ns}::Params)":
            "chunked",
        f"void {ns}::tiled_fwd_wgmma_kernel({ns}::FwdMaps, {ns}::Params)":
            "tiled_fwd",
        f"void {ns}::tiled_fwd_kernel<float, 64>({ns}::Params)": "tiled_fwd",
        f"void {ns}::tiled_dq_kernel<float, 64>({ns}::Params)": "tiled_dq",
        f"void {ns}::tiled_dkv_kernel<__nv_bfloat16, 32>({ns}::Params)":
            "tiled_dkv",
        f"void {ns}::tiled_dq_wgmma_kernel({ns}::WgMaps, {ns}::Params)":
            "tiled_dq",
        f"void {ns}::tiled_dkv_wgmma_kernel({ns}::WgMaps, {ns}::Params)":
            "tiled_dkv",
        f"void {ns}::infonce_bwd_kernel<false>({ns}::Args)": "infonce",
        f"void {ns}::infonce_stats_merge_kernel(const float *, int, int, "
        f"float *, float *, float *)": "infonce",
        f"void {ns}::infonce_bwd_merge_kernel(const float4 *, int, "
        f"long long, float4 *)": "infonce",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>(int, Fn)": None,
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": None,
        "Memcpy DtoD (Device -> Device)": None,
    }
    for name, family in names.items():
        assert flash_kernel_of(name) == family, name
