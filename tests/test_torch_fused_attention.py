"""The port's fused cross-attention (plain version + CPU wrapper) against
the JAX package's Pallas kernel run in interpret mode.

Shapes are the three (Lq, Lk) pairs of the embed_images path scaled down:
(n_queries, caption tokens), (visual tokens, n_queries) and
(n_queries, visual tokens).  Tolerances: f32 atol 1e-5 (the same f32 math,
summed in another order); bf16 inputs the same 1e-5 plus 1 bf16 ulp of the
output (both sides round an f32 result to bf16 once, so f32 noise can move
it by one ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.ops.fused_cross_attention import (
    fused_cross_attention,
    fused_cross_attention_reference,
)
from leccr_tpu.ops.pallas_attention import \
    fused_cross_attention as jax_fused_cross_attention

SHAPES = [(4, 20), (15, 4), (4, 15)]  # (Lq, Lk) at B=3, H=4, Dh=16
B, H, DH = 3, 4, 16


def _inputs(lq, lk, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, lq, DH).astype(np.float32)
    k = rs.randn(B, H, lk, DH).astype(np.float32)
    v = rs.randn(B, H, lk, DH).astype(np.float32)
    pad = rs.rand(B, lk) < 0.3
    pad[0] = True  # a fully padded row: the mean of v, never NaN
    pad[1] = False
    return q, k, v, pad


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    _, exp = np.frexp(np.abs(x))
    return np.ldexp(1.0, exp - 8)


@pytest.mark.parametrize("lq,lk", SHAPES)
def test_reference_matches_pallas_f32(lq, lk):
    q, k, v, pad = _inputs(lq, lk, seed=lq * 100 + lk)
    want = np.asarray(jax_fused_cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
        True))
    got = fused_cross_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pad)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the fully padded row is the uniform mean of v
    np.testing.assert_allclose(
        got[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True), got[0].shape),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("lq,lk", SHAPES)
def test_reference_matches_pallas_bf16(lq, lk):
    q, k, v, pad = _inputs(lq, lk, seed=7 + lq + lk)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_fused_cross_attention(
        qj, kj, vj, jnp.asarray(pad), True)).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = fused_cross_attention_reference(qt, kt, vt, torch.from_numpy(pad))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= 1e-5 + _bf16_ulp(want)).all()


def test_no_mask_matches_pallas():
    q, k, v, _ = _inputs(4, 20, seed=3)
    want = np.asarray(jax_fused_cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True))
    got = fused_cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cpu_wrapper_runs_plain_version_without_launching():
    q, k, v, pad = _inputs(15, 4, seed=11)
    args = [torch.from_numpy(x) for x in (q, k, v, pad)]
    before = fused_cross_attention.launches
    got = fused_cross_attention(*args)
    assert fused_cross_attention.launches == before == 0
    torch.testing.assert_close(got, fused_cross_attention_reference(*args),
                               rtol=0, atol=0)
    # int padding masks (nonzero = pad) are accepted like bool ones
    got_int = fused_cross_attention(*args[:3], args[3].to(torch.int32))
    torch.testing.assert_close(got_int, got, rtol=0, atol=0)


def test_head_split_views_need_no_copy():
    """The kernel takes any outer strides (the attention module passes
    [B, L, H, Dh] storage viewed as [B, H, L, Dh])."""
    q, k, v, pad = _inputs(4, 20, seed=5)
    views = [torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert not views[0].is_contiguous()
    got = fused_cross_attention(*views, torch.from_numpy(pad))
    want = fused_cross_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(pad))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_raises():
    q, k, v, pad = _inputs(4, 20, seed=9)
    qt = torch.from_numpy(q).requires_grad_(True)
    out = fused_cross_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(pad))
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()


@pytest.mark.parametrize("case", ["dtype", "shape", "mask", "stride", "mixed"])
def test_wrapper_rejects_bad_inputs(case):
    q, k, v, pad = (torch.from_numpy(x) for x in _inputs(4, 20, seed=1))
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "shape":
        k = k[:, :, :, :8]
    elif case == "mask":
        pad = pad[:, :5]
    elif case == "stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        k = k.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        fused_cross_attention(q, k, v, pad)
