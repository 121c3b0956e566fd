"""The port's fused cross-attention (plain version + CPU wrapper) against
the JAX package's Pallas kernel run in interpret mode.

Shapes are the three (Lq, Lk) pairs of the embed_images path scaled down:
(n_queries, caption tokens), (visual tokens, n_queries) and
(n_queries, visual tokens), the edges of the kernel's bodies (one
query, one key, 16 and 17 keys), and the video model's head dim Dh = 512
(the wide bodies') at its slots, frames and caption tokens, with the
wide key-ranges body's split-and-merge rule in plain form
(`wide_split_reference`) where a whole split is padded.  Tolerances: f32
atol 1e-5 (the same f32 math, summed in another order); bf16 inputs the
same 1e-5 plus 1 bf16 ulp
of the output (both sides round an f32 result to bf16 once, so f32 noise
can move it by one ulp).  Also the shape rule that picks the body
(`fused_body`) and the key-split plan (`wide_split_plan`); the bodies
themselves run only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.ops.fused_cross_attention import (
    FEW,
    WIDE_BLOCK_ROWS,
    WIDE_MIN_WARP_KEYS,
    WIDE_SPLIT_MIN_WALK,
    WIDE_WARPS,
    fused_body,
    fused_cross_attention,
    fused_cross_attention_reference,
    wide_rows,
    wide_split_plan,
    wide_split_reference,
)
from leccr_tpu.ops.pallas_attention import \
    fused_cross_attention as jax_fused_cross_attention

SHAPES = [(4, 20), (15, 4), (4, 15)]  # (Lq, Lk) at B=3, H=4, Dh=16
EDGES = [(1, 20), (15, 1), (15, 16), (15, 17)]  # one query, one key, FEW
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


@pytest.mark.parametrize("lq,lk", EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_at_body_edges(lq, lk, dtype):
    """The plain version against the Pallas kernel (interpret mode) at the
    edges of the kernel's bodies, with a fully padded row (the mean of v)
    and, at Lk = 1, rows whose one key is padded."""
    q, k, v, pad = _inputs(lq, lk, seed=31 + lq * 3 + lk)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_fused_cross_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(pad),
        True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = fused_cross_attention_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(pad))
    assert got.dtype == tdt
    got = got.float().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            got[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True),
                                    got[0].shape), rtol=0, atol=1e-5)
    else:
        assert (np.abs(got - want) <= 1e-5 + _bf16_ulp(want)).all()


@pytest.mark.parametrize("lq,lk,dh,item,aligned,want", [
    (4, 200, 64, 2, True, "few_queries"),   # slots x caption tokens
    (145, 4, 64, 2, True, "few_keys"),      # vision tokens x slots
    (4, 145, 64, 2, True, "few_queries"),   # slots x vision tokens
    (1, 200, 64, 2, True, "few_queries"),
    (FEW, 200, 64, 2, True, "few_queries"),
    (FEW + 1, 200, 64, 2, True, "general"),
    (145, 1, 64, 2, True, "few_keys"),
    (145, FEW, 64, 2, True, "few_keys"),
    (145, FEW + 1, 64, 2, True, "general"),
    (4, 4, 64, 2, True, "few_keys"),
    (4, 200, 64, 4, True, "few_queries"),   # f32: 16 chunks a row
    (145, 4, 64, 4, True, "few_keys"),
    (4, 200, 64, 2, False, "general"),      # an unaligned view
    (145, 4, 64, 2, False, "general"),
    (145, 4, 48, 2, True, "general"),       # 6 chunks of 16 bytes a row
    (4, 200, 16, 2, True, "general"),       # 2 chunks
    (4, 200, 256, 2, True, "wide_key_ranges"),  # 32 chunks: a wide head
    (145, 4, 12, 2, True, "general"),       # rows of 24 bytes
    (2, 200, 512, 2, True, "wide_key_ranges"),  # video: slots x caption
    (32, 2, 512, 2, True, "wide_query_rows"),   # frames x slots
    (2, 32, 512, 2, True, "wide_key_ranges"),   # slots x frames
    (2, 32, 512, 4, True, "wide_key_ranges"),
    (32, 1, 512, 4, True, "wide_query_rows"),   # the query-rows body's keys
    (32, 3, 512, 2, True, "wide_key_ranges"),   # one past them
    (32, 16, 512, 2, True, "wide_key_ranges"),
    (4, 200, 128, 4, True, "general"),      # f32 Dh = 128: 32 chunks
    (4, 200, 136, 2, True, "wide_key_ranges"),
    (2, 200, 512, 2, False, "general"),     # an unaligned view
    (2, 200, 1024, 2, True, "general"),     # past the wide bodies
])
def test_body_chooser(lq, lk, dh, item, aligned, want):
    """The body from the shapes alone: the image model's embed_images
    shapes take the few-queries and few-keys bodies, the video model's (Dh
    = 512) the wide ones (query rows for up to 2 keys, its slots, key
    ranges otherwise); the class edges (16 queries or keys in, 17 out),
    unaligned views, heads past 512 and rows of other than 4, 8 or 16
    chunks of 16 bytes up to Dh = 128 go to the general one."""
    assert fused_body(lq, lk, dh, item, aligned) == want


def test_cpu_wrapper_counts_no_body():
    """On CPU tensors no body's launch is counted."""
    q, k, v, pad = (torch.from_numpy(x) for x in _inputs(4, 20, seed=13))
    before = dict(fused_cross_attention.launches_by_body)
    fused_cross_attention(q, k, v, pad)
    assert fused_cross_attention.launches_by_body == before
    assert set(before) == {"general", "few_queries", "few_keys",
                           "wide_key_ranges", "wide_query_rows"}


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


@pytest.mark.parametrize("lq,lk", [(2, 40), (32, 2), (2, 32), (17, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_at_dh_512(lq, lk, dtype):
    """The plain version against the Pallas kernel (interpret mode) at the
    video model's Dh = 512 (what the wide bodies compute), with a fully
    padded row (the mean of v) and key padding; B = 2, H = 2."""
    rs = np.random.RandomState(lq * 41 + lk)
    q, k, v = (rs.randn(2, 2, n, 512).astype(np.float32)
               for n in (lq, lk, lk))
    pad = rs.rand(2, lk) < 0.3
    pad[0] = True
    pad[1, 0] = False
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_fused_cross_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(pad),
        True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = fused_cross_attention(tq, tk, tv, torch.from_numpy(pad))
    assert got.dtype == tdt and got.shape == (2, 2, lq, 512)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    mean_v = tv[0].float().mean(dim=1, keepdim=True).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            got[0], np.broadcast_to(mean_v, got[0].shape), rtol=0, atol=1e-5)
    else:
        assert (np.abs(got - want) <= 1e-5 + _bf16_ulp(want)).all()


@pytest.mark.parametrize("heads,lq,lk,sms,per_sm", [
    (512, 2, 200, 132, 4), (512, 2, 32, 132, 4), (16, 2, 200, 132, 4),
    (16, 2, 33, 132, 4), (8, 2, 1, 132, 4), (8, 2, 7, 132, 4),
    (16, 5, 199, 132, 2), (1, 1, 4097, 132, 4), (3, 17, 33, 8, 1),
    (100, 2, 200, 132, 4), (300, 2, 200, 132, 4), (8, 4, 100000, 132, 2)])
def test_wide_split_plan_covers_every_key(heads, lq, lk, sms, per_sm):
    """Every key lies in exactly one split and no split is empty; a split
    leaves each of a block's warps WIDE_MIN_WARP_KEYS keys unless there is
    one split, and one split leaves them more than WIDE_SPLIT_MIN_WALK;
    the grid never needs more waves than one split's would."""
    splits, keys = wide_split_plan(heads, lq, lk, sms, per_sm)
    assert splits >= 1 and keys >= 1
    assert (splits - 1) * keys < lk <= splits * keys
    if splits > 1:
        assert keys >= WIDE_WARPS * WIDE_MIN_WARP_KEYS
        assert -(-lk // WIDE_WARPS) > WIDE_SPLIT_MIN_WALK
    groups = heads * -(-lq // wide_rows(lq))
    slots = sms * per_sm
    waves = -(-groups * splits // slots)
    assert waves <= -(-groups // slots)


@pytest.mark.parametrize("lq,lk", [(2, 200), (32, 2), (2, 32)])
def test_wide_grid_at_the_video_path_shapes(lq, lk):
    """At the video model's shapes (B = 64, H = 8) on 132 SMs the grid runs
    in one whole wave: the key-ranges body (4 blocks an SM at 2 rows a
    warp, the card's occupancy calculator's figure in chip_smoke's grid
    lines) in one split, the query-rows body in 32-row blocks, each filling
    over 3/4 of the card's slots and never past them."""
    heads, slots = 64 * 8, 132 * 4
    if fused_body(lq, lk, 512, 2, True) == "wide_key_ranges":
        splits, keys = wide_split_plan(heads, lq, lk, 132, 4)
        assert (splits, keys) == (1, lk)  # B·H alone fills the card
        blocks = heads * splits * -(-lq // wide_rows(lq))
    else:
        blocks = heads * -(-lq // WIDE_BLOCK_ROWS)
    assert 3 * slots <= 4 * blocks <= 4 * slots


def test_wide_split_plan_splits_only_where_the_heads_leave_slots_empty():
    """One split where B·H alone fills the card (the path's 512 heads, and
    400) and where one split leaves a warp at most 8 keys (Lk ≤ 32); keys
    split over blocks where a few videos leave most of it idle (2 videos:
    16 heads; 1 video: 8), each warp keeping 2 keys."""
    assert wide_split_plan(512, 2, 200, 132, 4) == (1, 200)
    assert wide_split_plan(400, 2, 200, 132, 4) == (1, 200)
    assert wide_split_plan(16, 2, 200, 132, 4) == (25, 8)
    assert wide_split_plan(8, 2, 200, 132, 4) == (25, 8)
    assert wide_split_plan(16, 2, 33, 132, 4) == (3, 11)
    assert wide_split_plan(16, 2, 32, 132, 4) == (1, 32)
    assert wide_split_plan(64, 2, 32, 132, 4) == (1, 32)
    assert wide_split_plan(64, 2, 200, 132, 4) == (8, 25)


@pytest.mark.parametrize("lq,lk,splits,keys,padding", [
    (2, 40, 5, 8, "first_split"), (2, 33, 3, 11, "first_split"),
    (2, 33, 3, 11, "last_split"), (5, 199, 8, 25, "ragged"),
    (2, 40, 5, 8, "all"), (3, 17, 1, 17, "first_range")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_split_merge_matches_pallas(lq, lk, splits, keys, padding,
                                         dtype):
    """The key-ranges body's split-and-merge rule (`wide_split_reference`)
    against the Pallas kernel (interpret mode) at Dh = 512, B = 2, H = 2:
    a row whose first (or last) split is all padded and the rest not, a
    split count that does not divide the keys, a fully padded row (the
    mean of v: every split weighs 1) and one split with its first warp's
    range padded; the plain version agrees too.  f32 atol 1e-5, bf16 1e-5
    plus 1 bf16 ulp."""
    rs = np.random.RandomState(lq * 7 + lk + splits)
    q, k, v = (rs.randn(2, 2, n, 512).astype(np.float32)
               for n in (lq, lk, lk))
    pad = rs.rand(2, lk) < 0.3
    pad[1] = True  # every key padded
    pad[0] = False
    span = -(-keys // WIDE_WARPS) if padding == "first_range" else keys
    if padding in ("first_split", "first_range"):
        pad[0, :span] = True
    elif padding == "last_split":
        pad[0, (splits - 1) * keys:] = True
    elif padding == "all":
        pad[0] = True
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_fused_cross_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(pad),
        True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tpad = torch.from_numpy(pad)
    got = wide_split_reference(tq, tk, tv, tpad, splits, keys)
    plain = fused_cross_attention_reference(tq, tk, tv, tpad)
    assert got.dtype == tdt and got.shape == (2, 2, lq, 512)
    mean_v = tv[1].float().mean(dim=1, keepdim=True).numpy()
    for out in (got, plain):
        out = out.float().numpy()
        assert np.isfinite(out).all()
        if dtype == "float32":
            np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
            np.testing.assert_allclose(
                out[1], np.broadcast_to(mean_v, out[1].shape), rtol=0,
                atol=1e-5)
        else:
            assert (np.abs(out - want) <= 1e-5 + _bf16_ulp(want)).all()
