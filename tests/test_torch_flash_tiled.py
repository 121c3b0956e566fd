"""The port's tiled flash attention (kernels 6/7/8: plain versions, CPU
wrappers, autograd Function, dispatch) against the JAX package's tiled
Pallas kernels run in interpret mode.

Both sides are forced into the tiled regime at small shapes by
monkeypatching `fits_vmem` and `fits_chunked` to False, as
`tests/test_flash_attention.py` does for the JAX package.  Lengths that are
not tile multiples (Lq=150, Lk=200 → 256) with key padding and a fully
padded row; H=3 and H=4, where the tiled head group (`_head_group`: 3, 4)
differs from the chunked one (1, 2), so a mask of the wrong family fails.

Tolerances (f32): out and lse atol 1e-5 (the same f32 math summed in
another order); gradients rtol 1e-4 / atol 5e-5 (products of three such
sums).  bf16: 4 bf16 ulps at the scale of the largest dq against interpret
mode, and 0.45% of the largest dq against the f32 reference (the bound of
`tests/test_flash_attention.py`'s bf16 test).  Masks: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.ops import flash_attention as port
from leccr_torch.ops.flash_attention import (
    chunk_head_group,
    fits_chunked,
    fits_vmem,
    flash_tiled_attention_bwd,
    flash_tiled_attention_dkv,
    flash_tiled_attention_dq,
    flash_tiled_attention_fwd,
    flash_tower_attention,
    head_group,
    regime,
    tile_keep_mask,
)
from leccr_tpu.ops import flash_attention as jfa

B, D, LQ, LK = 2, 16, 150, 200


@pytest.fixture
def force_tiled(monkeypatch):
    for mod in (jfa, port):
        monkeypatch.setattr(mod, "fits_vmem", lambda *a: False)
        monkeypatch.setattr(mod, "fits_chunked", lambda *a, **k: False)


def _inputs(h, seed, lq=LQ, lk=LK):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, h, lq, D).astype(np.float32)
    k = rs.randn(B, h, lk, D).astype(np.float32)
    v = rs.randn(B, h, lk, D).astype(np.float32)
    pad = (rs.rand(B, lk) < 0.3).astype(np.int32)
    pad[0] = 1  # a fully padded row
    return q, k, v, pad


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype if x.dtype == np.float32
                                  else torch.int32)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("h", [3, 4])
def test_forward_matches_interpret(force_tiled, h, rate):
    """Kernel 6's plain version (out, lse) against `_tiled_fwd_kernel` in
    interpret mode, through the JAX caller's padding (`_flash_fwd`)."""
    q, k, v, pad = _inputs(h, seed=h)
    seed = 77
    want_out, res = jfa._flash_fwd(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(pad), seed, rate,
        True)
    want_lse = np.asarray(res[5])[:, :, :LQ]
    out, lse = flash_tiled_attention_fwd(_t(q), _t(k), _t(v), _t(pad), seed,
                                         rate)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
    assert np.isneginf(want_lse[0]).all() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("h", [3, 4])
def test_dq_dkv_match_interpret(force_tiled, h, rate):
    """Kernels 7 and 8's plain versions against `_tiled_dq_kernel` and
    `_tiled_dkv_kernel` in interpret mode, called on the JAX caller's
    padded operands (`_flash_bwd:872-887`) with the same out and lse."""
    q, k, v, pad = _inputs(h, seed=20 + h)
    g = np.random.RandomState(30 + h).randn(B, h, LQ, D).astype(np.float32)
    seed = 5
    out, lse = flash_tiled_attention_fwd(_t(q), _t(k), _t(v), _t(pad), seed,
                                         rate)
    dq, delta = flash_tiled_attention_dq(_t(q), _t(k), _t(v), _t(pad), out,
                                         lse, _t(g), seed, rate)
    dk, dv = flash_tiled_attention_dkv(_t(q), _t(k), _t(v), _t(pad), lse,
                                       delta, _t(g), seed, rate)

    def padded(x, n):
        return jfa._pad_axis(jnp.asarray(x), 2, n)

    lqp, lkp = 256, 256
    mask = padded(pad[:, None, :], lkp).at[:, :, LK:].set(1)
    want_delta = np.sum(g * out.numpy(), axis=-1)
    want = jfa._tiled_bwd_pallas(
        jfa._example_seeds(seed, B), padded(q, lqp), padded(k, lkp),
        padded(v, lkp), mask, padded(lse.numpy(), lqp),
        padded(want_delta, lqp), padded(g, lqp), rate, True)
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=0, atol=1e-5)
    for got, w, n in zip((dq, dk, dv), want, (LQ, LK, LK)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w)[:, :, :n],
                                   rtol=1e-4, atol=5e-5)
    for got in (dq, dk, dv):
        assert (got[0] == 0).all() and got[1].abs().max() > 0


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("h", [3, 4])
def test_grads_match_jax_grad(force_tiled, h, rate):
    """jax.grad of sum(out · cos(out)) through the JAX custom VJP (kernels
    6-8 in interpret mode) against the port's autograd Function on CPU."""
    q, k, v, pad = _inputs(h, seed=10 + h)
    seed = 5

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


def _tile_keep_np(seed, b, h, lq, lk, rate, hg):
    from test_flash_attention import _tile_keep_np as replica

    lqp, lkp = -(-lq // 128) * 128, -(-lk // 128) * 128
    return replica(seed, b, h, lqp, lkp, 128, 128, rate, hg)[:, :, :lq, :lk]


@pytest.mark.parametrize("h", [3, 4, 12])
def test_tile_keep_mask_is_the_interpret_hash(h):
    """Bit for bit the numpy replica of the JAX interpret-mode tile mask at
    the tiled head group `_head_group(H)`, on the padded tile grid cut back
    to (Lq, Lk)."""
    for seed, rate in ((7, 0.2), (2 ** 31 - 2, 0.1)):
        want = _tile_keep_np(seed, B, h, LQ, LK, rate, jfa._head_group(h))
        got = tile_keep_mask(seed, B, h, LQ, LK, rate, hg=head_group(h))
        np.testing.assert_array_equal(got.numpy(), want)


def test_tiled_mask_is_not_the_chunked_mask():
    """At H=4 the tiled group (4 heads) and the chunked one (2) hash other
    counters, so the masks differ; at H=2 both groups are 2 and they agree,
    which is why the tests above take H=3 and 4."""
    assert (head_group(4), chunk_head_group(4)) == (4, 2)
    tiled = tile_keep_mask(7, B, 4, LQ, LK, 0.2, hg=head_group(4))
    chunked = tile_keep_mask(7, B, 4, LQ, LK, 0.2)
    assert not torch.equal(tiled, chunked)
    assert torch.equal(tiled[:, :2], chunked[:, :2])  # head group 0, hh 0-1
    assert torch.equal(tile_keep_mask(7, B, 2, LQ, LK, 0.2, hg=head_group(2)),
                       tile_keep_mask(7, B, 2, LQ, LK, 0.2))


def test_head_group_is_the_jax_one():
    assert [head_group(h) for h in (16, 12, 3, 7, 11, 1)] == [8, 6, 3, 7, 1,
                                                              1]
    for h in range(1, 33):
        assert head_group(h) == jfa._head_group(h)


def _jax_regime(h, lq, lk, d, itemsize):
    if jfa.fits_vmem(h, lq, lk, d):
        return "single"
    if jfa.fits_chunked(h, lq, lk, d, itemsize):
        return "chunked"
    return "tiled"


def test_regime_is_the_jax_dispatch():
    """`regime` against `_flash_fwd`'s dispatch over a grid of shapes
    across both boundaries: f32 leaves the chunked regime at 1409 tokens
    and bf16 at 2561 (16 heads, Dh 64); odd H (chunked group 1) doubles the
    chunked limits."""
    for h in (1, 2, 3, 12, 16):
        for lq, lk in ((64, 64), (169, 169), (577, 577), (1408, 1408),
                       (1409, 1409), (2560, 2560), (2561, 2561),
                       (2705, 2705), (4000, 200), (200, 4000), (5000, 5000)):
            for d in (32, 64):
                for dtype in (torch.bfloat16, torch.float32):
                    q = torch.empty(1, h, lq, d, dtype=dtype, device="meta")
                    k = torch.empty(1, h, lk, d, dtype=dtype, device="meta")
                    assert regime(q, k) == _jax_regime(
                        h, lq, lk, d, q.element_size()), (h, lq, lk, d, dtype)
    for length, item, want in ((1408, 4, "chunked"), (1409, 4, "tiled"),
                               (2560, 2, "chunked"), (2561, 2, "tiled"),
                               (2705, 2, "tiled"), (1601, 4, "tiled"),
                               (1601, 2, "chunked")):
        assert not fits_vmem(16, length, length, 64)
        assert (want == "chunked") == fits_chunked(16, length, length, 64,
                                                   item)
    # odd H: one head per chunked group, so the budget holds twice the length
    assert fits_chunked(3, 4096, 4096, 64, 2)
    assert not fits_chunked(4, 4096, 4096, 64, 2)


def test_bf16_dq_accumulates_f32(force_tiled):
    """bf16 io over 5 key tiles: dq sums its per-tile partials in f32 and
    rounds once, as interpret mode does (tests/test_flash_attention.py:247),
    and stays within that test's bound of the f32 reference."""
    rs = np.random.RandomState(2)
    b, h, lq, lk, d = 2, 3, 130, 640, 16
    q, k, v = (rs.randn(b, h, n, d).astype(np.float32)
               for n in (lq, lk, lk))
    mask = np.zeros((b, lk), np.int32)
    mask[0, -37:] = 1

    def mine(q, k, v):
        out = jfa.flash_tower_attention(q, k, v, jnp.asarray(mask), 0, 0.0,
                                        True)
        o = out.astype(jnp.float32)
        return jnp.sum(o * jnp.sin(o))

    def ref(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / (d ** 0.5)
        s = jnp.where(mask[:, None, None, :].astype(bool),
                      jnp.finfo(jnp.float32).min, s)
        out = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)
        return jnp.sum(out * jnp.sin(out))

    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jax.grad(mine)(*bf), np.float32)
    f32 = np.asarray(jax.grad(ref)(*(x.astype(jnp.float32) for x in bf)))
    qt, kt, vt = (_t(x, torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    o = flash_tower_attention(qt, kt, vt, _t(mask), 0, 0.0).float()
    (o * torch.sin(o)).sum().backward()
    assert qt.grad.dtype == torch.bfloat16
    dq = qt.grad.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(dq, want, rtol=0, atol=4 * ulp)
    assert np.abs(dq - f32).max() <= 0.0045 * np.abs(f32).max()


def test_long_sequence_dispatches_tiled():
    """Past fits_chunked (bf16 at 2705 tokens, H=2) flash_tower_attention
    takes the tiled plain versions on CPU, forward and backward, with no
    monkeypatching, and equals them."""
    rs = np.random.RandomState(6)
    q, k, v, g = (torch.from_numpy(rs.randn(1, 2, 2705, 64) * 0.5)
                  .to(torch.bfloat16) for _ in range(4))
    assert regime(q, k) == "tiled"
    out, lse = flash_tiled_attention_fwd(q, k, v, None, 3, 0.1)
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = flash_tower_attention(qt, kt, vt, None, 3, 0.1)
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    got.backward(g)
    want = flash_tiled_attention_bwd(q, k, v, None, out, lse, g, 3, 0.1)
    for a, w in zip((qt.grad, kt.grad, vt.grad), want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_cuda_tensors_never_take_the_plain_version(force_tiled,
                                                   monkeypatch):
    q, k, v, pad = (_t(x).to("meta") for x in _inputs(4, seed=1))
    monkeypatch.setattr(port, "flash_tiled_attention_fwd_reference",
                        lambda *a: pytest.fail("plain version taken"))
    with pytest.raises(ValueError, match="no flash_tower_attention kernel"):
        flash_tower_attention(q, k, v, pad, 0, 0.1)
