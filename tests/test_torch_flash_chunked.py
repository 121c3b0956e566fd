"""The port's chunked flash attention (kernels 4/5: plain versions, CPU
wrapper, autograd Function, dispatch) against the JAX package's chunked
Pallas kernels run in interpret mode.

Both sides are forced into the chunked regime at small shapes by
monkeypatching `fits_vmem` to False, as `tests/test_flash_attention.py`
does for the JAX package.  Lengths that are not tile multiples (Lq=150,
Lk=200 → 256) with key padding and a fully padded row; H=2 (two heads per
dropout head group) and H=3 (one).

Tolerances (f32): out and lse atol 1e-5 (the same f32 math summed in
another order); gradients rtol 1e-4 / atol 5e-5 (products of three such
sums).  bf16: 4 bf16 ulps at the scale of the largest dq against interpret
mode, and the f32 reference bound of `test_bf16_dq_accumulates_f32`.
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
    flash_chunked_attention_bwd,
    flash_chunked_attention_fwd,
    flash_tower_attention,
    tile_keep_mask,
)
from leccr_tpu.ops import flash_attention as jfa

B, D, LQ, LK = 2, 16, 150, 200


@pytest.fixture
def force_chunked(monkeypatch):
    monkeypatch.setattr(jfa, "fits_vmem", lambda *a: False)
    monkeypatch.setattr(port, "fits_vmem", lambda *a: False)


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
@pytest.mark.parametrize("h", [2, 3])
def test_forward_matches_interpret(force_chunked, h, rate):
    q, k, v, pad = _inputs(h, seed=h)
    seed = 77
    want_out, res = jfa._flash_fwd(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(pad), seed, rate,
        True)
    want_lse = np.asarray(res[5])[:, :, :LQ]
    out, lse = flash_chunked_attention_fwd(_t(q), _t(k), _t(v), _t(pad),
                                           seed, rate)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
    assert np.isneginf(want_lse[0]).all() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("h", [2, 3])
def test_grads_match_jax_grad(force_chunked, h, rate):
    """jax.grad of sum(out · cos(out)) through the JAX custom VJP against
    the port's autograd Function on CPU (the chunked plain backward)."""
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


@pytest.mark.parametrize("h", [2, 3])
def test_tile_keep_mask_is_the_interpret_hash(h):
    """Bit for bit the numpy replica of the JAX interpret-mode tile mask,
    on the padded tile grid cut back to (Lq, Lk)."""
    from test_flash_attention import _tile_keep_np

    lqp, lkp = -(-LQ // 128) * 128, -(-LK // 128) * 128
    for seed, rate in ((7, 0.2), (2 ** 31 - 2, 0.1)):
        want = _tile_keep_np(seed, B, h, lqp, lkp, 128, 128, rate,
                             jfa._chunk_head_group(h))[:, :, :LQ, :LK]
        got = tile_keep_mask(seed, B, h, LQ, LK, rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_bf16_dq_accumulates_f32(force_chunked):
    """bf16 io over 5 key tiles: dq sums its per-tile partials in f32 and
    rounds once, as interpret mode does (tests/test_flash_attention.py:247),
    and stays within that test's bound of the f32 reference."""
    rs = np.random.RandomState(2)
    b, h, lq, lk, d = 2, 2, 130, 640, 16
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


def test_fully_padded_row_gives_zero(force_chunked):
    """Unlike the single-block regime (the mean of v), a row with no key
    gives out 0 and lse −inf, and its example gets zero gradients."""
    q, k, v, pad = (_t(x) for x in _inputs(2, seed=3))
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    out, lse = flash_chunked_attention_fwd(q, k, v, pad, 9, 0.2)
    assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()
    assert torch.isfinite(out[1]).all() and torch.isfinite(lse[1]).all()
    g = torch.from_numpy(np.random.RandomState(4).randn(*out.shape)
                         .astype(np.float32))
    flash_tower_attention(qt, kt, vt, pad, 9, 0.2).backward(g)
    for grad in (qt.grad, kt.grad, vt.grad):
        assert (grad[0] == 0).all() and grad[1].abs().max() > 0
    grads = flash_chunked_attention_bwd(q, k, v, pad, out, lse, g, 9, 0.2)
    for a, b in zip(grads, (qt.grad, kt.grad, vt.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fits_chunked_is_the_jax_budget():
    for h in (1, 2, 3, 12, 16):
        assert chunk_head_group(h) == jfa._chunk_head_group(h)
        for length in (64, 169, 200, 577, 640, 1500, 1700, 2600, 3000):
            for d in (32, 64, 128):
                for item in (2, 4):
                    assert (fits_chunked(h, length, length, d, item)
                            == jfa.fits_chunked(h, length, length, d, item))
    # ViT-L/14 @336 chunks in both dtypes; the dtypes part ways further on
    assert fits_chunked(16, 577, 577, 64, 2) and fits_chunked(16, 577, 577,
                                                              64, 4)
    assert fits_chunked(16, 1700, 1700, 64, 2)
    assert not fits_chunked(16, 1700, 1700, 64, 4)


def test_cuda_tensors_never_take_the_plain_version(force_chunked,
                                                   monkeypatch):
    q, k, v, pad = (_t(x).to("meta") for x in _inputs(2, seed=1))
    monkeypatch.setattr(port, "flash_chunked_attention_fwd_reference",
                        lambda *a: pytest.fail("plain version taken"))
    with pytest.raises(ValueError, match="no flash_tower_attention kernel"):
        flash_tower_attention(q, k, v, pad, 0, 0.1)
