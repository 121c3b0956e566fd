"""The port's loss suite, train preprocessing, training forward and dropout
against the JAX package on CPU, in f32.

Losses: each function and all 10 `compute_losses` keys on the same inputs
(duplicated idx, num_blocks 1 and 2), atol 1e-6; the streaming dstl and
caption-vision losses (B = 12 in blocks of 4), values and gradients,
against JAX's and the port's dense ones, and `compute_losses` with the fused
InfoNCE and streaming against JAX's, atol 1e-6.  The training forward's
`TrainEmbeddings` at the same params with every dropout at 0, for both
`cv_normalize_dim` values, atol 1e-5.  Dropout: statistics (no two
frameworks share a random stream).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.data.images import (
    CLIP_MEAN,
    CLIP_STD,
    preprocess_train_images,
)
from leccr_torch.models import losses as port
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.leccr import TrainEmbeddings as TorchEmb
from leccr_torch.models.weights import load_jax_params
from leccr_torch.ops.dropout import Generators, lean_dropout
from leccr_torch.ops.infonce import infonce_loss
from leccr_tpu.config import tiny_test_config
from leccr_tpu.data.images import preprocess_train_images as jax_preprocess
from leccr_tpu.models import losses as ref
from leccr_tpu.models.leccr import LECCRModel, TrainEmbeddings
from leccr_tpu.ops.infonce import infonce_loss as jax_infonce_loss

B, N, E, DV = 8, 4, 16, 24
IDX = np.array([0, 1, 2, 0, 3, 1, 4, 2], np.int32)  # duplicated ids


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def emb():
    rs = np.random.RandomState(0)
    return {
        "image_feat": _unit(rs.randn(B, E)).astype(np.float32),
        "text_feat_s": _unit(rs.randn(B, E)).astype(np.float32),
        "text_feat_t": _unit(rs.randn(B, E)).astype(np.float32),
        "slots": rs.randn(B, N, E).astype(np.float32),
        "ori_slots": rs.randn(B, N, DV).astype(np.float32),
        "cv_caption_mean": rs.randn(B, DV).astype(np.float32) * 0.3,
        "cv_vision_mean": rs.randn(B, DV).astype(np.float32) * 0.3,
        "temp": np.float32(0.07),
    }


def _both(emb, keys):
    return ([jnp.asarray(emb[k]) for k in keys],
            [torch.from_numpy(np.asarray(emb[k])) for k in keys])


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_idx", [True, False])
def test_soft_label_contrastive_loss(emb, with_idx):
    (a, b, t), (at, bt, tt) = _both(emb, ("image_feat", "text_feat_t",
                                          "temp"))
    idx = IDX if with_idx else None
    _close(port.soft_label_contrastive_loss(
               at, bt, tt, None if idx is None else torch.from_numpy(idx)),
           ref.soft_label_contrastive_loss(
               a, b, t, None if idx is None else jnp.asarray(idx)))


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_caption_contrastive_loss(emb, num_blocks):
    (s, f, t), (st, ft, tt) = _both(emb, ("slots", "text_feat_s", "temp"))
    _close(port.caption_contrastive_loss(st, ft, tt, num_blocks),
           ref.caption_contrastive_loss(s, f, t, num_blocks))


def test_norm_score_and_dstl_loss(emb):
    keys = ("image_feat", "slots", "text_feat_s", "text_feat_t")
    j, t = _both(emb, keys)
    _close(port._norm_score(t[0] @ t[2].T), ref._norm_score(j[0] @ j[2].T))
    _close(port.dstl_loss(*t, 0.8), ref.dstl_loss(*j, 0.8))
    # the labels are detached: the source-text features and the slots
    # reach the loss only through them, so they get no gradient
    ts = t[2].clone().requires_grad_(True)
    slots = t[1].clone().requires_grad_(True)
    assert not port.dstl_loss(t[0], slots, ts, t[3]).requires_grad


def test_dstl_xlogy_is_zero_where_labels_underflow():
    """labels·log(labels) is 0 where a softmax label underflows to 0."""
    rs = np.random.RandomState(3)
    img = _unit(rs.randn(4, E)).astype(np.float32)
    ts = img * 60.0  # huge, equal scores -> labels of exactly 0 elsewhere
    args = [img, rs.randn(4, N, E).astype(np.float32) * 60.0, ts,
            _unit(rs.randn(4, E)).astype(np.float32)]
    got = port.dstl_loss(*(torch.from_numpy(x) for x in args), 0.8)
    want = ref.dstl_loss(*(jnp.asarray(x) for x in args), 0.8)
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_caption_vision_loss(emb, num_blocks):
    (c, v), (ct, vt) = _both(emb, ("cv_caption_mean", "cv_vision_mean"))
    _close(port.caption_vision_loss(ct, vt, torch.from_numpy(IDX),
                                    num_blocks),
           ref.caption_vision_loss(c, v, jnp.asarray(IDX), num_blocks))


def test_caption_regularization(emb):
    (o,), (ot,) = _both(emb, ("ori_slots",))
    _close(port.caption_regularization(ot), ref.caption_regularization(o))


@pytest.mark.parametrize("num_blocks,cv_local,weights", [
    (1, False, (0.01, 0.01, 0.5, 0.01)),
    (2, False, (0.01, 0.01, 0.5, 0.01)),
    (2, True, (0.1, 0.2, 0.3, 0.4)),
    (1, False, (0.01, 0.01, 0.0, 0.0)),  # zero weights skip dstl and cv
])
def test_compute_losses_all_keys(emb, num_blocks, cv_local, weights):
    keys = [f.name for f in dataclasses.fields(TrainEmbeddings)]
    j, t = _both(emb, keys)
    kw = dict(zip(("weight_caption_loss", "weight_reg_loss",
                   "weight_dstl_loss", "weight_cv_loss"), weights),
              dstl_alpha=0.8, num_blocks=num_blocks, cv_loss_local=cv_local)
    want = ref.compute_losses(TrainEmbeddings(*j), jnp.asarray(IDX), **kw)
    got = port.compute_losses(TorchEmb(*t), torch.from_numpy(IDX), **kw)
    assert set(got) == set(want) == set(port.LOSS_KEYS)
    for key in port.LOSS_KEYS:
        _close(got[key], want[key])
    if weights[2] == 0.0:
        assert float(got["raw_dstl"]) == float(got["raw_cv"]) == 0.0


@pytest.fixture(scope="module")
def emb12():
    """Loss inputs at B = 12 (three blocks of 4), duplicated ids."""
    rs = np.random.RandomState(11)
    b = 12
    return {
        "image_feat": _unit(rs.randn(b, E)).astype(np.float32),
        "text_feat_s": _unit(rs.randn(b, E)).astype(np.float32),
        "text_feat_t": _unit(rs.randn(b, E)).astype(np.float32),
        "slots": rs.randn(b, N, E).astype(np.float32),
        "ori_slots": rs.randn(b, N, DV).astype(np.float32),
        "cv_caption_mean": rs.randn(b, DV).astype(np.float32) * 0.3,
        "cv_vision_mean": rs.randn(b, DV).astype(np.float32) * 0.3,
        "temp": np.float32(0.07),
        "idx": np.array([0, 1, 2, 0, 3, 1, 4, 5, 6, 2, 7, 8], np.int32),
    }


def _value_and_grads(fn, tensors):
    """fn's value and its gradient in each tensor (zeros where none
    reaches it)."""
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    value = fn(*leaves)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), [torch.zeros_like(t) if g is None else g
                            for t, g in zip(leaves, grads)]


def _check_streaming(emb12, keys, port_stream, port_dense, jax_stream):
    j, t = _both(emb12, keys)
    idx_t = torch.from_numpy(emb12["idx"])
    idx_j = jnp.asarray(emb12["idx"])
    got, got_g = _value_and_grads(lambda *x: port_stream(*x, idx_t), t)
    dense, dense_g = _value_and_grads(lambda *x: port_dense(*x, idx_t), t)
    want, want_g = jax.value_and_grad(
        lambda *x: jax_stream(*x, idx_j), argnums=tuple(range(len(j))))(*j)
    for value, grads in ((want, want_g), (dense, dense_g)):
        _close(got, value)
        for g, w in zip(got_g, grads):
            _close(g, w)


def test_dstl_loss_blockwise(emb12):
    """Rows in 3 blocks of 4; the source texts and slots reach the loss only
    through the detached labels, so their gradients are 0 on all sides."""
    _check_streaming(
        emb12, ("image_feat", "slots", "text_feat_s", "text_feat_t"),
        lambda i, s, ts, tt, idx: port.dstl_loss_blockwise(i, s, ts, tt, 0.8,
                                                           4),
        lambda i, s, ts, tt, idx: port.dstl_loss(i, s, ts, tt, 0.8),
        lambda i, s, ts, tt, idx: ref.dstl_loss_blockwise(i, s, ts, tt, 0.8,
                                                          4))


def test_caption_vision_loss_blockwise(emb12):
    _check_streaming(
        emb12, ("cv_caption_mean", "cv_vision_mean"),
        lambda c, v, idx: port.caption_vision_loss_blockwise(c, v, idx, 4),
        lambda c, v, idx: port.caption_vision_loss(c, v, idx),
        lambda c, v, idx: ref.caption_vision_loss_blockwise(c, v, idx, 4))


def test_blockwise_losses_refuse_ragged_blocks(emb12):
    _, t = _both(emb12, ("cv_caption_mean", "cv_vision_mean"))
    with pytest.raises(ValueError, match="blocks of 5"):
        port.caption_vision_loss_blockwise(*t, torch.from_numpy(
            emb12["idx"]), 5)


@pytest.mark.parametrize("cv_local", [False, True])
def test_compute_losses_fused_and_streaming(emb12, cv_local):
    """The 10 keys with the fused InfoNCE and 4 streaming rows against JAX's
    compute_losses with its infonce_loss and the same streaming; the video
    semantics (cv_loss_local) keep the caption-vision loss dense."""
    keys = [f.name for f in dataclasses.fields(TrainEmbeddings)]
    j, t = _both(emb12, keys)
    kw = dict(weight_caption_loss=0.01, weight_reg_loss=0.01,
              weight_dstl_loss=0.5, weight_cv_loss=0.01, dstl_alpha=0.8,
              num_blocks=2 if cv_local else 1, cv_loss_local=cv_local,
              stream_block_rows=4)
    want = ref.compute_losses(TrainEmbeddings(*j), jnp.asarray(emb12["idx"]),
                              itc_loss_fn=jax_infonce_loss, **kw)
    got = port.compute_losses(TorchEmb(*t), torch.from_numpy(emb12["idx"]),
                              itc_loss_fn=infonce_loss, **kw)
    assert set(got) == set(want) == set(port.LOSS_KEYS)
    for key in port.LOSS_KEYS:
        _close(got[key], want[key])


def test_preprocess_train_images_matches_jax():
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (5, 8, 12, 3)).astype(np.uint8)
    flip = np.array([True, False, True, True, False])
    want = np.asarray(jax_preprocess(jnp.asarray(images), jnp.asarray(flip)))
    got = preprocess_train_images(torch.from_numpy(images),
                                  torch.from_numpy(flip))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        preprocess_train_images(torch.from_numpy(images), None).numpy(),
        np.asarray(jax_preprocess(jnp.asarray(images), None)), atol=1e-6)
    # RandAugment draws from an explicit generator (its ops are held
    # against JAX's in tests/test_torch_randaugment.py): after /255, before
    # the normalization and the flip
    with pytest.raises(ValueError, match="generator"):
        preprocess_train_images(torch.from_numpy(images), None,
                                randaugment_n=2)
    from leccr_torch.data.randaugment import rand_augment_batch

    got = preprocess_train_images(torch.from_numpy(images),
                                  torch.from_numpy(flip),
                                  torch.Generator().manual_seed(3), 2, 9)
    augmented = rand_augment_batch(
        torch.from_numpy(images).float() / 255.0,
        torch.Generator().manual_seed(3), 2, 9)
    want = (augmented - torch.from_numpy(CLIP_MEAN)) / torch.from_numpy(
        CLIP_STD)
    want = torch.where(torch.from_numpy(flip)[:, None, None, None],
                       want.flip(2), want)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_lean_dropout_statistics(rate):
    x = torch.ones(200_000)
    gen = Generators.from_seed(5, "cpu")
    y = lean_dropout(x, rate, False, gen)
    kept = (y != 0).float()
    n = x.numel()
    keep = 1.0 - min(65535, round(rate * 65536)) / 65536
    assert abs(kept.mean().item() - keep) <= 6 * (keep * (1 - keep) / n) ** .5
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / (1 - rate)))
    again = lean_dropout(x, rate, False, Generators.from_seed(5, "cpu"))
    torch.testing.assert_close(y, again, rtol=0, atol=0)
    assert not torch.equal(y, lean_dropout(x, rate, False, gen))
    bf16 = lean_dropout(x.bfloat16(), rate, False, gen)
    assert bf16.dtype == torch.bfloat16


def test_lean_dropout_degenerate_rates():
    x = torch.randn(100)
    gen = Generators.from_seed(0, "cpu")
    assert torch.equal(lean_dropout(x, 1.0, False, gen), torch.zeros(100))
    assert lean_dropout(x, 0.0, False, None) is x
    assert lean_dropout(x, 0.3, True, None) is x


def test_flash_seeds_are_int32_and_differ():
    gen = Generators.from_seed(17, "cpu")
    seeds = [gen.flash_seed() for _ in range(50)]
    assert all(0 <= s < 2 ** 31 - 1 for s in seeds)
    assert len(set(seeds)) == 50


@pytest.mark.parametrize("cv_dim", [1, -1])
def test_train_forward_matches_jax(cv_dim):
    """LECCRModel's training forward (deterministic at rate 0) against the
    JAX model's __call__(deterministic=False) at the same params: all 8
    TrainEmbeddings fields, for the token-axis (1) and the feature-axis
    (-1) cv normalization."""
    over = {"model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
            "model.text.attention_dropout": 0.0,
            "model.cv_normalize_dim": cv_dim}
    cfg = tiny_test_config(**over)
    rs = np.random.RandomState(cv_dim + 3)
    b, length, res = 3, 16, cfg.model.vision.image_res
    mask = np.ones((b, length), np.int32)
    mask[1, 9:] = 0
    batch = {"vision": rs.randn(b, res, res, 3).astype(np.float32),
             "caption_ids": rs.randint(5, 512, (b, length)) * mask,
             "caption_mask": mask}
    for k in ("s", "t"):
        batch[f"text_ids_{k}"] = rs.randint(5, 512, (b, length)) * mask
        batch[f"text_mask_{k}"] = mask
    model = LECCRModel(cfg.model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = model.init({"params": jax.random.PRNGKey(0)}, jbatch)["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    want = jax.jit(lambda p: model.apply(
        {"params": p}, jbatch, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(1)}))(params)
    for fused in (True, False):
        port_model = TorchLECCR(torch_tiny_config(**over, **{
            "model.vision.fused_attention": fused,
            "model.text.fused_attention": fused}).model, device="cpu")
        load_jax_params(port_model, params)
        port_model.train()
        got = port_model({k: torch.from_numpy(v) for k, v in batch.items()},
                         Generators.from_seed(0, "cpu"))
        for field in dataclasses.fields(TorchEmb):
            np.testing.assert_allclose(
                getattr(got, field.name).detach().numpy(),
                np.asarray(getattr(want, field.name)), rtol=0, atol=1e-5,
                err_msg=field.name)
