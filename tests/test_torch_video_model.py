"""The port's video model against the JAX package's on CPU in f32, at equal
weights (numpy-seeded, every parameter moved off its init):

  - `SelfAttentionStack` and `TemporalTower` with a partial frame mask and
    a fully padded row: atol 1e-5; `masked_mean_pool`: atol 1e-6;
  - the full video model (`vision.kind: temporal`, frame_feat_dim 512 at 8
    heads, so Dh = 64): the training forward's TrainEmbeddings,
    `embed_images` (the fused attention on and off) and `embed_texts`:
    atol 1e-5, with `video_cv_mask_frames` on and off (the cv means, which
    L2-normalize over the slot or frame axis, at 1e-5 / min(|x|, 1) of the
    normalized vector x);
  - one train step (dropouts 0) against JAX's value_and_grad of the video
    `grad_total` (the caption-vision loss local, trainer.py:421-431)
    followed by `tx.update`, in tests/test_torch_train.py's measure:
    losses atol 1e-5, gradients atol 1e-4, parameters atol 1e-6 where the
    gradient is above f32 noise and within 2·lr elsewhere.  The rows of
    `cproj.weight` whose output channel is ill-conditioned for the cv
    means' normalization (its norm over the slots below `COND_NORM` in
    some batch row) are held to a bound of their conditioning instead
    (`cproj_row_bounds`), and at most `MAX_ILL_CHANNELS` rows may be.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.temporal import TemporalTower, masked_mean_pool
from leccr_torch.models.weights import (
    flax_to_state_dict,
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from leccr_torch.ops.attention import SelfAttentionStack
from leccr_torch.train.step import make_train_step
from leccr_tpu.config import tiny_test_config
from leccr_tpu.models import temporal as jax_temporal
from leccr_tpu.models.leccr import LECCRModel
from leccr_tpu.models.losses import compute_losses
from leccr_tpu.ops.attention import SelfAttentionStack as JaxSelfAttention
from leccr_tpu.train.optim import build_optimizer
from leccr_tpu.train.schedule import linear_warmup_decay

ATOL = 1e-5
LR = 1e-3
# cproj output channels whose norm over the slots falls below COND_NORM in
# some batch row get a gradient bound of their conditioning; no more than
# MAX_ILL_CHANNELS of the 512 may (7 do on this data)
COND_NORM = 0.02
MAX_ILL_CHANNELS = 8
B, T, L, DF = 6, 6, 16, 512
VIDEO = {"model.vision.kind": "temporal", "model.vision.frame_feat_dim": DF,
         "model.vision.num_layers": 1, "model.vision.num_heads": 8,
         "model.vision.max_frames": T, "model.num_queries": 2,
         "model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
         "model.text.attention_dropout": 0.0, "train.optimizer.lr": LR,
         "train.schedular.num_warmup_steps": 0}


def _moved(params, rs):
    return jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)


def _frame_mask(b, t):
    """Rows with 6, 4, 1 and 0 real frames (a fully padded row: its
    attention is the mean over every frame, as the f32-min mask gives)."""
    mask = np.ones((b, t), bool)
    mask[1, 4:] = False
    mask[2, 1:] = False
    mask[3, :] = False
    return mask


@pytest.mark.parametrize("layers", [1, 2])
def test_self_attention_stack_matches_jax(layers):
    d, heads = 128, 8
    rs = np.random.RandomState(layers)
    src = rs.randn(4, 7, d).astype(np.float32)
    pad = ~_frame_mask(4, 7)
    stack = JaxSelfAttention(d, heads, layers, dropout=0.1)
    params = _moved(stack.init(jax.random.PRNGKey(0), src, pad)["params"],
                    rs)
    want = stack.apply({"params": params}, src, pad)
    port = SelfAttentionStack(d, heads, layers, dropout=0.1).eval()
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    got = port(torch.from_numpy(src), torch.from_numpy(pad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_temporal_tower_and_pool_match_jax():
    d = 64
    rs = np.random.RandomState(7)
    frames = rs.randn(4, 5, d).astype(np.float32)
    mask = _frame_mask(4, 5)
    tower = jax_temporal.TemporalTower(d_model=d, num_heads=8, num_layers=1)
    params = _moved(tower.init(jax.random.PRNGKey(1), frames, mask)[
        "params"], rs)
    want = tower.apply({"params": params}, frames, mask)
    port = TemporalTower(d, 8, 1).eval()
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    got = port(torch.from_numpy(frames), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    pooled = masked_mean_pool(torch.from_numpy(frames), torch.from_numpy(mask))
    np.testing.assert_allclose(
        pooled.numpy(), np.asarray(jax_temporal.masked_mean_pool(
            jnp.asarray(frames), jnp.asarray(mask))), rtol=0, atol=1e-6)
    assert not pooled[3].any()  # no real frame: 0, as in JAX


def _video_batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    batch = {"vision": rs.randn(B, T, DF).astype(np.float32),
             "vision_mask": _frame_mask(B, T),
             "idx": np.array([0, 1, 2, 0, 3, 1], np.int32)}  # duplicates
    for key in ("text_ids_s", "text_ids_t", "caption_ids"):
        batch[key] = (rs.randint(5, 512, (B, L)) * mask).astype(np.int32)
    for key in ("text_mask_s", "text_mask_t", "caption_mask"):
        batch[key] = mask
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in ("text_ids_s", "text_ids_t", "caption_ids"):
        out[k] = out[k].long()
    return out


@pytest.fixture(scope="module")
def video_setup():
    cfg = tiny_test_config(**VIDEO)
    batch = _video_batch(cfg)
    model = LECCRModel(cfg.model)
    inputs = {k: jnp.asarray(v) for k, v in batch.items() if k != "idx"}
    params = model.init({"params": jax.random.PRNGKey(0)}, inputs)["params"]
    params = _moved(params, np.random.RandomState(1))
    params["temp"] = np.float32(cfg.model.temp)  # losses of O(1)
    return cfg, model, params, batch, inputs


def _port_model(params, **overrides):
    model = TorchLECCR(torch_tiny_config(**VIDEO, **overrides).model,
                       device="cpu")
    load_jax_params(model, params)
    return model


@pytest.mark.parametrize("mask_frames", [True, False])
def test_video_forward_matches_jax(video_setup, mask_frames):
    cfg, model, params, batch, inputs = video_setup
    cfg.model.video_cv_mask_frames = mask_frames
    try:
        want = LECCRModel(cfg.model).apply({"params": params}, inputs)
    finally:
        cfg.model.video_cv_mask_frames = True
    port = _port_model(params, **{
        "model.video_cv_mask_frames": mask_frames})
    with torch.no_grad():
        got = port(_torch_batch(batch))
        # the cv means L2-normalize cproj/vproj outputs over the slot
        # (frame) axis: an f32 difference dx in x moves x/|x| by up to
        # ~dx/|x|, so an entry is held to ATOL / min(|x|, 1) over that axis
        scale = {"cv_caption_mean": port.cproj(got.ori_slots),
                 "cv_vision_mean": port.vproj(port.encode_vision(
                     _torch_batch(batch)["vision"],
                     _torch_batch(batch)["vision_mask"]))}
    for field in ("image_feat", "text_feat_s", "text_feat_t", "slots",
                  "ori_slots", "cv_caption_mean", "cv_vision_mean", "temp"):
        tol = ATOL
        if field in scale:
            norm = torch.linalg.vector_norm(scale[field], dim=1)
            tol = (ATOL / norm.clamp(max=1.0)).numpy()
        diff = np.abs(getattr(got, field).detach().numpy()
                      - np.asarray(getattr(want, field)))
        assert (diff <= tol).all(), (field, diff.max())
    # the two cv means differ only in the rows with padded frames
    other = _port_model(params, **{
        "model.video_cv_mask_frames": not mask_frames})
    with torch.no_grad():
        alt = other(_torch_batch(batch)).cv_vision_mean
    padded = torch.from_numpy(~batch["vision_mask"].all(axis=1))
    assert torch.equal(alt[~padded], got.cv_vision_mean[~padded])
    assert (alt[padded] - got.cv_vision_mean[padded]).abs().amax(1).min() > 0


@pytest.mark.parametrize("fused", [True, False])
def test_video_embed_images_and_texts_match_jax(video_setup, fused):
    cfg, model, params, batch, inputs = video_setup
    keys = ("vision", "vision_mask", "caption_ids", "caption_mask")
    want = model.apply({"params": params}, {k: inputs[k] for k in keys},
                       method="embed_images")
    port = _port_model(params, **{"model.fused_eval_attention": fused})
    got = port.embed_images({k: v for k, v in _torch_batch(batch).items()
                             if k in keys})
    assert got["slots"].shape == (B, 2, cfg.model.embed_dim)
    for key in ("feat", "slots"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
    want_t = model.apply({"params": params}, inputs["text_ids_s"],
                         inputs["text_mask_s"], method="embed_texts")
    got_t = port.embed_texts(torch.from_numpy(batch["text_ids_s"]).long(),
                             torch.from_numpy(batch["text_mask_s"]))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0,
                               atol=ATOL)


def test_video_params_export_to_jax_bit_for_bit(video_setup):
    cfg, _, params, _, _ = video_setup
    port = _port_model(params)
    back = params_to_jax(port.state_dict(), port.cfg)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, value in flat_want:
        np.testing.assert_array_equal(flat_got[path], value)
    assert "vision_tower.encoder.layers.0.attn.q_proj.weight" in dict(
        port.named_parameters())


@pytest.fixture(scope="module")
def jax_video_step(video_setup):
    """JAX's video train step (trainer.py:366-452, one device): the frames
    skip image preprocessing and raw_cv joins the local terms."""
    cfg, model, params, batch, inputs = video_setup
    mc = cfg.model
    tx = build_optimizer(cfg.train.optimizer, params,
                         linear_warmup_decay(LR, 100, 0),
                         frozen_paths=("clip_text_tower",))

    def loss_fn(p):
        emb = model.apply({"params": p}, inputs, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(2)})
        losses = compute_losses(
            emb, jnp.asarray(batch["idx"]),
            weight_caption_loss=mc.weight_caption_loss,
            weight_reg_loss=mc.weight_reg_loss,
            weight_dstl_loss=mc.weight_dstl_loss,
            weight_cv_loss=mc.weight_cv_loss, cv_loss_local=True)
        gathered = (losses["raw_itc_vs"]
                    + losses["raw_itc_vt"] * (1 - mc.weight_dstl_loss)
                    + losses["loss_itc_st"] + losses["raw_dstl"])
        local = losses["loss_itc_c"] + losses["loss_reg_c"] + losses[
            "raw_cv"]
        return gathered + local, losses

    @jax.jit
    def step(p):
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, optax.apply_updates(p, updates)

    return jax.tree.map(np.asarray, step(params))


@pytest.fixture(scope="module")
def cproj_row_bounds(video_setup, jax_video_step):
    """The gradient bound of each row c of `cproj.weight`, from the JAX
    side.  The cv means normalize x = cproj(ori_slots) [B, n, D] over the
    n slots.  Where a channel's norm ‖x_bc‖ over the slots is small, the
    normalization's Jacobian (I − yyᵀ)/‖x‖ turns sum-order noise δ in x
    into a relative change of up to 3δ/‖x‖ in the gradient reaching x, and
    so in the row's gradient.  δ_c is one f32 rounding of the terms'
    magnitude sum, eps · max_bs Σ_i |ori_bsi · W_ic|.  A row whose channel
    has min_b ‖x_bc‖ < COND_NORM is held to 1e-4 + 3 δ_c / ‖x_c‖ ·
    max|∂W_c|; every other row to 1e-4."""
    cfg, model, params, batch, inputs = video_setup
    _, want_grads, _ = jax_video_step
    emb = model.apply({"params": params}, inputs)
    ori = np.asarray(emb.ori_slots, np.float32)
    kernel = np.asarray(params["cproj"]["kernel"], np.float32)  # [in, out]
    x = ori @ kernel + np.asarray(params["cproj"]["bias"], np.float32)
    norm = np.linalg.norm(x, axis=1).min(axis=0)  # [out]
    delta = np.finfo(np.float32).eps * np.einsum(
        "bsi,io->bso", np.abs(ori), np.abs(kernel)).max(axis=(0, 1))
    grad = np.abs(np.asarray(want_grads["cproj"]["kernel"])).max(axis=0)
    ill = norm < COND_NORM
    assert ill.sum() <= MAX_ILL_CHANNELS, np.nonzero(ill)[0]
    bound = np.where(ill, 1e-4 + 3 * delta / norm * grad, 1e-4)
    return torch.from_numpy(bound.astype(np.float32))[:, None]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_video_train_step_matches_jax(video_setup, jax_video_step,
                                      cproj_row_bounds, microbatches):
    """Also through GradCache (2 microbatches: the same gradient)."""
    _, _, params, batch, _ = video_setup
    want_losses, want_grads, want_params = jax_video_step
    cfg = torch_tiny_config(**VIDEO, **{
        "train.grad_cache_microbatches": microbatches})
    model = TorchLECCR(cfg.model, device="cpu")
    load_jax_params(model, params)
    step = make_train_step(cfg, model, total_steps=100)
    assert step.is_video
    losses = step(_torch_batch(batch), 0)
    assert set(losses) == set(want_losses)
    for key, value in losses.items():
        assert abs(value - float(want_losses[key])) <= 1e-5, key
    grads = params_from_jax(want_grads, cfg.model)
    after = params_from_jax(want_params, cfg.model)
    for name, p in model.named_parameters():
        if name == "cproj.weight":
            over = (p.grad - grads[name]).abs() > cproj_row_bounds
            assert not over.any(), (name, over.nonzero()[:5])
        else:
            torch.testing.assert_close(p.grad, grads[name], rtol=0,
                                       atol=1e-4, msg=name)
        signal = grads[name].abs() > 1e-4
        diff = (p.detach() - after[name]).abs()
        assert diff.where(signal, 0).max().item() <= 1e-6, name
        assert diff.where(~signal, 0).max().item() <= 2 * LR, name
