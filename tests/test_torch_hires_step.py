"""The high-resolution training slice on CPU: a tiny config with the
structure of `chip_smoke.hires_config()` (`configs/scale_vitl_32k.yaml`'s
ViT-L/14 variant, here cut to width 192 = 3 heads, depth 2 and image_res
168 = 145 tokens, two key tiles with a ragged edge; an XLM-R text tower of 2
layers; flash in both towers; `remat: true`; `negatives: ring_fused`),
against the JAX package, and the checkpoint path into the high-resolution
tower.

(a) one whole train step at dropouts 0, the port forced into the tiled
    flash regime (kernels 6-8's plain versions), against JAX's
    value_and_grad + optax with remat (the JAX towers take their plain
    attention off the TPU).  Tolerances as `test_torch_scale_step`'s: losses
    atol 1e-5, gradients atol 1e-4, updated params 1e-6 (2·lr where the
    gradient is f32 noise).
(b) dropout 0.1: remat on against remat off at the same step seed, losses
    and every gradient within 1e-6, and the recompute reruns each remat'd
    block's tiled forward (3 heads: head group 3, so the tiled mask is not
    the chunked one).
(c) `interpolate_pos_embed` against the JAX package's (`jax.image.resize`
    bicubic) within 1e-5, to the 728² tower's 52 × 52 grid and others.
(d) `clip_vision_state_dict` / `clip_vision_state_dict_from_hf` against
    `leccr_tpu.models.convert`'s `clip_vision_params` /
    `clip_vision_params_from_hf` at target_grid 52 on synthetic OpenAI- and
    HF-layout state dicts: the same tensors (position embedding within
    1e-5, the rest exact), a strict load into the port's tower, and the
    converted towers' outputs within 1e-4 of each other on one image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.models.clip import CLIPVisionTower as TorchVisionTower
from leccr_torch.models.clip import build_vision_tower, interpolate_pos_embed
from leccr_torch.models.convert import (
    clip_vision_state_dict,
    clip_vision_state_dict_from_hf,
)
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.weights import (
    flax_to_state_dict,
    load_jax_params,
    params_from_jax,
)
from leccr_torch.ops import flash_attention as port_fa
from leccr_torch.train.step import make_train_step
from leccr_tpu.config import tiny_test_config
from leccr_tpu.models import convert as jconvert
from leccr_tpu.models.clip import CLIPVisionTower
from leccr_tpu.models.clip import interpolate_pos_embed as jax_interpolate
from test_torch_scale_step import DROPOUT, LR, NO_DROPOUT, SLICE, jax_step_of
from test_torch_train import _batch, _torch_batch

HIRES = {**SLICE, "model.vision.width": 192, "model.vision.image_res": 168}
WIDTH, LAYERS, PATCH = 64, 2, 14


@pytest.fixture
def force_tiled(monkeypatch):
    monkeypatch.setattr(port_fa, "fits_vmem", lambda *a: False)
    monkeypatch.setattr(port_fa, "fits_chunked", lambda *a, **k: False)


@pytest.fixture
def tiled_forwards(monkeypatch):
    """A list that grows by one at each call of the tiled forward's plain
    version (the CPU side of kernel 6)."""
    calls = []
    plain = port_fa.flash_tiled_attention_fwd_reference

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(port_fa, "flash_tiled_attention_fwd_reference",
                        counted)
    return calls


@pytest.fixture(scope="module")
def jax_step():
    return jax_step_of(tiny_test_config(**HIRES, **NO_DROPOUT))


def test_hires_train_step_matches_jax(jax_step, force_tiled, tiled_forwards):
    batch, params, want_losses, want_grads, want_params = jax_step
    cfg = torch_tiny_config(**HIRES, **NO_DROPOUT)
    model = TorchLECCR(cfg.model, device="cpu")
    assert model.vision_tower.transformer.resblocks[0].attn.heads == 3
    assert model.vision_tower.positional_embedding.shape[0] == 145
    load_jax_params(model, params)
    step = make_train_step(cfg, model, total_steps=100)
    losses = step(_torch_batch(batch), 0)
    # 2 vision + 2 text blocks, each again in the recompute, + 2 caption
    assert len(tiled_forwards) == 10
    for key, value in losses.items():
        assert abs(value - float(want_losses[key])) <= 1e-5, key
    grads = params_from_jax(want_grads, cfg.model)
    after = params_from_jax(want_params, cfg.model)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[name], rtol=0, atol=1e-4,
                                   msg=name)
        signal = grads[name].abs() > 1e-4
        diff = (p.detach() - after[name]).abs()
        assert diff.where(signal, 0).max().item() <= 1e-6, name
        assert diff.where(~signal, 0).max().item() <= 2 * LR, name


def _step_grads(cfg, batch, step_no=3):
    model = TorchLECCR(cfg.model, device="cpu", seed=4)
    losses = make_train_step(cfg, model, total_steps=100)(batch, step_no)
    return losses, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_replays_tiled_dropout(force_tiled, tiled_forwards):
    """Dropout 0.1 everywhere: remat on and off give the same losses and
    gradients through the tiled regime, and remat on runs each block's
    tiled forward twice."""
    batch = _torch_batch(_batch(torch_tiny_config(**HIRES)))
    runs = {}
    for remat in (True, False):
        cfg = torch_tiny_config(**{**HIRES, **DROPOUT, "model.remat": remat})
        before = len(tiled_forwards)
        runs[remat] = _step_grads(cfg, batch)
        assert len(tiled_forwards) - before == (10 if remat else 6)
    (losses_on, grads_on), (losses_off, grads_off) = runs[True], runs[False]
    for key in losses_on:
        assert abs(losses_on[key] - losses_off[key]) <= 1e-6, key
    for name, g in grads_on.items():
        torch.testing.assert_close(g, grads_off[name], rtol=0, atol=1e-6,
                                   msg=name)
    other, _ = _step_grads(cfg, batch, step_no=4)
    assert other["total"] != losses_off["total"]  # dropout did act


@pytest.mark.parametrize("grid,target", [(24, 52), (16, 52), (24, 40),
                                         (52, 24), (24, 24)])
def test_interpolate_pos_embed_matches_jax(grid, target):
    pos = np.random.RandomState(grid + target).randn(
        grid * grid + 1, 48).astype(np.float32)
    want = np.asarray(jax_interpolate(jnp.asarray(pos), target))
    got = interpolate_pos_embed(torch.from_numpy(pos), target)
    assert got.shape == (target * target + 1, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), pos[0])  # the class token


def _openai_sd(rs, grid=24):
    """A synthetic OpenAI-layout `visual.*` state dict (24 × 24 patches, the
    336² checkpoint's grid)."""
    w, p = WIDTH, "visual"

    def r(*shape):
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    sd = {f"{p}.conv1.weight": r(w, 3, PATCH, PATCH),
          f"{p}.class_embedding": r(w),
          f"{p}.positional_embedding": r(grid * grid + 1, w),
          f"{p}.proj": r(w, 32)}
    for ln in ("ln_pre", "ln_post"):
        sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + r(w), r(w)
    for i in range(LAYERS):
        b = f"{p}.transformer.resblocks.{i}"
        sd[f"{b}.attn.in_proj_weight"] = r(3 * w, w)
        sd[f"{b}.attn.in_proj_bias"] = r(3 * w)
        for name, (o, n) in {"attn.out_proj": (w, w), "mlp.c_fc": (4 * w, w),
                             "mlp.c_proj": (w, 4 * w)}.items():
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = r(o, n), r(o)
        for ln in ("ln_1", "ln_2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = 1 + r(w), r(w)
    return sd


def _hf_sd(rs, grid=24):
    """The same tower in HuggingFace CLIPVisionModelWithProjection's
    layout."""
    w, p = WIDTH, "vision_model"

    def r(*shape):
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    sd = {f"{p}.embeddings.patch_embedding.weight": r(w, 3, PATCH, PATCH),
          f"{p}.embeddings.class_embedding": r(w),
          f"{p}.embeddings.position_embedding.weight": r(grid * grid + 1, w),
          "visual_projection.weight": r(32, w)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + r(w), r(w)
    for i in range(LAYERS):
        b = f"{p}.encoder.layers.{i}"
        for name, (o, n) in {"self_attn.q_proj": (w, w),
                             "self_attn.k_proj": (w, w),
                             "self_attn.v_proj": (w, w),
                             "self_attn.out_proj": (w, w),
                             "mlp.fc1": (4 * w, w),
                             "mlp.fc2": (w, 4 * w)}.items():
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = r(o, n), r(o)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = 1 + r(w), r(w)
    return sd


@pytest.mark.parametrize("layout", ["openai", "hf"])
def test_vision_converters_match_jax(layout):
    """A 336²-grid checkpoint into the 728² tower (target_grid 52)."""
    rs = np.random.RandomState(11)
    if layout == "openai":
        sd = _openai_sd(rs)
        tree = jconvert.clip_vision_params(sd, LAYERS, target_grid=52)
        got = clip_vision_state_dict(sd, LAYERS, target_grid=52)
    else:
        sd = _hf_sd(rs)
        tree = jconvert.clip_vision_params_from_hf(sd, LAYERS, target_grid=52)
        got = clip_vision_state_dict_from_hf(sd, LAYERS, target_grid=52)
    want = flax_to_state_dict(tree)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        atol = 1e-5 if name == "positional_embedding" else 0
        torch.testing.assert_close(got[name], value, rtol=0, atol=atol,
                                   msg=name)
    tower = TorchVisionTower(WIDTH, LAYERS, 1, PATCH, 32, image_res=52 * 14)
    tower.load_state_dict(got, strict=True)
    image = np.random.RandomState(12).randn(1, 728, 728, 3).astype(
        np.float32)
    jax_tower = CLIPVisionTower(WIDTH, LAYERS, 1, PATCH, 32)
    want_out = np.asarray(jax_tower.apply({"params": tree},
                                          jnp.asarray(image)))
    with torch.no_grad():
        out = tower(torch.from_numpy(image))
    assert out.shape == (1, 2705, 32)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-4)


def test_hires_tower_has_2705_tokens():
    """The slice's tower (ViT-L/14 at 728²) holds 52 × 52 + 1 position
    rows, and its attention at 16 heads is past fits_chunked in bf16 and
    f32 (and at 336², 577 tokens, chunked)."""
    cfg = torch_tiny_config(**{**HIRES, "model.vision.image_res": 728})
    tower, _ = build_vision_tower(cfg.model.vision)
    assert tower.positional_embedding.shape[0] == 2705
    q = torch.empty(8, 16, 2705, 64, dtype=torch.bfloat16, device="meta")
    assert port_fa.regime(q, q) == "tiled"
    assert port_fa.regime(q.float(), q.float()) == "tiled"
    assert port_fa.regime(q[:, :, :577], q[:, :, :577]) == "chunked"
