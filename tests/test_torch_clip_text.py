"""The CLIP text tower (leccr_torch.models.clip.CLIPTextTower) and the
`caption_encoder_name: clip` model against the JAX package's at the same
params (f32, CPU): the tower's pooled and hidden outputs within 1e-5, the
model's embeddings and its five losses within test_torch_model.py's 1e-4,
and no gradient into the tower.  Both packages get a small CLIP variant,
"tiny/32" (ViT width 64, text tower 48 wide, 2 layers, 4 heads)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import leccr_torch.models.clip as tclip
import leccr_tpu.models.clip as jclip
from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.models import losses as port_losses
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.weights import (
    flax_to_state_dict,
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from leccr_tpu.config import tiny_test_config
from leccr_tpu.models import losses as ref_losses
from leccr_tpu.models.leccr import LECCRModel

TOWER_ATOL = 1e-5
ATOL = 1e-4  # tests/test_torch_model.py's
B, L = 3, 12
VOCAB = 600
EOT = VOCAB - 1


@pytest.fixture(autouse=True)
def tiny_variant(monkeypatch):
    for mod in (jclip, tclip):
        monkeypatch.setitem(mod.CLIP_VARIANTS, "tiny/32", mod.CLIPVariant(
            64, 2, 2, 32, 64, 48, 2, 4, vocab_size=VOCAB, context_length=77))


def _caption_ids(rs, length=L):
    """SOT … EOT then 0-padding, EOT at different positions (EOT is the
    largest id, as in CLIP's vocabulary)."""
    ids = np.zeros((B, length), np.int32)
    for row, n in enumerate((length, 7, 3)):
        ids[row, 0] = EOT - 1
        ids[row, 1:n - 1] = rs.randint(1, EOT - 1, n - 2)
        ids[row, n - 1] = EOT
    return ids


def _perturbed(params, rs, scale=0.05):
    return jax.tree.map(
        lambda x: np.asarray(x + scale * rs.randn(*np.shape(x)), np.float32),
        params)


def test_text_tower_matches_jax():
    rs = np.random.RandomState(0)
    ids = _caption_ids(rs)
    tower = jclip.CLIPTextTower(width=48, layers=2, heads=4, embed_dim=64,
                                vocab_size=VOCAB)
    params = _perturbed(tower.init(jax.random.PRNGKey(0),
                                   jnp.asarray(ids))["params"], rs)
    want_pooled, want_hidden = tower.apply({"params": params},
                                           jnp.asarray(ids))
    port = tclip.CLIPTextTower(width=48, layers=2, heads=4, embed_dim=64,
                               vocab_size=VOCAB)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        pooled, hidden = port(torch.from_numpy(ids).long())
    assert hidden.shape == (B, L, 64) and pooled.shape == (B, 64)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden),
                               rtol=0, atol=TOWER_ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               rtol=0, atol=TOWER_ATOL)
    # pooled is the EOT row, and causal: a token never sees a later one
    eot = ids.argmax(-1)
    torch.testing.assert_close(pooled, hidden[torch.arange(B), eot],
                               rtol=0, atol=0)
    changed = ids.copy()
    changed[:, 6:] = 5
    with torch.no_grad():
        _, hidden2 = port(torch.from_numpy(changed).long())
    torch.testing.assert_close(hidden2[:, :6], hidden[:, :6], rtol=0,
                               atol=1e-6)


def _cfgs():
    cfg = tiny_test_config()
    cfg.model.vision.variant = "tiny/32"
    cfg.model.caption_encoder_name = "clip"
    tcfg = torch_tiny_config(**{"model.vision.variant": "tiny/32",
                                "model.caption_encoder_name": "clip"})
    return cfg, tcfg


@pytest.fixture
def clip_setup(tiny_variant):
    cfg, tcfg = _cfgs()
    model = LECCRModel(cfg.model)
    rs = np.random.RandomState(1)
    res = cfg.model.vision.image_res
    ids = rs.randint(5, 512, (B, 16)).astype(np.int32)
    mask = np.ones((B, 16), np.int32)
    mask[1, 9:] = 0
    cap = _caption_ids(rs)
    batch = {
        "vision": rs.randn(B, res, res, 3).astype(np.float32),
        "text_ids_s": ids, "text_mask_s": mask,
        "text_ids_t": ids[::-1].copy(), "text_mask_t": mask[::-1].copy(),
        "caption_ids": cap, "caption_mask": (cap != 0).astype(np.int32),
    }
    params = _perturbed(model.init({"params": jax.random.PRNGKey(0)},
                                   jax.tree.map(jnp.asarray, batch))
                        ["params"], rs)
    port = TorchLECCR(tcfg.model, device="cpu")
    load_jax_params(port, params)
    return cfg, tcfg, model, params, port, batch


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_clip_caption_model_state_dict_round_trips(clip_setup):
    _, tcfg, _, params, port, _ = clip_setup
    assert port.clip_text_tower is not None
    assert port.caption_proj.in_features == 64  # the vision width
    assert port.clip_text_tower.token_embedding.weight.shape == (VOCAB, 48)
    back = params_to_jax(port.state_dict(), tcfg.model)
    assert set(params_from_jax(back, tcfg.model)) == set(port.state_dict())
    np.testing.assert_array_equal(
        back["clip_text_tower"]["transformer"]["resblock_1"]["attn"]
        ["in_proj"]["kernel"],
        params["clip_text_tower"]["transformer"]["resblock_1"]["attn"]
        ["in_proj"]["kernel"])


@pytest.mark.parametrize("fused", [True, False])
def test_clip_caption_embed_images_matches_jax(clip_setup, fused):
    cfg, _, model, params, port, batch = clip_setup
    img = {k: batch[k] for k in ("vision", "caption_ids", "caption_mask")}
    cfg.model.fused_eval_attention = fused
    want = LECCRModel(cfg.model).apply(
        {"params": params}, jax.tree.map(jnp.asarray, img),
        method="embed_images")
    port.cfg = dataclasses.replace(port.cfg, fused_eval_attention=fused)
    got = port.embed_images(_t(img))
    for key in ("feat", "slots"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL)


def test_clip_caption_losses_match_jax_and_no_gradient_reaches_tower(
        clip_setup):
    cfg, _, model, params, port, batch = clip_setup
    idx = np.arange(B, dtype=np.int32)
    kw = dict(weight_caption_loss=cfg.model.weight_caption_loss,
              weight_reg_loss=cfg.model.weight_reg_loss,
              weight_dstl_loss=cfg.model.weight_dstl_loss,
              weight_cv_loss=cfg.model.weight_cv_loss)

    def jax_loss(p):
        emb = model.apply({"params": p}, jax.tree.map(jnp.asarray, batch))
        losses = ref_losses.compute_losses(emb, jnp.asarray(idx), **kw)
        return losses["total"], losses

    (_, want), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    emb = port(_t(batch))
    got = port_losses.compute_losses(emb, torch.from_numpy(idx), **kw)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
    got["total"].backward()
    tower = dict(port.clip_text_tower.named_parameters())
    assert tower and all(p.grad is None for p in tower.values())
    assert all(not np.any(np.asarray(g))
               for g in jax.tree.leaves(grads["clip_text_tower"]))
    assert port.caption_proj.weight.grad is not None


def test_train_steps_leave_the_clip_tower_where_it_was(clip_setup):
    """Two AdamW steps with weight decay: the CLIP tower (no gradient, no
    optimizer group, as the JAX trainer's frozen_paths) keeps every bit;
    the rest of the model trains."""
    from leccr_torch.train.step import make_train_step

    _, tcfg, _, _, port, batch = clip_setup
    step = make_train_step(tcfg, port, total_steps=4)
    tower = {k: v.clone()
             for k, v in port.clip_text_tower.state_dict().items()}
    proj = port.vision_tower.proj.detach().clone()
    rs = np.random.RandomState(2)
    for step_no in range(2):
        train = dict(_t(batch), idx=torch.arange(B),
                     vision=torch.from_numpy(rs.randint(
                         0, 256, batch["vision"].shape).astype(np.uint8)))
        losses = step(train, step_no)
        assert all(np.isfinite(v) for v in losses.values())
    for key, value in port.clip_text_tower.state_dict().items():
        assert torch.equal(value, tower[key]), key
    assert not torch.equal(port.vision_tower.proj, proj)
