"""The port's LECCRModel against the JAX package's at the same params
(tiny_test_config, f32, CPU, atol 1e-4): embed_images with padded captions
and with precomputed caption features, with the fused cross-attention on
and off, and embed_texts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.weights import load_jax_params, params_from_jax
from leccr_tpu.config import tiny_test_config
from leccr_tpu.models.leccr import LECCRModel

ATOL = 1e-4
B, L = 3, 16


@pytest.fixture(scope="module")
def jax_setup():
    cfg = tiny_test_config()
    model = LECCRModel(cfg.model)
    rs = np.random.RandomState(0)
    res = cfg.model.vision.image_res
    ids = rs.randint(5, 512, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    batch = {
        "vision": rs.randn(B, res, res, 3).astype(np.float32),
        "text_ids_s": ids, "text_mask_s": mask,
        "text_ids_t": ids, "text_mask_t": mask,
        "caption_ids": ids, "caption_mask": mask,
    }
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jax.tree.map(jnp.asarray, batch))["params"]
    # move every param off its init (zero query slots, unit LayerNorms)
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    return cfg, model, params, batch


def _torch_model(params, **overrides):
    cfg = torch_tiny_config(**overrides)
    model = TorchLECCR(cfg.model, device="cpu")
    load_jax_params(model, params)
    return model


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("fused", [True, False])
def test_embed_images_matches_jax(jax_setup, fused):
    cfg, model, params, batch = jax_setup
    img_batch = {k: batch[k] for k in ("vision", "caption_ids",
                                       "caption_mask")}
    want = model.apply({"params": params}, jax.tree.map(jnp.asarray,
                                                        img_batch),
                       method="embed_images")
    port = _torch_model(params, **{"model.fused_eval_attention": fused})
    got = port.embed_images(_t(img_batch))
    assert got["feat"].shape == (B, cfg.model.embed_dim)
    assert got["slots"].shape == (B, cfg.model.num_queries,
                                  cfg.model.embed_dim)
    for key in ("feat", "slots"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("fused", [True, False])
def test_caption_feats_path_matches_jax(jax_setup, fused):
    cfg, model, params, batch = jax_setup
    rs = np.random.RandomState(4)
    img_batch = {
        "vision": batch["vision"],
        "caption_feats": rs.randn(B, 7, cfg.model.text.hidden_size).astype(
            np.float32),
        "caption_mask": (np.arange(7)[None, :] < np.array([[7], [5], [2]])
                         ).astype(np.int32),
    }
    want = model.apply({"params": params}, jax.tree.map(jnp.asarray,
                                                        img_batch),
                       method="embed_images")
    port = _torch_model(params, **{"model.fused_eval_attention": fused})
    got = port.embed_images(_t(img_batch))
    for key in ("feat", "slots"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL)


def test_embed_texts_matches_jax(jax_setup):
    _, model, params, batch = jax_setup
    want = model.apply({"params": params}, jnp.asarray(batch["text_ids_s"]),
                       jnp.asarray(batch["text_mask_s"]),
                       method="embed_texts")
    got = _torch_model(params).embed_texts(
        torch.from_numpy(batch["text_ids_s"]).long(),
        torch.from_numpy(batch["text_mask_s"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_state_dict_is_complete_and_exact(jax_setup):
    _, _, params, _ = jax_setup
    cfg = torch_tiny_config()
    sd = params_from_jax(params, cfg.model)
    port = TorchLECCR(cfg.model, device="cpu")
    assert set(sd) == set(port.state_dict())
    load_jax_params(port, params)
    np.testing.assert_array_equal(
        port.state_dict()["text_encoder.layers.1.attention.query.weight"],
        np.asarray(params["text_encoder"]["layer_1"]["attention"]["query"]
                   ["kernel"]).T)
    # the caption encoder is the text tower itself: no second copy
    assert not any(k.startswith("caption_encoder") for k in sd)


def test_bf16_model_runs_and_normalizes(jax_setup):
    """The compute-dtype path (f32 master weights, bf16 compute, f32
    LayerNorm statistics) on the CPU: finite unit-norm features close to
    the f32 model's."""
    _, _, params, batch = jax_setup
    img_batch = _t({k: batch[k] for k in ("vision", "caption_ids",
                                          "caption_mask")})
    f32 = _torch_model(params).embed_images(img_batch)["feat"]
    bf16_model = _torch_model(params, **{"model.dtype": "bfloat16"})
    assert all(p.dtype == torch.float32 for p in bf16_model.parameters())
    with torch.inference_mode():
        tokens = bf16_model.encode_vision(img_batch["vision"])
    assert tokens.dtype == torch.bfloat16
    feat = bf16_model.embed_images(img_batch)["feat"]
    assert feat.dtype == torch.float32 and torch.isfinite(feat).all()
    torch.testing.assert_close(feat.norm(dim=-1), torch.ones(B),
                               rtol=0, atol=1e-2)
    assert (torch.nn.functional.cosine_similarity(feat, f32) > 0.99).all()


def test_seeded_init_is_reproducible():
    cfg = torch_tiny_config().model
    a = TorchLECCR(cfg, device="cpu", seed=3).state_dict()
    b = TorchLECCR(cfg, device="cpu", seed=3).state_dict()
    c = TorchLECCR(cfg, device="cpu", seed=4).state_dict()
    key = "vision_tower.positional_embedding"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert float(a["temp"]) == pytest.approx(cfg.temp)


def test_unported_configs_and_missing_gpu_raise():
    cfg = torch_tiny_config().model
    video = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, kind="temporal"))
    with pytest.raises(NotImplementedError, match="video"):
        TorchLECCR(video, device="cpu")
    with pytest.raises(NotImplementedError, match="caption encoder"):
        TorchLECCR(dataclasses.replace(cfg, caption_encoder_name="clip"),
                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchLECCR(cfg)
