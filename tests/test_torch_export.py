"""Export to the reference's format (leccr_torch.models.weights.
export_reference_state_dict, save_reference_checkpoint) against the JAX
package's export of the same weights: the same keys, bit for bit; and
export then import is the identity on every live parameter.  The video
model's temporal tower goes out and comes back as the reference's
`vid_encoder.*`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import leccr_torch.models.clip as tclip
import leccr_tpu.models.clip as jclip
import leccr_tpu.models.weights as jweights
from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.weights import (
    export_reference_state_dict,
    load_initial_checkpoint,
    load_jax_params,
    save_reference_checkpoint,
)
from leccr_tpu.config import tiny_test_config
from leccr_tpu.models.leccr import LECCRModel

CASES = {
    "mbert": {},
    "clip_caption": {"model.caption_encoder_name": "clip"},
    "one_proj_deeper": {"model.use_one_cl_proj_only": True,
                        "model.caption_ca_layer": 2,
                        "model.caption_interaction_layer": 3},
    "xlmr": {"model.text.kind": "xlmr", "model.text.type_vocab_size": 1,
             "model.text.pad_token_id": 1,
             "model.text.max_position_embeddings": 66},
    "video": {"model.vision.kind": "temporal",
              "model.vision.frame_feat_dim": 48, "model.vision.num_heads": 4,
              "model.vision.num_layers": 2, "model.vision.max_frames": 6,
              "model.num_queries": 2},
}


@pytest.fixture(autouse=True)
def tiny_variant(monkeypatch):
    for mod in (jclip, tclip):
        monkeypatch.setitem(mod.CLIP_VARIANTS, "tiny/32", mod.CLIPVariant(
            64, 2, 2, 32, 64, 48, 2, 4, vocab_size=600, context_length=77))


def _pair(case, seed=0):
    overrides = {"model.vision.variant": "tiny/32", **CASES[case]}
    cfg = tiny_test_config(**overrides)
    rs = np.random.RandomState(seed)
    res = cfg.model.vision.image_res
    ids = rs.randint(2, 100, (1, 8)).astype(np.int32)
    batch = {"vision": np.zeros((1, res, res, 3), np.float32),
             "text_ids_s": ids, "text_mask_s": np.ones_like(ids),
             "text_ids_t": ids, "text_mask_t": np.ones_like(ids),
             "caption_ids": ids, "caption_mask": np.ones_like(ids)}
    vision = cfg.model.vision
    if vision.kind == "temporal":
        batch["vision"] = np.zeros((1, vision.max_frames,
                                    vision.frame_feat_dim), np.float32)
        batch["vision_mask"] = np.ones((1, vision.max_frames), bool)
    params = LECCRModel(cfg.model).init(
        {"params": jax.random.PRNGKey(seed)},
        jax.tree.map(jnp.asarray, batch))["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    port = TorchLECCR(torch_tiny_config(**overrides).model, device="cpu")
    load_jax_params(port, params)
    return cfg, params, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_equals_jax(case):
    cfg, params, port = _pair(case)
    want = jweights.export_reference_state_dict(params, cfg)
    got = export_reference_state_dict(port)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)
    assert got["temp"].shape == () and got["queries"].ndim == 3
    assert "caption_encoder.embeddings.word_embeddings.weight" in got


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_then_import_is_the_identity(tmp_path, case):
    _, _, port = _pair(case)
    path = tmp_path / "exported.pth"
    save_reference_checkpoint(export_reference_state_dict(port), str(path))
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    assert loaded["temp"].ndim == 0
    # every tensor in a storage of its own: no view of a larger one
    assert all(v.untyped_storage().nbytes() == v.numel() * v.element_size()
               for v in loaded.values())
    fresh = TorchLECCR(port.cfg, device="cpu", seed=5)
    report = load_initial_checkpoint(str(path), fresh)
    assert report.issues == []
    assert sorted(report.grafted) == sorted(port.state_dict())
    want = port.state_dict()
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, want[key]), key


def test_jax_export_imports_into_the_port_bit_for_bit(tmp_path):
    """A reference .pth written by the JAX package's export loads into the
    port as the JAX model's parameters."""
    cfg, params, port = _pair("clip_caption", seed=3)
    path = tmp_path / "jax_exported.pth"
    jweights.save_reference_checkpoint(
        jweights.export_reference_state_dict(params, cfg), str(path))
    fresh = TorchLECCR(port.cfg, device="cpu", seed=9)
    load_initial_checkpoint(str(path), fresh)
    want = port.state_dict()
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, want[key]), key


def test_jax_video_export_imports_into_the_port_bit_for_bit(tmp_path):
    """A reference .pth of the video model written by the JAX package's
    export (its temporal tower as `vid_encoder.*`) loads into the port as
    the JAX model's parameters, with nothing left over."""
    cfg, params, port = _pair("video", seed=4)
    sd = jweights.export_reference_state_dict(params, cfg)
    assert any(k.startswith("vid_encoder.layers.1.") for k in sd)
    path = tmp_path / "jax_video.pth"
    jweights.save_reference_checkpoint(sd, str(path))
    fresh = TorchLECCR(port.cfg, device="cpu", seed=9)
    report = load_initial_checkpoint(str(path), fresh)
    assert report.issues == []
    want = port.state_dict()
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, want[key]), key
