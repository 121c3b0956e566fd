"""The port's CLIP vision tower and BERT encoder against the JAX package's
flax modules at the same params (converted by the port's weight bridge),
in f32 on the CPU, atol 1e-4.  Params are perturbed away from their init
so that LayerNorm scales/biases and zero-init biases are really mapped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.config import TextConfig as TorchTextConfig
from leccr_torch.models.bert import BertEncoder as TorchBert
from leccr_torch.models.clip import CLIPVisionTower as TorchCLIP
from leccr_torch.models.weights import flax_to_state_dict
from leccr_tpu.config import TextConfig
from leccr_tpu.models.bert import BertEncoder
from leccr_tpu.models.clip import CLIPVisionTower

ATOL = 1e-4


def _perturbed(params, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)


@pytest.mark.parametrize("scan", [False, True])
def test_clip_vision_tower_matches_flax(scan):
    width, layers, heads, patch, embed, res = 64, 2, 2, 16, 32, 64
    rs = np.random.RandomState(0)
    images = rs.randn(2, res, res, 3).astype(np.float32)
    flax_tower = CLIPVisionTower(width, layers, heads, patch, embed,
                                 scan_layers=scan)
    params = flax_tower.init(jax.random.PRNGKey(0),
                             jnp.asarray(images))["params"]
    params = _perturbed(params, seed=1)
    want = np.asarray(flax_tower.apply({"params": params},
                                       jnp.asarray(images)))

    tower = TorchCLIP(width, layers, heads, patch, embed, res)
    tower.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.inference_mode():
        got = tower(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 1 + (res // patch) ** 2, embed)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind,scan", [("bert", False), ("xlmr", False),
                                       ("bert", True)])
def test_bert_encoder_matches_flax(kind, scan):
    kw = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=40, kind=kind,
              pad_token_id=1 if kind == "xlmr" else 0)
    rs = np.random.RandomState(2)
    ids = rs.randint(2, 97, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0  # padded rows
    mask[2, 3:] = 0
    ids[mask == 0] = kw["pad_token_id"]
    flax_enc = BertEncoder(TextConfig(**kw), scan_layers=scan)
    params = flax_enc.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                           jnp.asarray(mask))["params"]
    params = _perturbed(params, seed=3)
    want = np.asarray(flax_enc.apply({"params": params}, jnp.asarray(ids),
                                     jnp.asarray(mask)))

    enc = TorchBert(TorchTextConfig(**kw))
    enc.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(ids).long(),
                  torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
