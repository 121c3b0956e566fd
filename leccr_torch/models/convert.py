"""Checkpoint import for the vision tower: OpenAI CLIP and HuggingFace CLIP
state_dicts → the port's `CLIPVisionTower` state_dict.

The port of the vision half of `leccr_tpu/models/convert.py`
(`clip_vision_params`, `clip_vision_params_from_hf`).  Where the JAX package
builds a flax param tree, these map straight to the names and layouts of
`leccr_torch.models.clip.CLIPVisionTower`: Linear weights stay [out, in],
the patch convolution [out, in, kh, kw] becomes the port's matmul weight
[out, kh·kw·in], HF's separate q/k/v projections are packed into `in_proj`.
`target_grid` resamples the position embedding to another resolution's
patch grid (`interpolate_pos_embed`): e.g. OpenAI's ViT-L/14@336 (24×24
patches) into the 728² tower (52×52) of the high-resolution
configuration.  Load the result with `tower.load_state_dict(sd)`.

Inputs are flat mappings of str to torch tensors or numpy arrays; outputs
are f32 tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from leccr_torch.models.clip import interpolate_pos_embed


def _t(x: Any) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.detach().to(torch.float32).contiguous()


def _patch_weight(conv: torch.Tensor) -> torch.Tensor:
    """Conv [out, in, kh, kw] → the port's patch matmul [out, kh·kw·in]."""
    return conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1)


def _copy(out: Dict[str, torch.Tensor], sd: Mapping[str, Any], src: str,
          dst: str, bias: bool = True) -> None:
    out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
    if bias:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def _position(sd: Mapping[str, Any], key: str,
              target_grid: Optional[int]) -> torch.Tensor:
    pos = _t(sd[key])
    return pos if target_grid is None else interpolate_pos_embed(
        pos, target_grid)


def clip_vision_state_dict(sd: Mapping[str, Any], num_layers: int,
                           target_grid: Optional[int] = None,
                           prefix: str = "visual") -> Dict[str, torch.Tensor]:
    """OpenAI CLIP `visual.*` state_dict → CLIPVisionTower state_dict.

    target_grid: the patch-grid side at the training resolution (52 for
    728/14); the checkpoint's position embedding is resampled bicubically
    (reference clip/model.py:414-419)."""
    p = prefix
    out = {
        "conv1.weight": _patch_weight(_t(sd[f"{p}.conv1.weight"])),
        "class_embedding": _t(sd[f"{p}.class_embedding"]),
        "positional_embedding": _position(sd, f"{p}.positional_embedding",
                                          target_grid),
        "proj": _t(sd[f"{p}.proj"]),
    }
    _copy(out, sd, f"{p}.ln_pre", "ln_pre")
    _copy(out, sd, f"{p}.ln_post", "ln_post")
    for i in range(num_layers):
        src, dst = f"{p}.transformer.resblocks.{i}", f"transformer.resblocks.{i}"
        out[f"{dst}.attn.in_proj.weight"] = _t(sd[f"{src}.attn.in_proj_weight"])
        out[f"{dst}.attn.in_proj.bias"] = _t(sd[f"{src}.attn.in_proj_bias"])
        for a, b in (("attn.out_proj", "attn.out_proj"), ("ln_1", "ln_1"),
                     ("ln_2", "ln_2"), ("mlp.c_fc", "c_fc"),
                     ("mlp.c_proj", "c_proj")):
            _copy(out, sd, f"{src}.{a}", f"{dst}.{b}")
    return out


def clip_vision_state_dict_from_hf(
    sd: Mapping[str, Any],
    num_layers: int,
    target_grid: Optional[int] = None,
    prefix: str = "vision_model",
    projection_key: str = "visual_projection.weight",
) -> Dict[str, torch.Tensor]:
    """HF CLIPVisionModel(WithProjection) state_dict → CLIPVisionTower
    state_dict; without `projection_key` the projection is the identity."""
    p = prefix
    conv = _t(sd[f"{p}.embeddings.patch_embedding.weight"])
    proj = (_t(sd[projection_key]).T.contiguous() if projection_key in sd
            else torch.eye(conv.shape[0]))
    out = {
        "conv1.weight": _patch_weight(conv),
        "class_embedding": _t(sd[f"{p}.embeddings.class_embedding"]),
        "positional_embedding": _position(
            sd, f"{p}.embeddings.position_embedding.weight", target_grid),
        "proj": proj,
    }
    _copy(out, sd, f"{p}.pre_layrnorm", "ln_pre")
    _copy(out, sd, f"{p}.post_layernorm", "ln_post")
    for i in range(num_layers):
        src, dst = f"{p}.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for part in ("weight", "bias"):
            out[f"{dst}.attn.in_proj.{part}"] = torch.cat(
                [_t(sd[f"{src}.self_attn.{n}_proj.{part}"])
                 for n in ("q", "k", "v")])
        for a, b in (("self_attn.out_proj", "attn.out_proj"),
                     ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                     ("mlp.fc1", "c_fc"), ("mlp.fc2", "c_proj")):
            _copy(out, sd, f"{src}.{a}", f"{dst}.{b}")
    return out
