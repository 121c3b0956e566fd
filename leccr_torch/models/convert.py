"""Checkpoint import: OpenAI CLIP, HuggingFace CLIP and HuggingFace
BERT/XLM-R state_dicts → the state_dicts of the port's towers.

The port of `leccr_tpu/models/convert.py`.  Where the JAX package builds a
flax param tree, these map straight to the names and layouts of the port's
modules: Linear weights stay [out, in], the patch convolution [out, in, kh,
kw] becomes the port's matmul weight [out, kh·kw·in], HF's separate q/k/v
projections are packed into `in_proj` (and torch's packed
nn.MultiheadAttention `in_proj` is split into q/k/v for the cross-attention
blocks).  `target_grid` resamples the position embedding to another
resolution's patch grid (`interpolate_pos_embed`): e.g. OpenAI's ViT-B/32
at 224² (7×7 patches) into the flagship's 384² tower (12×12).  Load the
result with `tower.load_state_dict(sd)`, or through `models.weights`,
which grafts it into a whole model.

Inputs are flat mappings of str to torch tensors or numpy arrays; outputs
are f32 tensors.  Files are read by `load_torch_state_dict` (TorchScript
archives and `torch.save` pickles) and `load_safetensors` (the port's own
reader of the format: the card's machine has no `safetensors` package).
"""

from __future__ import annotations

import json
import os
import struct
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


def _clip_blocks(out: Dict[str, torch.Tensor], sd: Mapping[str, Any],
                 prefix: str, num_layers: int) -> None:
    """OpenAI CLIP `{prefix}.resblocks.{i}` → `transformer.resblocks.{i}`."""
    for i in range(num_layers):
        src, dst = f"{prefix}.resblocks.{i}", f"transformer.resblocks.{i}"
        out[f"{dst}.attn.in_proj.weight"] = _t(sd[f"{src}.attn.in_proj_weight"])
        out[f"{dst}.attn.in_proj.bias"] = _t(sd[f"{src}.attn.in_proj_bias"])
        for a, b in (("attn.out_proj", "attn.out_proj"), ("ln_1", "ln_1"),
                     ("ln_2", "ln_2"), ("mlp.c_fc", "c_fc"),
                     ("mlp.c_proj", "c_proj")):
            _copy(out, sd, f"{src}.{a}", f"{dst}.{b}")


def _hf_clip_blocks(out: Dict[str, torch.Tensor], sd: Mapping[str, Any],
                    prefix: str, num_layers: int) -> None:
    """HF CLIPEncoderLayer `{prefix}.encoder.layers.{i}` →
    `transformer.resblocks.{i}` (q/k/v packed into in_proj)."""
    for i in range(num_layers):
        src, dst = f"{prefix}.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for part in ("weight", "bias"):
            out[f"{dst}.attn.in_proj.{part}"] = torch.cat(
                [_t(sd[f"{src}.self_attn.{n}_proj.{part}"])
                 for n in ("q", "k", "v")])
        for a, b in (("self_attn.out_proj", "attn.out_proj"),
                     ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                     ("mlp.fc1", "c_fc"), ("mlp.fc2", "c_proj")):
            _copy(out, sd, f"{src}.{a}", f"{dst}.{b}")


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
    _clip_blocks(out, sd, f"{p}.transformer", num_layers)
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
    _hf_clip_blocks(out, sd, p, num_layers)
    return out


def clip_text_state_dict(sd: Mapping[str, Any], num_layers: int
                         ) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP text transformer (`token_embedding`, `transformer.*`,
    ...) → CLIPTextTower state_dict."""
    out = {
        "token_embedding.weight": _t(sd["token_embedding.weight"]),
        "positional_embedding": _t(sd["positional_embedding"]),
        "text_projection": _t(sd["text_projection"]),
    }
    _copy(out, sd, "ln_final", "ln_final")
    _clip_blocks(out, sd, "transformer", num_layers)
    return out


def clip_text_state_dict_from_hf(
    sd: Mapping[str, Any],
    num_layers: int,
    prefix: str = "text_model",
    projection_key: str = "text_projection.weight",
) -> Dict[str, torch.Tensor]:
    """HF CLIPTextModel(WithProjection) state_dict → CLIPTextTower
    state_dict; without `projection_key` the projection is the identity."""
    emb = _t(sd[f"{prefix}.embeddings.token_embedding.weight"])
    proj = (_t(sd[projection_key]).T.contiguous() if projection_key in sd
            else torch.eye(emb.shape[1]))
    out = {
        "token_embedding.weight": emb,
        "positional_embedding": _t(
            sd[f"{prefix}.embeddings.position_embedding.weight"]),
        "text_projection": proj,
    }
    _copy(out, sd, f"{prefix}.final_layer_norm", "ln_final")
    _hf_clip_blocks(out, sd, prefix, num_layers)
    return out


def bert_state_dict(sd: Mapping[str, Any], num_layers: int,
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """HF BertModel / RobertaModel / XLMRobertaModel state_dict →
    BertEncoder state_dict.  `prefix` is the keys' leading module name
    with its dot ("bert.", "roberta.") or ""."""
    p = prefix
    out = {
        "word_embeddings.weight": _t(
            sd[f"{p}embeddings.word_embeddings.weight"]),
        "position_embeddings.weight": _t(
            sd[f"{p}embeddings.position_embeddings.weight"]),
        "token_type_embeddings.weight": _t(
            sd[f"{p}embeddings.token_type_embeddings.weight"]),
    }
    _copy(out, sd, f"{p}embeddings.LayerNorm", "embeddings_ln")
    for i in range(num_layers):
        src, dst = f"{p}encoder.layer.{i}", f"layers.{i}"
        for a, b in (("attention.self.query", "attention.query"),
                     ("attention.self.key", "attention.key"),
                     ("attention.self.value", "attention.value"),
                     ("attention.output.dense", "attention.out"),
                     ("attention.output.LayerNorm", "attention.out_ln"),
                     ("intermediate.dense", "intermediate"),
                     ("output.dense", "output"),
                     ("output.LayerNorm", "output_ln")):
            _copy(out, sd, f"{src}.{a}", f"{dst}.{b}")
    return out


def mha_state_dict_from_torch(mha_state: Mapping[str, Any], d_model: int
                              ) -> Dict[str, torch.Tensor]:
    """torch nn.MultiheadAttention (packed in_proj) → the port's
    MultiHeadAttention state_dict (q/k/v/out projections)."""
    w = _t(mha_state["in_proj_weight"])
    b = _t(mha_state["in_proj_bias"])
    out = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        rows = slice(i * d_model, (i + 1) * d_model)
        out[f"{name}.weight"] = w[rows].contiguous()
        out[f"{name}.bias"] = b[rows].contiguous()
    out["out_proj.weight"] = _t(mha_state["out_proj.weight"])
    out["out_proj.bias"] = _t(mha_state["out_proj.bias"])
    return out


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A torch checkpoint file's state_dict: a TorchScript archive first
    (OpenAI CLIP downloads are `torch.jit` archives, reference
    clip/clip.py:126-136), else a `torch.save` file, unwrapping a "model"
    entry and a module's `state_dict()`.  `torch.load` unpickles: load only
    files you trust."""
    try:
        return dict(torch.jit.load(path, map_location="cpu").state_dict())
    except (RuntimeError, ValueError):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if hasattr(ckpt, "state_dict"):
        ckpt = ckpt.state_dict()
    return dict(ckpt)


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a `.safetensors` file: an 8-byte little-endian header length,
    a JSON header {name: {"dtype", "shape", "data_offsets": [begin, end]}}
    (plus an optional "__metadata__"), then the raw little-endian tensors,
    offsets counted from the end of the header.  Tensors are CPU copies."""
    blob = bytearray(os.path.getsize(path))  # writable, for frombuffer
    with open(path, "rb") as f:
        f.readinto(blob)
    (n,) = struct.unpack("<Q", blob[:8])
    header = json.loads(blob[8:8 + n])
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(data[begin:end], dtype=dtype)
        out[name] = flat.reshape(shape).clone()
    return out
