"""Weights between the JAX package and the port: a flax param tree ↔ the
port's state_dict.

The tree is nested dicts of numpy arrays (e.g. `jax.tree.map(np.asarray,
params)`).  Names carry over, with these rewrites:

- Dense `kernel [in, out]` → `weight = kernel.T`;
- the patch conv `kernel [kh, kw, in, out]` → `weight [out, kh·kw·in]`
  (the port's patch embedding is a matmul over flattened patches);
- LayerNorm `scale` → `weight`, Embed `embedding` → `weight`;
- unscanned blocks `layer_{i}` / `resblock_{i}` → `layers.{i}` /
  `resblocks.{i}`, and scan-stacked blocks (`layers/layer/...`,
  `resblocks/block/...`, every leaf with a leading layer axis) are unstacked
  into the same names;
- raw params (`queries`, `temp`, `class_embedding`, `positional_embedding`,
  `proj`) as they are.

flax's `nn.remat` keeps the module names it wraps, so the trees of a
`remat: true` model (scanned or not) load with the same rules.

`flax_paths` gives each parameter of a port module its flax path, from the
module's type (a LayerNorm `weight` is flax's `scale`, an Embed `weight` its
`embedding`), and `params_to_jax` uses it to export a port state_dict as an
unscanned flax tree that the JAX package loads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from leccr_torch.config import ModelConfig
from leccr_torch.ops.attention import Dense, Embed

# scan-stacked containers: (outer name, inner name) -> per-layer list name
_STACKED = {("layers", "layer"): "layers", ("resblocks", "block"): "resblocks"}
_UNSCANNED = re.compile(r"^(layer|resblock)_(\d+)$")
_LISTS = {"layers": "layer", "resblocks": "resblock"}


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), np.array(val, np.float32)  # a writable copy


def _unstack(path: Tuple[str, ...], leaf: np.ndarray
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for i in range(len(path) - 1):
        name = _STACKED.get((path[i], path[i + 1]))
        if name is not None:
            for layer in range(leaf.shape[0]):
                yield from _unstack(
                    path[:i] + (name, str(layer)) + path[i + 2:], leaf[layer])
            return
    yield path, leaf


def _torch_name(path: Tuple[str, ...], leaf: np.ndarray
                ) -> Tuple[str, np.ndarray]:
    parts = []
    for part in path[:-1]:
        m = _UNSCANNED.match(part)
        parts += [m.group(1) + "s", m.group(2)] if m else [part]
    last = path[-1]
    if last == "kernel":
        last = "weight"
        leaf = (leaf.reshape(-1, leaf.shape[-1]).T if leaf.ndim == 4
                else leaf.T)
    elif last in ("scale", "embedding"):
        last = "weight"
    return ".".join(parts + [last]), np.array(leaf, order="C")


def flax_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert any flax param (sub)tree of the JAX package's modules into
    the state_dict of the matching port module (f32 tensors on the CPU)."""
    sd = {}
    for path, leaf in _leaves(tree):
        for upath, uleaf in _unstack(path, leaf):
            name, value = _torch_name(upath, uleaf)
            sd[name] = torch.from_numpy(value)
    return sd


def params_from_jax(params: Mapping[str, Any],
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The state_dict of `LECCRModel(cfg)` holding the JAX model's params."""
    if cfg.vision.kind != "clip_vit" or cfg.caption_encoder_name != "mbert":
        raise NotImplementedError(
            "this slice of the port holds the clip_vit + mbert model only")
    return flax_to_state_dict(params)


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, Any]) -> None:
    """Load the JAX model's params into a port `LECCRModel`, strictly
    (every key on both sides, matching shapes); values are cast to each
    parameter's dtype and device."""
    model.load_state_dict(params_from_jax(params, model.cfg), strict=True)


def _flax_module_path(name: str) -> Tuple[str, ...]:
    """`text_encoder.layers.3.attention` -> (text_encoder, layer_3,
    attention)."""
    parts, out = name.split(".") if name else [], []
    i = 0
    while i < len(parts):
        if parts[i] in _LISTS and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{_LISTS[parts[i]]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out)


def flax_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """Each parameter name of a port module -> its flax path (unscanned),
    by the type of the module that holds it."""
    paths = {}
    for mod_name, module in model.named_modules():
        prefix = _flax_module_path(mod_name)
        for leaf, _ in module.named_parameters(recurse=False):
            if isinstance(module, nn.LayerNorm):
                flax_leaf = {"weight": "scale"}.get(leaf, leaf)
            elif isinstance(module, Embed):
                flax_leaf = "embedding"
            elif isinstance(module, Dense):
                flax_leaf = {"weight": "kernel"}.get(leaf, leaf)
            else:
                flax_leaf = leaf
            full = f"{mod_name}.{leaf}" if mod_name else leaf
            paths[full] = prefix + (flax_leaf,)
    return paths


def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of `params_from_jax`: a `LECCRModel(cfg)` state_dict as
    the JAX model's unscanned flax param tree (nested dicts of f32 numpy
    arrays), which `LECCRModel.apply` of the JAX package takes."""
    from leccr_torch.models.leccr import LECCRModel

    skeleton = LECCRModel(cfg, device="meta")
    paths = flax_paths(skeleton)
    if set(paths) != set(state_dict):
        raise ValueError(
            f"state_dict does not match LECCRModel(cfg): missing "
            f"{sorted(set(paths) - set(state_dict))[:5]}, unexpected "
            f"{sorted(set(state_dict) - set(paths))[:5]}")
    patch = skeleton.vision_tower.patch_size
    tree: Dict[str, Any] = {}
    for name, value in state_dict.items():
        path = paths[name]
        leaf = value.detach().float().cpu().numpy()
        if path[-1] == "kernel":
            leaf = leaf.T
            if name == "vision_tower.conv1.weight":
                leaf = leaf.reshape(patch, patch, 3, -1)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(leaf, order="C")
    return tree
