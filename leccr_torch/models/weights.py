"""Weights in and out of the port: the JAX package's flax param trees,
checkpoints of the reference, OpenAI CLIP and HuggingFace BERT/XLM-R
(`load_initial_checkpoint`), and export back to the reference's format
(`export_reference_state_dict`).

**The JAX package's params** (`params_from_jax`, `params_to_jax`): a flax
param tree ↔ the port's state_dict.

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

**Initial weights** (`load_initial_checkpoint`, the port of
`leccr_tpu/models/weights.py`): a reference `checkpoint_best.pth`, an
OpenAI CLIP archive, a HF BERT/XLM-R checkpoint (`.bin`, `.safetensors` or
a directory holding one) or the port's own `CheckpointManager` step file
(or a directory of them).  The flavor is read off the keys.  Loading is
partial, as the reference's `strict=False` load: each subtree found in the
file is converted (`models.convert`) and grafted into the model's f32
parameters; a converted tensor whose name the model lacks, or whose shape
differs, is listed as an issue and not loaded, and the file's keys that no
converter read (the reference's dead X-VLM parameters, a HF `lm_head`) are
listed as unused.  The lists come back in an `ImportReport` and are
printed as the JAX package prints them.  JAX's orbax directories are not
read: `params_from_jax` (the inverse of `params_to_jax`) brings a JAX
param tree over, or the JAX package's `--task export` writes a reference
`.pth` that this import reads.

**Export** (`export_reference_state_dict`, `save_reference_checkpoint`):
the exact inverse of the reference import, so a model trained here goes
back into reference-based stacks.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from leccr_torch.config import ModelConfig
from leccr_torch.ops.attention import Dense, Embed, RMSNorm
from leccr_torch.ops.moe import ExpertStack

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
    """The state_dict of `LECCRModel(cfg)` holding the JAX model's params
    (image or video: the temporal tower's `vision_tower/encoder/layer_i`
    become `vision_tower.encoder.layers.i`)."""
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
    by the type of the module that holds it: a LayerNorm's or RMSNorm's
    weight is a `scale`, a Dense's weight and each expert stack
    [E, out, in] a `kernel`."""
    paths = {}
    for mod_name, module in model.named_modules():
        prefix = _flax_module_path(mod_name)
        for leaf, _ in module.named_parameters(recurse=False):
            if isinstance(module, ExpertStack):
                paths[f"{mod_name}.{leaf}"] = prefix + (leaf, "kernel")
                continue
            if isinstance(module, (nn.LayerNorm, RMSNorm)):
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
    tree: Dict[str, Any] = {}
    for name, value in state_dict.items():
        path = paths[name]
        leaf = value.detach().float().cpu().numpy()
        if path[-1] == "kernel":
            leaf = leaf.T
            if name == "vision_tower.conv1.weight":
                patch = skeleton.vision_tower.patch_size
                leaf = leaf.reshape(patch, patch, 3, -1)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(leaf, order="C")
    return tree


# ---------------------------------------------------------------- import


class _Reads(Mapping):
    """A read-only view of a state_dict under `prefix` that notes every key
    read through it (in `seen`, shared by all views of one file)."""

    def __init__(self, sd: Mapping[str, Any], prefix: str = "",
                 seen: Optional[set] = None):
        self.sd, self.prefix = sd, prefix
        self.seen = set() if seen is None else seen
        self._keys = [k[len(prefix):] for k in sd if k.startswith(prefix)]

    def __getitem__(self, key: str) -> Any:
        value = self.sd[self.prefix + key]
        self.seen.add(self.prefix + key)
        return value

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and self.prefix + key in self.sd

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def view(self, prefix: str) -> "_Reads":
        return _Reads(self.sd, self.prefix + prefix, self.seen)

    def unused(self) -> List[str]:
        return [k for k in self.sd if k not in self.seen]


@dataclasses.dataclass
class ImportReport:
    """What `load_initial_checkpoint` did.  `flavor`: "reference",
    "openai", "hf" or "port".  `sections`: (label, grafted names, issues)
    per part of the model, in the JAX package's order and labels; an
    issue is `unexpected: <name>` (the model has no such parameter or
    module) or `shape: <name> <file shape> vs <model shape>`.  `unused`:
    the file's keys that no converter read."""

    flavor: str
    sections: List[Tuple[str, List[str], List[str]]] = dataclasses.field(
        default_factory=list)
    unused: List[str] = dataclasses.field(default_factory=list)

    @property
    def grafted(self) -> List[str]:
        return [name for _, g, _ in self.sections for name in g]

    @property
    def issues(self) -> List[str]:
        return ([i for _, _, b in self.sections for i in b]
                + [f"unused: {k}" for k in self.unused])


@torch.no_grad()
def _graft(model: nn.Module, prefix: str, src: Mapping[str, torch.Tensor],
           report: ImportReport, label: str) -> None:
    """Copy each tensor of `src` (names relative to `prefix`) into the
    model's parameter of that name (f32 master, in place, on its device);
    list what does not match, by the first part of the name the model
    lacks (one entry for a whole missing module, as the JAX package lists
    a missing subtree).  Records (label, grafted, issues) in `report` and
    prints them."""
    params = dict(model.named_parameters())
    modules = {name.rsplit(".", i)[0] for name in params
               for i in range(1, name.count(".") + 1)}
    grafted, issues = [], []
    for key, value in src.items():
        name = prefix + key
        if name not in params:
            parts = name.split(".")
            missing = next((".".join(parts[:i]) for i in range(1, len(parts))
                            if ".".join(parts[:i]) not in modules), name)
            issue = f"unexpected: {missing}"
            if issue not in issues:
                issues.append(issue)
        elif tuple(value.shape) != tuple(params[name].shape):
            issues.append(f"shape: {name} {tuple(value.shape)} vs "
                          f"{tuple(params[name].shape)}")
        else:
            params[name].copy_(value)
            grafted.append(name)
    report.sections.append((label, grafted, issues))
    # the JAX package's summary line
    verb = "" if label.startswith("ref ckpt") else "grafted "
    print(f"### {label}: {verb}{len(grafted)} tensors; issues: {issues[:5]}")


def _n_resblocks(sd: Mapping[str, Any], prefix: str, fallback: int) -> int:
    """Layer count of a CLIP transformer stack, read off the state_dict
    (depth-cut towers carry fewer resblocks than the published variant)."""
    pat = re.compile(re.escape(prefix) + r"\.resblocks\.(\d+)\.")
    ns = {int(m.group(1)) for k in sd if (m := pat.match(k))}
    return max(ns) + 1 if ns else fallback


def _clip_into(model: nn.Module, sd: _Reads, report: ImportReport,
               vision_label: str, text_label: str) -> None:
    """The CLIP vision tower (position table resampled to the model's
    patch grid), and the CLIP text tower when it is the caption encoder."""
    from leccr_torch.models.clip import CLIP_VARIANTS
    from leccr_torch.models.convert import (
        clip_text_state_dict,
        clip_vision_state_dict,
    )

    cfg = model.cfg
    var = CLIP_VARIANTS[cfg.vision.variant]
    grid = cfg.vision.image_res // var.patch_size
    vision = clip_vision_state_dict(
        sd, _n_resblocks(sd, "visual.transformer", var.vision_layers),
        target_grid=grid)
    _graft(model, "vision_tower.", vision, report, vision_label)
    if model.clip_text_tower is not None:
        text = clip_text_state_dict(
            sd, _n_resblocks(sd, "transformer", var.text_layers))
        _graft(model, "clip_text_tower.", text, report, text_label)


def load_openai_clip_into(model: nn.Module,
                          sd: Mapping[str, Any]) -> ImportReport:
    """An OpenAI CLIP state_dict (`visual.*`, `transformer.*`, ...) into
    the vision tower, and the CLIP text tower when it is the caption
    encoder."""
    report = ImportReport("openai")
    reads = _Reads(sd)
    _clip_into(model, reads, report, "CLIP vision", "CLIP text")
    report.unused = reads.unused()
    return report


def load_hf_bert_into(model: nn.Module,
                      sd: Mapping[str, Any]) -> ImportReport:
    """A HF BERT-family state_dict into the text tower: BertModel ("bert."
    or no prefix) and RobertaModel / XLMRobertaModel ("roberta." or no
    prefix; the RoBERTa position offset is `text.kind: xlmr`'s, the layout
    is BERT's)."""
    from leccr_torch.models.convert import bert_state_dict

    report = ImportReport("hf")
    reads = _Reads(sd)
    prefix = next((p for p in ("bert.", "roberta.")
                   if any(k.startswith(p) for k in reads)), "")
    converted = bert_state_dict(reads, model.cfg.text.num_layers, prefix)
    _graft(model, "text_encoder.", converted, report, "BERT")
    report.unused = reads.unused()
    return report


_HEAD_DENSE = ("caption_proj", "caption_proj1", "cproj", "vproj",
               "text_proj", "vision_proj")
_STACKS = ("crossattn_query", "crossattn", "crossattn2")


def _reference_head(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference LECCR state_dict's head modules → the port's names at
    the model's root."""
    from leccr_torch.models.convert import _copy, _t, mha_state_dict_from_torch

    out: Dict[str, torch.Tensor] = {}
    for name in _HEAD_DENSE:
        if f"{name}.weight" in sd:
            _copy(out, sd, name, name, bias=f"{name}.bias" in sd)
    if "queries" in sd:
        q = _t(sd["queries"])  # [n, 1, d] -> [n, d]
        out["queries"] = q.reshape(q.shape[0], q.shape[-1])
    if "temp" in sd:
        out["temp"] = _t(sd["temp"]).reshape(())

    def stack(theirs: str, ours: str) -> None:
        i = 0
        while f"{theirs}.layers.{i}.linear1.weight" in sd:
            src, dst = f"{theirs}.layers.{i}", f"{ours}.layers.{i}"
            d_model = sd[f"{src}.linear1.weight"].shape[0]
            attn = mha_state_dict_from_torch(
                {k: sd[f"{src}.multihead_attn.{k}"] for k in (
                    "in_proj_weight", "in_proj_bias", "out_proj.weight",
                    "out_proj.bias")}, d_model)
            out.update({f"{dst}.attn.{k}": v for k, v in attn.items()})
            _copy(out, sd, f"{src}.linear1", f"{dst}.ffn.linear1")
            _copy(out, sd, f"{src}.linear2", f"{dst}.ffn.linear2")
            _copy(out, sd, f"{src}.norm2", f"{dst}.norm")
            i += 1

    for name in _STACKS:
        stack(name, name)
    # the reference's video temporal encoder (SelfAttention, the same
    # block family), which a clip_vit model lists as unexpected
    stack("vid_encoder", "vision_tower.encoder")
    return out


def load_reference_checkpoint_into(model: nn.Module,
                                   sd: Mapping[str, Any]) -> ImportReport:
    """A reference LECCR state_dict (`checkpoint_best.pth`) into the
    towers, the caption branch and the projections."""
    from leccr_torch.models.convert import bert_state_dict

    report = ImportReport("reference")
    reads = _Reads(sd)
    clip = reads.view("clip_encoder.")
    if len(clip):
        _clip_into(model, clip, report, "ref ckpt vision",
                   "ref ckpt clip text")
    bert = reads.view("text_encoder.")
    if len(bert):
        conv = bert_state_dict(bert, model.cfg.text.num_layers)
        _graft(model, "text_encoder.", conv, report, "ref ckpt text")
        # the reference registers the shared tower a second time as its
        # caption encoder: the same tensors, read with text_encoder.*
        reads.seen.update(k for k in reads.sd
                          if k.startswith("caption_encoder."))
    _graft(model, "", _reference_head(reads), report, "ref ckpt head")
    report.unused = reads.unused()
    return report


def _stage(path: str) -> str:
    """A local copy of a hdfs:// checkpoint (reference
    utils/torch_io.py:15-31 semantics); other paths as they are."""
    if not path.startswith("hdfs://"):
        return path
    import tempfile

    from leccr_torch.utils import io as lio

    local = Path(tempfile.mkdtemp(prefix="leccr_ckpt_")) / Path(path).name
    lio.copy(path, str(local))
    return str(local)


def read_state_dict(path: str) -> Tuple[Dict[str, Any], str]:
    """(state_dict, the file it came from) of a checkpoint path: a
    `.safetensors` file, a torch file (`convert.load_torch_state_dict`),
    a directory of the port's step files (the newest; also under
    `checkpoints/`) or a HF directory (its `pytorch_model*.bin` or
    `*.safetensors`).  An orbax directory raises."""
    from leccr_torch.models.convert import (
        load_safetensors,
        load_torch_state_dict,
    )
    from leccr_torch.train.checkpoints import newest_step_file

    p = Path(path)
    if p.is_dir():
        if (p / "_CHECKPOINT_METADATA").exists():
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package; the port "
                "reads its own CheckpointManager files and reference-format "
                ".pth files.  From JAX, convert the params with "
                "leccr_torch.models.weights.params_from_jax (the inverse of "
                "params_to_jax), or export a reference .pth with the JAX "
                "package's `run.py --task export`")
        step = newest_step_file(p)
        if step is not None:
            p = step
        else:
            found = sorted(p.glob("pytorch_model*.bin")) + sorted(
                p.glob("*.safetensors"))
            if not found:
                raise FileNotFoundError(f"no checkpoint file under {path}")
            p = found[0]
    if p.suffix == ".safetensors":
        return load_safetensors(str(p)), str(p)
    return load_torch_state_dict(str(p)), str(p)


def load_initial_checkpoint(path: str, model: nn.Module) -> ImportReport:
    """Load a checkpoint into `model`'s parameters in place, by its flavor:
    the model's own names (all of them) are the port's checkpoint, loaded
    strictly; keys under `clip_encoder.` / `text_encoder.` a reference
    checkpoint, `visual.` an OpenAI CLIP archive, `encoder.layer.` a HF
    BERT/XLM-R; anything else raises.  hdfs:// paths are
    staged to a local file first."""
    sd, source = read_state_dict(_stage(path))
    keys = list(sd)
    own = model.state_dict()
    if set(keys) == set(own):
        model.load_state_dict(sd, strict=True)
        report = ImportReport("port", [("port checkpoint", keys, [])])
        print(f"### port checkpoint: {len(keys)} tensors")
    elif any(k.startswith(("clip_encoder.", "text_encoder.")) for k in keys):
        report = load_reference_checkpoint_into(model, sd)
    elif any(k.startswith("visual.") for k in keys):
        report = load_openai_clip_into(model, sd)
    elif any("encoder.layer." in k for k in keys):
        report = load_hf_bert_into(model, sd)
    else:
        raise ValueError(f"unrecognized checkpoint flavor: {path}")
    if report.unused:
        print(f"### unused: {len(report.unused)} keys of {source}: "
              f"{report.unused[:5]}")
    return report


# ---------------------------------------------------------------- export


def _export_clip_blocks(out: Dict[str, torch.Tensor],
                        sd: Mapping[str, torch.Tensor], src: str,
                        dst: str) -> None:
    i = 0
    while f"{src}.resblocks.{i}.ln_1.weight" in sd:
        s, d = f"{src}.resblocks.{i}", f"{dst}.resblocks.{i}"
        out[f"{d}.attn.in_proj_weight"] = sd[f"{s}.attn.in_proj.weight"]
        out[f"{d}.attn.in_proj_bias"] = sd[f"{s}.attn.in_proj.bias"]
        for a, b in (("attn.out_proj", "attn.out_proj"), ("ln_1", "ln_1"),
                     ("ln_2", "ln_2"), ("c_fc", "mlp.c_fc"),
                     ("c_proj", "mlp.c_proj")):
            for part in ("weight", "bias"):
                out[f"{d}.{b}.{part}"] = sd[f"{s}.{a}.{part}"]
        i += 1


def export_reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A `LECCRModel`'s weights as a reference-format state_dict (f32 CPU
    tensors; `save_reference_checkpoint` writes the `.pth` that the
    reference's strict=False `--checkpoint` load consumes,
    image_Retrieval_caption.py:384-387).  The exact inverse of
    `load_reference_checkpoint_into`.  Only the reference's live modules
    are emitted: its dead parameters (itm_head, unused block norms, ...)
    keep their initialization under its strict=False load.  The shared
    mBERT/XLM-R tower goes out under both `text_encoder.` and
    `caption_encoder.` (the reference registers it twice,
    model_retrieval_caption.py:34-36); `queries` as [n, 1, d], `temp` as a
    0-d tensor, the cross-attention stacks with a packed `in_proj`."""
    sd = {k: v.detach().to("cpu", torch.float32)
          for k, v in model.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}

    if model.cfg.vision.kind == "temporal":
        _export_block_stack(out, sd, "vision_tower.encoder", "vid_encoder")
    else:
        v, p = "vision_tower", "clip_encoder.visual"
        conv = sd[f"{v}.conv1.weight"]  # [out, kh·kw·in] -> [out, in, kh, kw]
        patch = model.vision_tower.patch_size
        out[f"{p}.conv1.weight"] = conv.reshape(
            conv.shape[0], patch, patch, -1).permute(0, 3, 1, 2).contiguous()
        for name in ("class_embedding", "positional_embedding", "proj"):
            out[f"{p}.{name}"] = sd[f"{v}.{name}"]
        for ln in ("ln_pre", "ln_post"):
            for part in ("weight", "bias"):
                out[f"{p}.{ln}.{part}"] = sd[f"{v}.{ln}.{part}"]
        _export_clip_blocks(out, sd, f"{v}.transformer", f"{p}.transformer")

    if model.clip_text_tower is not None:
        t, p = "clip_text_tower", "clip_encoder"
        for name in ("token_embedding.weight", "positional_embedding",
                     "text_projection", "ln_final.weight", "ln_final.bias"):
            out[f"{p}.{name}"] = sd[f"{t}.{name}"]
        _export_clip_blocks(out, sd, f"{t}.transformer", f"{p}.transformer")

    t = "text_encoder"
    bert = {"embeddings.word_embeddings": "word_embeddings",
            "embeddings.position_embeddings": "position_embeddings",
            "embeddings.token_type_embeddings": "token_type_embeddings",
            "embeddings.LayerNorm": "embeddings_ln"}
    for i in range(len(model.text_encoder.layers)):
        for a, b in (("attention.self.query", "attention.query"),
                     ("attention.self.key", "attention.key"),
                     ("attention.self.value", "attention.value"),
                     ("attention.output.dense", "attention.out"),
                     ("attention.output.LayerNorm", "attention.out_ln"),
                     ("intermediate.dense", "intermediate"),
                     ("output.dense", "output"),
                     ("output.LayerNorm", "output_ln")):
            bert[f"encoder.layer.{i}.{a}"] = f"layers.{i}.{b}"
    for p in ("text_encoder", "caption_encoder"):
        for theirs, ours in bert.items():
            for part in ("weight", "bias"):
                if f"{t}.{ours}.{part}" in sd:
                    out[f"{p}.{theirs}.{part}"] = sd[f"{t}.{ours}.{part}"]

    for name in _HEAD_DENSE:
        for part in ("weight", "bias"):
            if f"{name}.{part}" in sd:
                out[f"{name}.{part}"] = sd[f"{name}.{part}"]
    out["queries"] = sd["queries"][:, None, :]
    out["temp"] = sd["temp"].reshape(())
    for stack in _STACKS:
        _export_block_stack(out, sd, stack, stack)
    return out


def _export_block_stack(out: Dict[str, torch.Tensor],
                        sd: Mapping[str, torch.Tensor], src: str,
                        dst: str) -> None:
    """An attention stack of the port (cross or self) in the reference's
    names: a packed `in_proj`, `linear1`/`linear2`, `norm2`."""
    i = 0
    while f"{src}.layers.{i}.norm.weight" in sd:
        s, d = f"{src}.layers.{i}", f"{dst}.layers.{i}"
        for part in ("weight", "bias"):
            out[f"{d}.multihead_attn.in_proj_{part}"] = torch.cat(
                [sd[f"{s}.attn.{n}_proj.{part}"] for n in "qkv"])
            out[f"{d}.multihead_attn.out_proj.{part}"] = sd[
                f"{s}.attn.out_proj.{part}"]
            out[f"{d}.linear1.{part}"] = sd[f"{s}.ffn.linear1.{part}"]
            out[f"{d}.linear2.{part}"] = sd[f"{s}.ffn.linear2.{part}"]
            out[f"{d}.norm2.{part}"] = sd[f"{s}.norm.{part}"]
        i += 1


def save_reference_checkpoint(sd: Mapping[str, torch.Tensor],
                              path: str) -> None:
    """torch.save an exported state_dict, each tensor in a storage of its
    own (the file holds no view of a larger tensor, and the shared
    text/caption tower is written under both names, as the JAX package
    writes it); `temp` stays 0-d."""
    torch.save({k: v.detach().to("cpu").clone() for k, v in sd.items()},
               path)
