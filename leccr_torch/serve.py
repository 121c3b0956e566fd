"""Serving API: embed an image or video corpus once, keep the index on the
device, answer top-K text→image/video and image→text queries.

The port of the single-device path of `leccr_tpu/serve.py`:

    emb = Embedder.from_checkpoint("out/m30k_fr/config.json")  # the GPU
    index = emb.build_image_index(images_u8, mllm_captions)
    hits = emb.search_texts(["ein mann fährt rad"], index, k=10)
    index = quantize_index(index)            # int8 rows, one scale each
    save_index(index, "out/m30k_fr/index")   # a directory; hdfs:// too
    index = load_index("out/m30k_fr/index")  # onto the GPU
    # a video model: per-frame features, the double-sim ranking
    index = emb.build_video_index(frame_feats, mllm_captions)
    hits = emb.search_texts(["一个男人骑自行车"], index, fusion="minmax")

The weights come from `load_params_for_inference`: an explicit checkpoint
(any flavor `models.weights.load_initial_checkpoint` reads), else the
newest checkpoint under `cfg.output_dir`, else seeded random weights.
Texts are tokenized as the trainer does (`data.tokenizers.make_tokenizers`:
Unigram for `text.kind: xlmr`, CLIP's BPE for the captions of
`caption_encoder_name: clip`).

Query batches are padded with "" to `batch_size` and image chunks by
repeating their last row, as in the JAX package; the `minmax` fusion keeps
pad queries out of its min/max with a `valid` mask.  f32 rows score by the
ranker's fixed-order products (`eval.retrieval.pairwise_scores`), so equal
index rows score bit for bit alike.  An int8 index (`quantize_index`:
symmetric per-row int8, one scale per item over all its slots) scores the
query batch, quantized the same way, through `torch._int_mm`: int8
products summed exactly in int32, so equal rows tie there too, then
dequantized as sum · query scale · row scale, in JAX's order.  The top-k
takes equal scores lowest index first, as `jax.lax.top_k` does.

`save_index` / `load_index` write and read the JAX package's directory
format byte for byte (`.npy` arrays, `ids.json`, `manifest.json`), so a
save of either package loads in the other.

The row-sharded layout (`leccr_tpu/serve.py:316-345, 476-566`):

    index = shard_index(index, ["cuda:0", "cuda:1"])   # or one device twice
    index = load_index("out/m30k_fr/index", mesh=["cuda:0", "cuda:1"])

pads the rows to a multiple of the W devices on the host and sends each
row range straight to its device (`ImageIndex.shards`; an index larger
than one device never sits whole on one).  A search embeds the queries
once, scores each shard with the same fixed-order scores as the unsharded
index (f32 `pairwise_scores`; int8 through `_int8_scores`, its scales
sharded like its rows), takes the minmax fusion's max and min over every
shard (JAX's pmax / pmin), each shard's own top-k (equal scores lowest
index first, pad rows never), then the global top-k of the candidates in
shard order: the unsharded search's result bit for bit, ties included.
`quantize_index`, `merge_indexes` and `remove_from_index` take an
unsharded index; `save_index` writes a sharded one unsharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.nn.functional as F

from leccr_torch.config import LECCRConfig, load_config
from leccr_torch.data.images import load_eval_image, normalize_images
from leccr_torch.data.tokenizers import make_tokenizers
from leccr_torch.device import resolve_device
from leccr_torch.eval.retrieval import pairwise_scores
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.weights import load_initial_checkpoint, load_jax_params

_ARRAYS = ("feats", "slots", "scale", "slot_scale")


@dataclasses.dataclass
class IndexShard:
    """One device's rows of a row-sharded index: rows [offset, offset +
    rows) of the layout padded to a multiple of the shard count."""

    feats: torch.Tensor
    slots: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]
    slot_scale: Optional[torch.Tensor]
    offset: int


@dataclasses.dataclass
class ImageIndex:
    feats: Optional[torch.Tensor]  # [N, E] L2-normalized, on the device
    # (f32 or int8); None when sharded
    slots: Optional[torch.Tensor]  # [N, n_q, E] (double-sim fusion)
    ids: List[str]
    # set by quantize_index(): per-row symmetric-int8 dequant scales
    # (feats/slots are int8 and score = int8 sum × qscale × row scale)
    scale: Optional[torch.Tensor] = None  # [N] f32
    slot_scale: Optional[torch.Tensor] = None  # [N] f32
    # set by shard_index(): the rows, padded, over W devices (the arrays
    # above are then None)
    shards: Optional[List[IndexShard]] = None

    @property
    def n_valid(self) -> int:
        return len(self.ids)

    @property
    def quantized(self) -> bool:
        if self.shards is not None:
            return self.shards[0].scale is not None
        return self.scale is not None

    @property
    def has_slots(self) -> bool:
        if self.shards is not None:
            return self.shards[0].slots is not None
        return self.slots is not None


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: q = round(x / s), s = max|row| · (1/127),
    in f32 and rounded half to even, bit for bit as the JAX package's
    compiled programs compute it (XLA turns the division by the constant
    127 into a product by its f32 reciprocal).  Rows are the leading axis;
    the max runs over every other axis (a [N, K, E] slot bank gets ONE
    scale per item, so the scale factors out of the max-over-slots).
    Returns (int8 x, f32 scale [N])."""
    x = x.float()
    m = x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    scale = m * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(x / safe).to(torch.int8)
    return q, scale.reshape(x.shape[0])


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, N] int32 = a @ b.T for int8 a [M, E] and b [N, E], summed
    exactly by `torch._int_mm`.  Its CUDA shape rules (more than 16 rows
    in a; E and the product's columns multiples of 8) are met by zero
    padding, which adds 0 to every sum: a's rows and E are padded, and b's
    last N % 8 rows go through a second product of 8 rows."""
    m, e = a.shape
    n = b.shape[0]
    if e % 8:
        a, b = F.pad(a, (0, (-e) % 8)), F.pad(b, (0, (-e) % 8))
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    n8 = n - n % 8
    parts = []
    if n8:
        parts.append(torch._int_mm(a, b[:n8].t()))
    if n8 < n:
        tail = F.pad(b[n8:], (0, 0, 0, 8 - (n - n8)))
        parts.append(torch._int_mm(a, tail.t())[:, : n - n8])
    s = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return s[:m]


def _int8_scores(q: torch.Tensor, f: torch.Tensor,
                 fscale: torch.Tensor) -> torch.Tensor:
    """[B, N] similarity against an int8 index: the query batch quantized
    on the fly, the int8 products summed in int32, dequantized after."""
    qq, qs = _quantize_rows(q)
    return _int8_mm(qq, f).float() * qs[:, None] * fscale[None, :]


def _int8_slot_scores(q: torch.Tensor, sl: torch.Tensor,
                      sscale: torch.Tensor) -> torch.Tensor:
    """[B, N] max-over-slot similarity against an int8 slot bank [N, K, E]
    (scored as [N·K, E]); the per-item scale is positive, so it commutes
    with the max."""
    qq, qs = _quantize_rows(q)
    n, k, e = sl.shape
    c = _int8_mm(qq, sl.reshape(n * k, e)).reshape(-1, n, k).amax(dim=2)
    return c.float() * qs[:, None] * sscale[None, :]


def _feat_scores(q: torch.Tensor, f: torch.Tensor,
                 fscale: Optional[torch.Tensor]) -> torch.Tensor:
    return (pairwise_scores(q, f) if fscale is None
            else _int8_scores(q, f, fscale))


def _slot_scores(q: torch.Tensor, sl: torch.Tensor,
                 sscale: Optional[torch.Tensor]) -> torch.Tensor:
    if sscale is not None:
        return _int8_slot_scores(q, sl, sscale)
    n, k, e = sl.shape
    return pairwise_scores(q, sl.reshape(n * k, e)).view(
        q.shape[0], n, k).amax(dim=2)


def _search_scores(q: torch.Tensor, index: ImageIndex, valid: torch.Tensor,
                   fusion: str, alpha: float) -> torch.Tensor:
    """[B, N] query×index scores, with the slot blend for fusion
    "raw"/"minmax"."""
    s = _feat_scores(q, index.feats, index.scale)
    if fusion == "none":
        return s
    c = _slot_scores(q, index.slots, index.slot_scale)
    if fusion == "raw":
        return alpha * s + (1.0 - alpha) * c

    # minmax: norm(S) = (S - max S)/(max S - min S) over this query
    # batch's valid rows (the eval ranker normalizes over the full
    # matrix, so fused scores are not comparable across batches)
    def norm(x):
        hi, lo = x[valid].max(), x[valid].min()
        return (x - hi) / torch.clamp_min(hi - lo, 1e-12)

    return alpha * norm(s) + (1.0 - alpha) * norm(c)


def quantize_index(index: ImageIndex) -> ImageIndex:
    """Symmetric per-row int8 quantization of an index: 4× less device
    memory, and the query product runs int8 × int8.  Feature rows are
    L2-normalized, so per-row scales are tight and the cosine order holds
    to ~1e-3 of score.  A quantized index is returned as it is; quantize
    before `shard_index`."""
    if index.shards is not None:
        raise ValueError("quantize_index before shard_index")
    if index.quantized:
        return index
    feats, scale = _quantize_rows(index.feats)
    slots, slot_scale = (None, None)
    if index.slots is not None:
        slots, slot_scale = _quantize_rows(index.slots)
    return ImageIndex(feats=feats, slots=slots, ids=list(index.ids),
                      scale=scale, slot_scale=slot_scale)


def merge_indexes(a: ImageIndex, b: ImageIndex) -> ImageIndex:
    """Append `b`'s items to `a` (embed the new items, then merge: nothing
    existing is embedded again).  Exact for int8 indexes too: the scales
    are per row, so existing rows keep their bytes and scales.  Both must
    share a layout (quantization, slots) and be unsharded."""
    if a.shards is not None or b.shards is not None:
        raise ValueError("merge unsharded indexes (shard_index after)")
    if a.quantized != b.quantized:
        raise ValueError("cannot merge a quantized index with an fp32 one")
    if (a.slots is None) != (b.slots is None):
        raise ValueError("cannot merge a slot-carrying index with a "
                         "feats-only one")
    dup = set(a.ids) & set(b.ids)
    if dup:
        raise ValueError(f"duplicate ids in merge: {sorted(dup)[:5]} ...")

    def cat(x, y):
        return None if x is None else torch.cat([x, y])

    return ImageIndex(
        feats=cat(a.feats, b.feats), slots=cat(a.slots, b.slots),
        ids=list(a.ids) + list(b.ids), scale=cat(a.scale, b.scale),
        slot_scale=cat(a.slot_scale, b.slot_scale))


def remove_from_index(index: ImageIndex, ids: Sequence[str]) -> ImageIndex:
    """Drop items by id without embedding anything; unknown ids are an
    error.  Unsharded only: re-shard after."""
    if index.shards is not None:
        raise ValueError("remove from the unsharded index (re-shard after)")
    drop = set(ids)
    unknown = drop - set(index.ids)
    if unknown:
        raise ValueError(f"unknown ids: {sorted(unknown)[:5]} ...")
    keep = np.asarray([i not in drop for i in index.ids], bool)
    rows = torch.from_numpy(np.nonzero(keep)[0]).to(index.feats.device)

    def take(x):
        return None if x is None else x.index_select(0, rows)

    return ImageIndex(
        feats=take(index.feats), slots=take(index.slots),
        ids=[i for i in index.ids if i not in drop],
        scale=take(index.scale), slot_scale=take(index.slot_scale))


def _host_arrays(index: ImageIndex) -> Dict[str, Optional[np.ndarray]]:
    """The index's arrays on the host, its n_valid rows (a sharded index's
    shards concatenated, the padding dropped)."""
    n = index.n_valid
    if index.shards is None:
        return {name: None if getattr(index, name) is None
                else getattr(index, name)[:n].cpu().numpy()
                for name in _ARRAYS}
    return {name: None if getattr(index.shards[0], name) is None
            else np.concatenate([getattr(sh, name).cpu().numpy()
                                 for sh in index.shards])[:n]
            for name in _ARRAYS}


def shard_index(index: ImageIndex,
                devices: Sequence[Union[str, torch.device]]) -> ImageIndex:
    """`index` row-sharded over `devices` (W of them; one device may
    repeat): the rows padded with zeros to a multiple of W on the host,
    shard i = rows [i·N/W, (i+1)·N/W) sent straight to devices[i], so the
    whole index never sits on one device.  Every search masks the pad
    rows."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("shard_index needs at least one device")
    w = len(devices)
    host = _host_arrays(index)
    n = index.n_valid
    per = -(-n // w)

    def rows(x, i):
        if x is None:
            return None
        part = x[i * per:(i + 1) * per]
        if part.shape[0] < per:
            part = np.concatenate(
                [part, np.zeros((per - part.shape[0],) + x.shape[1:],
                                x.dtype)])
        return torch.from_numpy(np.ascontiguousarray(part)).to(devices[i])

    shards = [IndexShard(offset=i * per,
                         **{name: rows(host[name], i) for name in _ARRAYS})
              for i in range(w)]
    return ImageIndex(feats=None, slots=None, ids=list(index.ids),
                      shards=shards)


# optional per-layout arrays a save may or may not carry; the manifest
# records which ones belong to THIS save, so a load over a re-used
# directory (a local overwrite, or an hdfs re-sync, which never deletes)
# cannot pick up a previous save's stale scale.npy or slots.npy
_INDEX_OPTIONAL = ("slots", "scale", "slot_scale")


@contextlib.contextmanager
def _staged_save_dir(path: str, prefix: str):
    """The LOCAL directory to write a save into; an hdfs:// destination
    is staged in a temporary directory and mirrored up only on a clean
    exit.  Shared by the exact and the IVF index saves."""
    from leccr_torch.utils import io

    if not path.startswith("hdfs://"):
        os.makedirs(path, exist_ok=True)
        yield path
        return
    local = tempfile.mkdtemp(prefix=prefix)
    try:
        yield local
        io.makedirs(path)
        io.sync_dir_to_remote(local, path)
    finally:
        shutil.rmtree(local, ignore_errors=True)


@contextlib.contextmanager
def _staged_load_dir(path: str, prefix: str):
    """A LOCAL directory holding the save; an hdfs:// source is staged
    down, and removed on exit."""
    from leccr_torch.utils import io

    if not path.startswith("hdfs://"):
        yield path
        return
    local = tempfile.mkdtemp(prefix=prefix)
    try:
        io.stage_remote_dir(path, local)
        yield local
    finally:
        shutil.rmtree(local, ignore_errors=True)


def _write_array_save(local: str, required: Dict[str, np.ndarray],
                      optional: Dict[str, Optional[np.ndarray]],
                      ids: List[str], extra: Dict) -> None:
    """The directory layout the index families share: the required arrays;
    each optional array written when present and its stale .npy removed
    when absent; ids.json; and a manifest naming this save's optional
    arrays (see _INDEX_OPTIONAL)."""
    for name, arr in required.items():
        np.save(os.path.join(local, name + ".npy"), arr)
    written = []
    for name, arr in optional.items():
        p = os.path.join(local, name + ".npy")
        if arr is not None:
            np.save(p, arr)
            written.append(name)
        elif os.path.exists(p):  # stale file from a previous save
            os.remove(p)
    with open(os.path.join(local, "ids.json"), "w") as f:
        json.dump(list(ids), f)
    with open(os.path.join(local, "manifest.json"), "w") as f:
        json.dump({"optional": written, "n": len(ids), **extra}, f)


def _host(x: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if x is None else x.cpu().numpy()


def save_index(index: ImageIndex, path: str) -> None:
    """Persist an index (feats, slots, scales, ids), so a serving restart
    skips the embed pass.  `path` is a directory; hdfs:// goes through
    `utils.io`.  A sharded index is saved unsharded (shard again after
    the load)."""
    host = _host_arrays(index)
    with _staged_save_dir(path, "leccr_index_") as local:
        _write_array_save(
            local, {"feats": host["feats"]},
            {name: host[name] for name in _INDEX_OPTIONAL}, index.ids, {})


def load_index(path: str,
               device: Optional[Union[str, torch.device]] = None,
               mesh: Optional[Sequence[Union[str, torch.device]]] = None
               ) -> ImageIndex:
    """Load a saved index (this package's or the JAX package's) onto
    `device` (None = the GPU), or with `mesh` (a list of devices)
    row-sharded over them by `shard_index`, straight from the host."""
    device = resolve_device(device) if mesh is None else None
    with _staged_load_dir(path, "leccr_index_") as local:
        feats = np.load(os.path.join(local, "feats.npy"))
        with open(os.path.join(local, "ids.json")) as f:
            ids = json.load(f)
        if len(ids) != feats.shape[0]:
            raise ValueError(
                f"index corrupt: {len(ids)} ids vs {feats.shape[0]} rows")
        # the manifest scopes the optional files to THIS save; without one
        # (a save from before manifests) file presence decides
        mpath = os.path.join(local, "manifest.json")
        allowed = None
        if os.path.exists(mpath):
            with open(mpath) as f:
                allowed = set(json.load(f)["optional"])

        def opt(name):
            if allowed is not None and name not in allowed:
                return None
            p = os.path.join(local, name + ".npy")
            return np.load(p) if os.path.exists(p) else None

        arrays = {"feats": feats,
                  **{name: opt(name) for name in _INDEX_OPTIONAL}}
    if mesh is not None:
        return shard_index(ImageIndex(ids=list(ids), **{
            name: None if arr is None else torch.from_numpy(arr)
            for name, arr in arrays.items()}), mesh)
    return ImageIndex(ids=list(ids), **{
        name: None if arr is None else torch.from_numpy(arr).to(device)
        for name, arr in arrays.items()})


def load_params_for_inference(
        cfg: LECCRConfig, checkpoint: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0) -> LECCRModel:
    """A LECCRModel for an inference-only consumer (Embedder, the export
    task), with weights from, in this order: `checkpoint` (any flavor
    `load_initial_checkpoint` reads); the newest checkpoint of
    `cfg.output_dir` (its EMA when it holds one and `train.ema_eval`, the
    weights evaluation gated on); seeded random weights.  Prints which.
    device: None = the GPU."""
    from leccr_torch.train.checkpoints import (
        CheckpointManager,
        newest_step_file,
    )

    model = LECCRModel(cfg.model, device=device, seed=seed)
    if checkpoint:
        load_initial_checkpoint(checkpoint, model)
        print(f"### inference weights: {checkpoint}")
        return model
    newest = (newest_step_file(Path(cfg.output_dir)) if cfg.output_dir
              else None)
    if newest is None:
        print(f"### inference weights: random (seed {seed})")
        return model
    state, _, ema, _ = CheckpointManager.read(newest)
    model.load_state_dict(state)
    if ema is not None and cfg.train.ema_eval:
        with torch.no_grad():
            for param, value in zip(model.parameters(), ema):
                param.copy_(value)
    print(f"### inference weights: {newest}"
          + (" (EMA)" if ema is not None and cfg.train.ema_eval else ""))
    return model


def _top_k(scores: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores of each row and their columns, equal scores
    lowest column first (`jax.lax.top_k`'s order); copies, so the whole
    sort is freed."""
    values, idxs = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k].contiguous(), idxs[:, :k].contiguous()


def _sharded_top_k(q: torch.Tensor, index: ImageIndex, valid: torch.Tensor,
                   fusion: str, alpha: float, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_top_k(_search_scores(...), k)` of a sharded index, on q's device:
    each shard scored on its device, the minmax bounds over every shard's
    live rows, each shard's top-k of its live rows, then the top-k of the
    candidates in shard order (lowest global row first among equals)."""
    n = index.n_valid
    parts = []
    for sh in index.shards:
        dev = sh.feats.device
        qd = q.to(dev)
        live = (sh.offset + torch.arange(sh.feats.shape[0], device=dev)) < n
        s = _feat_scores(qd, sh.feats, sh.scale)
        c = (None if fusion == "none"
             else _slot_scores(qd, sh.slots, sh.slot_scale))
        parts.append((s, c, live, valid.to(dev)))

    def bound(x, live, vd, fn, fill):
        return fn(torch.where(vd[:, None] & live[None, :], x,
                              torch.full_like(x, fill))).to(q.device)

    if fusion == "minmax":  # the global bounds over every shard (pmax/pmin)
        bounds = [
            (torch.stack([bound(p[i], p[2], p[3], torch.amax, -torch.inf)
                          for p in parts]).amax(),
             torch.stack([bound(p[i], p[2], p[3], torch.amin, torch.inf)
                          for p in parts]).amin())
            for i in (0, 1)]
    cand_s, cand_i = [], []
    for sh, (s, c, live, _) in zip(index.shards, parts):
        if fusion == "raw":
            s = alpha * s + (1.0 - alpha) * c
        elif fusion == "minmax":
            (hs, ls), (hc, lc) = [(h.to(s.device), lo.to(s.device))
                                  for h, lo in bounds]
            s = (alpha * ((s - hs) / torch.clamp_min(hs - ls, 1e-12))
                 + (1.0 - alpha) * ((c - hc) / torch.clamp_min(hc - lc,
                                                               1e-12)))
        s = torch.where(live[None, :], s, torch.full_like(s, -torch.inf))
        vals, local = _top_k(s, min(k, s.shape[1]))
        cand_s.append(vals.to(q.device))
        cand_i.append((local + sh.offset).to(q.device))
    vals, pos = _top_k(torch.cat(cand_s, dim=1), k)
    return vals, torch.gather(torch.cat(cand_i, dim=1), 1, pos)


class Embedder:
    """Text and image (or video) embedding plus top-K search around one
    LECCRModel; runs wherever the model lives."""

    def __init__(self, cfg: LECCRConfig, model: LECCRModel,
                 batch_size: int = 64):
        self.cfg = cfg
        self.model = model
        self.batch_size = batch_size
        self.device = model.device
        self.tokenizer, self.caption_tokenizer = make_tokenizers(cfg)

    @classmethod
    def from_config(cls, cfg: LECCRConfig,
                    params: Optional[Mapping[str, Any]] = None,
                    seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None,
                    batch_size: int = 64,
                    checkpoint: Optional[str] = None) -> "Embedder":
        """The JAX package's `params` (a flax param tree of numpy arrays)
        when given, else `load_params_for_inference(cfg, checkpoint)`
        (random weights from `seed` when there is no checkpoint).  device:
        None = the GPU.  The model serves only, so its weights are held in
        the compute dtype (no f32 masters, no cast per call)."""
        if params is not None:
            model = LECCRModel(cfg.model, device=device, seed=seed)
            load_jax_params(model, params)
        else:
            model = load_params_for_inference(cfg, checkpoint, device, seed)
        return cls(cfg, model.serve_in_compute_dtype_(), batch_size)

    @classmethod
    def from_checkpoint(cls, config_path: str,
                        checkpoint: Optional[str] = None,
                        batch_size: int = 64,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> "Embedder":
        """`from_config` of the config file at `config_path` (yaml or
        json, e.g. the config.json a training run wrote)."""
        return cls.from_config(load_config(config_path), device=device,
                               batch_size=batch_size, checkpoint=checkpoint)

    def _tokens(self, texts: Sequence[str]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenizer.encode(list(texts),
                                          self.cfg.data.max_tokens)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _caption_tokens(self, caps: List[str]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        if self.caption_tokenizer is self.tokenizer:
            return self.tokenizer.encode(caps, self.cfg.data.max_tokens)
        ids = self.caption_tokenizer.encode(caps)  # CLIP BPE, padded with 0
        return ids, (ids != 0).astype(np.int32)

    # ------------------------------------------------------------- texts

    def _embed_texts(self, texts: Sequence[str]) -> torch.Tensor:
        out = []
        bs = self.batch_size
        for i in range(0, len(texts), bs):
            chunk = list(texts[i: i + bs])
            n = len(chunk)
            chunk += [""] * (bs - n)
            out.append(self.model.embed_texts(*self._tokens(chunk))[:n])
        return torch.cat(out)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[len(texts), E] L2-normalized f32."""
        return self._embed_texts(texts).cpu().numpy()

    # ------------------------------------------------------------ images

    def _embed_chunks(self, n: int, chunk_fn, mllm_captions: Sequence,
                      ids: Optional[List[str]]) -> ImageIndex:
        """chunk_fn(i) -> (vision sub-batch dict, count).  Each chunk is
        padded to batch_size by repeating its last row, its captions are
        tokenized (or, for per-token caption FEATURE arrays [t_i, Dc],
        zero-padded to one corpus-wide width and fed as caption_feats),
        embedded, and the pads sliced off."""
        if n == 0:
            raise ValueError("cannot build an index from zero items")
        feats_mode = not isinstance(mllm_captions[0], str)
        if feats_mode:
            cap_w = max(np.asarray(c).shape[0] for c in mllm_captions)
            cap_d = np.asarray(mllm_captions[0]).shape[1]
        feats, slots = [], []
        bs = self.batch_size
        for i in range(0, n, bs):
            vis, count = chunk_fn(i)
            pad = bs - count
            if pad:
                vis = {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])])
                       for k, v in vis.items()}
            caps = list(mllm_captions[i: i + count])
            caps += [caps[-1]] * pad
            if feats_mode:
                arr = np.zeros((bs, cap_w, cap_d), np.float32)
                msk = np.zeros((bs, cap_w), np.int32)
                for j, c in enumerate(caps):
                    c = np.asarray(c, np.float32)
                    arr[j, : c.shape[0]] = c
                    msk[j, : c.shape[0]] = 1
                batch = {"caption_feats": torch.from_numpy(arr),
                         "caption_mask": torch.from_numpy(msk)}
            else:
                cap_ids, cap_mask = self._caption_tokens(caps)
                batch = {"caption_ids": torch.from_numpy(cap_ids),
                         "caption_mask": torch.from_numpy(cap_mask)}
            batch = {k: v.to(self.device) for k, v in batch.items()}
            batch.update(vis)
            out = self.model.embed_images(batch)
            feats.append(out["feat"][:count])
            slots.append(out["slots"][:count])
        return ImageIndex(
            feats=torch.cat(feats), slots=torch.cat(slots),
            ids=list(ids) if ids else [str(i) for i in range(n)])

    def build_image_index(
        self,
        images: Union[Sequence[str], np.ndarray, torch.Tensor],
        mllm_captions: Sequence,
        ids: Optional[List[str]] = None,
    ) -> ImageIndex:
        """images: file paths (decoded+resized on the host) or a pre-sized
        uint8 array/tensor [N, H, W, 3]; mllm_captions: one caption string
        (or per-token caption feature array) per image."""
        res = self.cfg.model.vision.image_res
        n = len(images)

        def chunk(i):
            part = images[i: i + self.batch_size]
            if isinstance(part[0], str):
                part = np.stack([load_eval_image(p, res) for p in part])
            u8 = torch.as_tensor(part).to(self.device)
            return {"vision": normalize_images(u8)}, len(part)

        return self._embed_chunks(n, chunk, mllm_captions, ids)

    def build_video_index(
        self,
        frame_feats: Union[Sequence[np.ndarray], np.ndarray],
        mllm_captions: Sequence,
        frame_masks: Optional[np.ndarray] = None,
        ids: Optional[List[str]] = None,
    ) -> ImageIndex:
        """Index pre-extracted per-frame video features (a temporal vision
        tower's model).  frame_feats: an [N, T, D] array (with an optional
        bool frame_masks [N, T], True = a real frame; without one the first
        T frames are real), or a list of per-video [t_i, D] arrays; either
        is padded or truncated to `max_frames`.  Search it with
        fusion="minmax" for the video evaluator's double-sim ranking."""
        vcfg = self.cfg.model.vision
        if vcfg.kind != "temporal":
            raise ValueError("build_video_index needs a temporal vision "
                             f"tower, got {vcfg.kind!r}")
        t_max, d = vcfg.max_frames, vcfg.frame_feat_dim
        if isinstance(frame_feats, np.ndarray) and frame_feats.ndim == 3:
            n = frame_feats.shape[0]
            arr = frame_feats[:, :t_max].astype(np.float32)
            if arr.shape[1] < t_max:
                arr = np.pad(arr, ((0, 0), (0, t_max - arr.shape[1]), (0, 0)))
            if frame_masks is None:
                m = np.zeros((n, t_max), bool)
                m[:, :min(frame_feats.shape[1], t_max)] = True
            else:
                m = np.asarray(frame_masks, bool)[:, :t_max]
                if m.shape[1] < t_max:
                    m = np.pad(m, ((0, 0), (0, t_max - m.shape[1])))
        else:
            n = len(frame_feats)
            arr = np.zeros((n, t_max, d), np.float32)
            m = np.zeros((n, t_max), bool)
            for i, f in enumerate(frame_feats):
                t = min(f.shape[0], t_max)
                arr[i, :t] = f[:t]
                m[i, :t] = True

        def chunk(i):
            rows = slice(i, i + self.batch_size)
            return ({"vision": torch.from_numpy(arr[rows]).to(self.device),
                     "vision_mask": torch.from_numpy(m[rows]).to(
                         self.device)}, arr[rows].shape[0])

        return self._embed_chunks(n, chunk, mllm_captions, ids)

    # ------------------------------------------------------------ search

    @torch.inference_mode()
    def search_texts(self, queries: Sequence[str], index: ImageIndex,
                     k: int = 10, fusion: str = "none",
                     alpha: float = 0.9) -> List[List[Tuple[str, float]]]:
        """text → image retrieval: the top-k (id, score) per query.
        fusion: "none" (feature similarity) | "raw" | "minmax" (slot blend,
        the double-sim ranking); alpha weights the feature term."""
        if fusion not in ("none", "raw", "minmax"):
            raise ValueError(f"unknown fusion {fusion!r}")
        if fusion != "none" and not index.has_slots:
            raise ValueError(f"fusion={fusion!r} needs a slot-carrying "
                             "index (built by build_image_index/"
                             "build_video_index, or loaded from a save "
                             "that included slots.npy)")
        k = min(k, index.n_valid)
        n = len(queries)
        if n == 0:
            return []
        if n <= self.batch_size:
            chunk = list(queries) + [""] * (self.batch_size - n)
            q = self.model.embed_texts(*self._tokens(chunk))
            valid = torch.arange(self.batch_size, device=self.device) < n
        else:
            q = self._embed_texts(queries)
            valid = torch.ones(n, dtype=torch.bool, device=self.device)
        if index.shards is not None:
            scores, idxs = _sharded_top_k(q, index, valid, fusion,
                                          float(alpha), k)
        else:
            scores, idxs = _top_k(
                _search_scores(q, index, valid, fusion, float(alpha)), k)
        scores, idxs = scores[:n].cpu().numpy(), idxs[:n].cpu().numpy()
        return [[(index.ids[j], float(s)) for j, s in zip(row_i, row_s)]
                for row_i, row_s in zip(idxs, scores)]

    @torch.inference_mode()
    def search_images(self, index: ImageIndex, texts: Sequence[str],
                      k: int = 10) -> List[List[Tuple[int, float]]]:
        """image → text retrieval over an embedded text corpus: per indexed
        item, the top-k (text position, score).  An int8 index scores
        text-side (the quantized operand stays in index position) and
        transposes: the same [N, T] matrix either way."""
        t = self._embed_texts(texts)
        k = min(k, t.shape[0])

        def scores_of(feats, scale):
            td = t.to(feats.device)
            return (_int8_scores(td, feats, scale).T if scale is not None
                    else pairwise_scores(feats, td)).to(t.device)

        if index.shards is not None:  # rows by shard, the padding dropped
            s = torch.cat([scores_of(sh.feats, sh.scale)
                           for sh in index.shards])[:index.n_valid]
        else:
            s = scores_of(index.feats, index.scale)
        scores, idxs = _top_k(s, k)
        scores, idxs = scores.cpu().numpy(), idxs.cpu().numpy()
        return [[(int(j), float(s)) for j, s in zip(ri, rs)]
                for ri, rs in zip(idxs, scores)]
