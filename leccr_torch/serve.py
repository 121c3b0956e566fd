"""Serving API: embed an image or video corpus once, keep the index on the
device, answer top-K text→image/video and image→text queries.

The port of the single-device f32 path of `leccr_tpu/serve.py`:

    emb = Embedder.from_config(cfg, checkpoint="reference.pth")  # the GPU
    index = emb.build_image_index(images_u8, mllm_captions)
    hits = emb.search_texts(["ein mann fährt rad"], index, k=10)
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
pad queries out of its min/max with a `valid` mask.  Scores are the
ranker's fixed-order products (`eval.retrieval.pairwise_scores`), so equal
index rows score bit for bit alike, and the top-k takes equal scores
lowest index first, as `jax.lax.top_k` does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from leccr_torch.config import LECCRConfig
from leccr_torch.data.images import load_eval_image, normalize_images
from leccr_torch.data.tokenizers import make_tokenizers
from leccr_torch.eval.retrieval import pairwise_scores
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.weights import load_initial_checkpoint, load_jax_params


@dataclasses.dataclass
class ImageIndex:
    feats: torch.Tensor  # [N, E] L2-normalized f32, on the device
    slots: Optional[torch.Tensor]  # [N, n_q, E] (double-sim fusion)
    ids: List[str]

    @property
    def n_valid(self) -> int:
        return len(self.ids)


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
    lowest column first (`jax.lax.top_k`'s order)."""
    values, idxs = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], idxs[:, :k]


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

    def _scores(self, q: torch.Tensor, index: ImageIndex,
                valid: torch.Tensor, fusion: str,
                alpha: float) -> torch.Tensor:
        """[B, N] query×index scores, with the slot blend for fusion
        "raw"/"minmax"."""
        s = pairwise_scores(q, index.feats)
        if fusion == "none":
            return s
        n, n_q, e = index.slots.shape
        c = pairwise_scores(q, index.slots.reshape(n * n_q, e)).view(
            q.shape[0], n, n_q).amax(dim=2)  # max over slots
        if fusion == "raw":
            return alpha * s + (1.0 - alpha) * c

        # minmax: norm(S) = (S - max S)/(max S - min S) over this query
        # batch's valid rows (the eval ranker normalizes over the full
        # matrix, so fused scores are not comparable across batches)
        def norm(x):
            hi, lo = x[valid].max(), x[valid].min()
            return (x - hi) / torch.clamp_min(hi - lo, 1e-12)

        return alpha * norm(s) + (1.0 - alpha) * norm(c)

    @torch.inference_mode()
    def search_texts(self, queries: Sequence[str], index: ImageIndex,
                     k: int = 10, fusion: str = "none",
                     alpha: float = 0.9) -> List[List[Tuple[str, float]]]:
        """text → image retrieval: the top-k (id, score) per query.
        fusion: "none" (feature similarity) | "raw" | "minmax" (slot blend,
        the double-sim ranking); alpha weights the feature term."""
        if fusion not in ("none", "raw", "minmax"):
            raise ValueError(f"unknown fusion {fusion!r}")
        if fusion != "none" and index.slots is None:
            raise ValueError(f"fusion={fusion!r} needs a slot-carrying "
                             "index (built by build_image_index)")
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
        scores, idxs = _top_k(
            self._scores(q, index, valid, fusion, float(alpha)), k)
        scores, idxs = scores[:n].cpu().numpy(), idxs[:n].cpu().numpy()
        return [[(index.ids[j], float(s)) for j, s in zip(row_i, row_s)]
                for row_i, row_s in zip(idxs, scores)]

    @torch.inference_mode()
    def search_images(self, index: ImageIndex, texts: Sequence[str],
                      k: int = 10) -> List[List[Tuple[int, float]]]:
        """image → text retrieval over an embedded text corpus: per indexed
        item, the top-k (text position, score)."""
        t = self._embed_texts(texts)
        k = min(k, t.shape[0])
        scores, idxs = _top_k(pairwise_scores(index.feats, t), k)
        scores, idxs = scores.cpu().numpy(), idxs.cpu().numpy()
        return [[(int(j), float(s)) for j, s in zip(ri, rs)]
                for ri, rs in zip(idxs, scores)]
