"""Serving API: embed an image corpus once, keep the index on the device,
answer top-K text→image and image→text queries.

The port of the single-device f32 path of `leccr_tpu/serve.py`:

    emb = Embedder.from_config(cfg)                 # on the GPU
    index = emb.build_image_index(images_u8, mllm_captions)
    hits = emb.search_texts(["ein mann fährt rad"], index, k=10)

Query batches are padded with "" to `batch_size` and image chunks by
repeating their last row, as in the JAX package; the `minmax` fusion keeps
pad queries out of its min/max with a `valid` mask.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from leccr_torch.config import LECCRConfig
from leccr_torch.data.images import load_eval_image, normalize_images
from leccr_torch.data.tokenizers import WordPieceTokenizer
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.weights import load_jax_params


@dataclasses.dataclass
class ImageIndex:
    feats: torch.Tensor  # [N, E] L2-normalized f32, on the device
    slots: Optional[torch.Tensor]  # [N, n_q, E] (double-sim fusion)
    ids: List[str]

    @property
    def n_valid(self) -> int:
        return len(self.ids)


class Embedder:
    """Text and image embedding plus top-K search around one LECCRModel;
    runs wherever the model lives."""

    def __init__(self, cfg: LECCRConfig, model: LECCRModel,
                 batch_size: int = 64):
        if cfg.model.text.kind == "xlmr":
            raise NotImplementedError(
                "the XLM-R (Unigram) tokenizer comes with a later slice of "
                "the port")
        self.cfg = cfg
        self.model = model
        self.batch_size = batch_size
        self.device = model.device
        self.tokenizer = WordPieceTokenizer(cfg.data.text_vocab,
                                            lowercase=cfg.data.lowercase)

    @classmethod
    def from_config(cls, cfg: LECCRConfig,
                    params: Optional[Mapping[str, Any]] = None,
                    seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None,
                    batch_size: int = 64) -> "Embedder":
        """Random weights from `seed`, or the JAX package's `params` (a
        flax param tree of numpy arrays).  device: None = the GPU.  The
        model serves only, so its weights are held in the compute dtype
        (no f32 masters, no cast per call)."""
        model = LECCRModel(cfg.model, device=device, seed=seed)
        if params is not None:
            load_jax_params(model, params)
        return cls(cfg, model.serve_in_compute_dtype_(), batch_size)

    def _tokens(self, texts: Sequence[str]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenizer.encode(list(texts),
                                          self.cfg.data.max_tokens)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

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
                cap_ids, cap_mask = self.tokenizer.encode(
                    caps, self.cfg.data.max_tokens)
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

    # ------------------------------------------------------------ search

    def _scores(self, q: torch.Tensor, index: ImageIndex,
                valid: torch.Tensor, fusion: str,
                alpha: float) -> torch.Tensor:
        """[B, N] query×index scores, with the slot blend for fusion
        "raw"/"minmax"."""
        s = q @ index.feats.T
        if fusion == "none":
            return s
        c = torch.matmul(index.slots, q.T).amax(dim=1).T  # max over slots
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
        scores, idxs = torch.topk(
            self._scores(q, index, valid, fusion, float(alpha)), k, dim=1)
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
        scores, idxs = torch.topk(index.feats @ t.T, k, dim=1)
        scores, idxs = scores.cpu().numpy(), idxs.cpu().numpy()
        return [[(int(j), float(s)) for j, s in zip(ri, rs)]
                for ri, rs in zip(idxs, scores)]
