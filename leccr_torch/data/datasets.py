"""Datasets in the reference on-disk layout, image and video (the port of
`leccr_tpu/data/datasets.py`).

- train caption files: first file = source language (`imgid#enc#n cap`),
  later files = machine-translated targets (`imgid#enc2fr#n cap`);
- `img_id/{train,val,test}_id.txt` enumerate image ids; a sample's `idx` is
  its position in train_id.txt (duplicate-caption soft labels key off it);
- per-image MLLM captions live in `<generated_caption_dir>/<id>.txt`
  (or `.npy` 768-d feature files when generated_caption_type == 'feats');
- mscoco id→filename indirection via `img_id/image_ids.txt`;
- video: a BigFile feature bank `FeatureData/<image_root>` with its
  `video2frames.txt`, ids in `video_id/{train,val,test}_id.txt`; a
  video's frames come padded (or uniformly subsampled) to `max_frames`
  with a valid mask.

Each language's cap_id is derived from the source cap_id (not by the
reference's cumulative in-place replace), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from leccr_torch.config import DataConfig
from leccr_torch.data import images as I
from leccr_torch.data.feature_bank import FeatureBank, read_video2frames
from leccr_torch.data.text import (
    EvalIndex,
    build_eval_index,
    language_of_train_file,
    normalize_caption,
    parse_caption_file,
    read_generated_captions,
    read_id_file,
    read_image_name_map,
    video_id_of,
)


def _load_caption_feats(caption_dir: str, image_ids: Sequence[str]
                        ) -> Dict[str, np.ndarray]:
    """generated_caption_type == 'feats': per-image .npy, reshaped to
    [-1, 768] (reference retrieval_dataset.py:67-69)."""
    out = {}
    for image_id in image_ids:
        arr = np.load(os.path.join(caption_dir, f"{image_id}.npy"),
                      allow_pickle=False)
        out[image_id] = np.asarray(arr, np.float32).reshape(-1, 768)
    return out


@dataclasses.dataclass
class TrainSample:
    image_u8: Optional[np.ndarray]  # [H, W, 3], or None (video)
    flip: bool
    texts: List[str]  # [source, target, ...] normalized
    caption: Union[str, np.ndarray]  # MLLM caption text (or feats)
    idx: int
    cap_id: str
    frames: Optional[np.ndarray] = None  # [max_frames, D] f32 (video)
    frame_mask: Optional[np.ndarray] = None  # [max_frames] bool, True=valid


def _read_generated(cfg: DataConfig, image_ids: Sequence[str], name_map):
    if cfg.generated_caption_type == "feats":
        return _load_caption_feats(cfg.generated_caption_dir, image_ids)
    return read_generated_captions(cfg.generated_caption_dir, image_ids,
                                   name_map)


class ImageTrainDataset:
    """reference re_train_dataset_caption (retrieval_dataset.py:30-135)."""

    def __init__(self, cfg: DataConfig, image_res: int):
        self.cfg = cfg
        self.image_res = image_res
        root = cfg.root_dir

        self.name_map = None
        if cfg.dataset == "mscoco":
            self.name_map = read_image_name_map(
                os.path.join(root, "img_id", "image_ids.txt"))

        train_ids = read_id_file(os.path.join(root, "img_id", "train_id.txt"))
        self.img_ids = {img: i for i, img in enumerate(train_ids)}
        self.generated = _read_generated(cfg, train_ids, self.name_map)

        self.languages: List[str] = []
        self.caption_maps: List[Dict[str, str]] = []
        self.cap_ids: List[str] = []
        for i, rel in enumerate(cfg.train_file):
            if i != 0:
                self.languages.append(language_of_train_file(rel))
            entries = parse_caption_file(os.path.join(root, rel))
            self.caption_maps.append(dict(entries))
            if i == 0:
                self.cap_ids = [cid for cid, _ in entries]

    def __len__(self) -> int:
        return len(self.cap_ids)

    def caption_key(self, cap_id: str, k: int) -> str:
        """The cap_id of train file k's caption of source caption cap_id."""
        return cap_id if k == 0 else cap_id.replace(
            "#enc#", f"#enc2{self.languages[k - 1]}#")

    def image_path(self, image_id: str) -> str:
        if self.cfg.dataset == "mscoco":
            return os.path.join(self.cfg.image_root, self.name_map[image_id])
        return os.path.join(self.cfg.image_root, f"{image_id}.jpg")

    def get(self, index: int, rng: np.random.RandomState) -> TrainSample:
        cap_id = self.cap_ids[index]
        image_id = video_id_of(cap_id)
        img, flip = I.load_train_image(
            self.image_path(image_id), self.image_res, rng,
            fast=self.cfg.fast_decode)
        texts = [normalize_caption(cmap[self.caption_key(cap_id, k)],
                                   self.cfg.max_words)
                 for k, cmap in enumerate(self.caption_maps)]
        return TrainSample(
            image_u8=img, flip=flip, texts=texts,
            caption=self.generated[image_id],
            idx=self.img_ids[image_id], cap_id=cap_id)


class ImageEvalDataset:
    """reference re_eval_dataset_caption (retrieval_dataset.py:140-264)."""

    def __init__(self, cfg: DataConfig, ann_file: str, image_res: int,
                 split: str = "eval"):
        self.cfg = cfg
        self.image_res = image_res
        self.text_trans: List[str] = []
        if split == "test" and cfg.test_trans_file:
            # translated test texts (reference retrieval_dataset.py:228-233;
            # parsed and stored, reference never consumes them either)
            self.text_trans = [
                normalize_caption(c, cfg.max_words) for _, c in
                parse_caption_file(os.path.join(cfg.root_dir,
                                                cfg.test_trans_file))]
        root = cfg.root_dir
        self.name_map = None
        if cfg.dataset == "mscoco":
            self.name_map = read_image_name_map(
                os.path.join(root, "img_id", "image_ids.txt"))
            lang = Path(ann_file).name.split(".")[0].split("_")[-1]
            id_name = (f"{lang}_val_id.txt" if split == "eval"
                       else f"{lang}_test_id.txt")
        else:
            id_name = "val_id.txt" if split == "eval" else "test_id_2016.txt"

        self.index: EvalIndex = build_eval_index(
            parse_caption_file(os.path.join(root, ann_file)), cfg.max_words)
        split_ids = read_id_file(os.path.join(root, "img_id", id_name))
        self.generated = _read_generated(cfg, split_ids, self.name_map)

    @property
    def texts(self) -> List[str]:
        return self.index.texts

    def __len__(self) -> int:
        return len(self.index.image_ids)

    def image_path(self, image_id: str) -> str:
        if self.cfg.dataset == "mscoco":
            return os.path.join(self.cfg.image_root, self.name_map[image_id])
        return os.path.join(self.cfg.image_root, f"{image_id}.jpg")

    def get(self, index: int):
        """(uint8 image [res, res, 3], MLLM caption or feats, index)."""
        image_id = self.index.image_ids[index]
        img = I.load_eval_image(self.image_path(image_id), self.image_res,
                                fast=self.cfg.fast_decode)
        return img, self.generated[image_id], index


def _video_bank(cfg: DataConfig):
    """The split-independent video inputs: the feature bank and its
    video → frame names map."""
    feat_dir = os.path.join(cfg.root_dir, "FeatureData", cfg.image_root)
    return FeatureBank(feat_dir), read_video2frames(
        os.path.join(feat_dir, "video2frames.txt"))


class VideoTrainDataset:
    """reference video_train_dataset_caption
    (retrieval_dataset_video.py:71-159)."""

    def __init__(self, cfg: DataConfig, max_frames: int = 32):
        self.cfg = cfg
        self.max_frames = max_frames
        self.bank, self.video2frames = _video_bank(cfg)
        train_ids = read_id_file(
            os.path.join(cfg.root_dir, "video_id", "train_id.txt"))
        self.img_ids = {vid: i for i, vid in enumerate(train_ids)}
        self.generated = _read_generated(cfg, train_ids, None)

        self.languages: List[str] = []
        self.caption_maps: List[Dict[str, str]] = []
        self.cap_ids: List[str] = []
        for i, rel in enumerate(cfg.train_file):
            if i != 0:
                self.languages.append(language_of_train_file(rel))
            entries = parse_caption_file(os.path.join(cfg.root_dir, rel))
            self.caption_maps.append(dict(entries))
            if i == 0:
                self.cap_ids = [cid for cid, _ in entries]

    def __len__(self) -> int:
        return len(self.cap_ids)

    caption_key = ImageTrainDataset.caption_key

    def get(self, index: int, rng: np.random.RandomState) -> TrainSample:
        """The sample of caption `index` (rng unused: video features take
        no augmentation)."""
        cap_id = self.cap_ids[index]
        video_id = video_id_of(cap_id)
        frames, mask = self.bank.read_video(self.video2frames[video_id],
                                            self.max_frames)
        texts = [normalize_caption(cmap[self.caption_key(cap_id, k)],
                                   self.cfg.max_words)
                 for k, cmap in enumerate(self.caption_maps)]
        return TrainSample(
            image_u8=None, flip=False, texts=texts,
            caption=self.generated[video_id], idx=self.img_ids[video_id],
            cap_id=cap_id, frames=frames, frame_mask=mask)


class VideoEvalDataset:
    """reference video_eval_dataset_caption
    (retrieval_dataset_video.py:164-244)."""

    def __init__(self, cfg: DataConfig, ann_file: str, max_frames: int = 32,
                 split: str = "eval"):
        self.cfg = cfg
        self.max_frames = max_frames
        self.bank, self.video2frames = _video_bank(cfg)
        id_name = "val_id.txt" if split == "eval" else "test_id.txt"
        split_ids = read_id_file(
            os.path.join(cfg.root_dir, "video_id", id_name))
        self.generated = _read_generated(cfg, split_ids, None)
        self.index: EvalIndex = build_eval_index(
            parse_caption_file(os.path.join(cfg.root_dir, ann_file)),
            cfg.max_words)

    @property
    def texts(self) -> List[str]:
        return self.index.texts

    def __len__(self) -> int:
        return len(self.index.image_ids)

    def get(self, index: int):
        """((frames [max_frames, D] f32, valid mask [max_frames] bool),
        MLLM caption or feats, index)."""
        video_id = self.index.image_ids[index]
        frames = self.bank.read_video(self.video2frames[video_id],
                                      self.max_frames)
        return frames, self.generated[video_id], index
