"""Image decode and crop (host), normalization and train preprocessing
(device).

The host decodes to uint8 [H, W, 3] with PIL: for training a
RandomResizedCrop (scale (0.5, 1), bicubic) plus the horizontal-flip
decision, for eval a Resize(image_res²) (the reference's transforms); the
device turns the uint8 batch into CLIP-normalized f32 and applies the
flips, so the host hands over 1 byte per pixel.  The host half is a copy
of the JAX package's `data/images.py`: a seeded sample is pixel-identical.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# CLIP normalization constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def decode_image(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 [H, W, 3]."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def sample_resized_crop(
    height: int,
    width: int,
    rng: np.random.RandomState,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box sampling: (top, left, h, w)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = rng.randint(0, height - h + 1)
            left = rng.randint(0, width - w + 1)
            return top, left, h, w
    # center fallback
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def _pil_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.fromarray(img).resize((size[1], size[0]), Image.BICUBIC),
        np.uint8)


def load_train_image(
    path: str, image_res: int, rng: np.random.RandomState,
    fast: bool = False,
) -> Tuple[np.ndarray, bool]:
    """Decode + RandomResizedCrop to [image_res, image_res, 3] uint8, plus the
    hflip decision (applied on the device).  `rng` is drawn in a fixed
    order, crop box then flip, on both paths.

    PIL end to end (crop, resize, one numpy copy of the final tile):
    pixel-identical to torchvision's PIL-backend resized_crop.
    ``fast=True`` (DataConfig.fast_decode) decodes the JPEG at about the
    target resolution with libjpeg's DCT pre-scaling (`Image.draft`) and
    takes the crop box in scaled coordinates: faster, and NOT
    pixel-identical to the exact path.  Non-JPEG sources: draft is a
    no-op."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as img:
        if fast:
            w_full, h_full = img.size
            img.draft("RGB", (image_res, image_res))
            img = img.convert("RGB")
            w0, h0 = img.size
            top, left, h, w = sample_resized_crop(h_full, w_full, rng)
            sx, sy = w0 / w_full, h0 / h_full
            out = img.resize(
                (image_res, image_res), Image.BICUBIC,
                box=(left * sx, top * sy, (left + w) * sx, (top + h) * sy))
        else:
            img = img.convert("RGB")
            w0, h0 = img.size
            top, left, h, w = sample_resized_crop(h0, w0, rng)
            out = img.crop((left, top, left + w, top + h)).resize(
                (image_res, image_res), Image.BICUBIC)
        arr = np.asarray(out, np.uint8)
    return arr, bool(rng.rand() < 0.5)


def load_eval_image(path: str, image_res: int,
                    fast: bool = False) -> np.ndarray:
    """Decode + Resize(image_res²) -> uint8 [image_res, image_res, 3];
    `fast` pre-scales the JPEG decode (see load_train_image)."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as img:
        if fast:
            img.draft("RGB", (image_res, image_res))
        out = img.convert("RGB").resize((image_res, image_res),
                                        Image.BICUBIC)
        return np.asarray(out, np.uint8)


_CLIP_CONSTANTS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _clip_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLIP_MEAN and CLIP_STD on `device`, copied there once, from pinned
    memory without waiting: a copy from pageable host memory each call
    would wait for the device (and could not be captured in a CUDA
    graph)."""
    if device not in _CLIP_CONSTANTS:
        host = (torch.from_numpy(CLIP_MEAN), torch.from_numpy(CLIP_STD))
        if device.type == "cuda":
            host = tuple(t.pin_memory() for t in host)
        _CLIP_CONSTANTS[device] = tuple(t.to(device, non_blocking=True)
                                        for t in host)
    return _CLIP_CONSTANTS[device]


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] → CLIP-normalized f32 [B,H,W,3] on the same device."""
    x = images_u8.to(torch.float32) / 255.0
    mean, std = _clip_constants(x.device)
    return (x - mean) / std


def preprocess_train_images(images_u8: torch.Tensor,
                            flip: Optional[torch.Tensor],
                            gen: Optional[torch.Generator] = None,
                            randaugment_n: int = 0,
                            randaugment_m: int = 7) -> torch.Tensor:
    """Device-side train preprocessing: /255, with randaugment_n > 0 the
    RandAugment policy (`data.randaugment.rand_augment_batch`, n ops at
    magnitude randaugment_m, drawn from the CPU generator `gen`), CLIP
    normalize, then a horizontal flip of the images where flip [B] (bool)
    is set (`leccr_tpu/data/images.py:160-176`)."""
    x = images_u8.to(torch.float32) / 255.0
    if randaugment_n > 0:
        if gen is None:
            raise ValueError("RandAugment (randaugment_n > 0) draws from a "
                             "generator: pass gen")
        from leccr_torch.data.randaugment import rand_augment_batch

        x = rand_augment_batch(x, gen, randaugment_n, randaugment_m)
    mean, std = _clip_constants(x.device)
    x = (x - mean) / std
    if flip is not None:
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return x
