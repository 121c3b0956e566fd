"""Eval image decode (host), normalization and train preprocessing
(device).

The host decodes and resizes to uint8 [H, W, 3] (PIL, bicubic, the
reference's test transform); the device turns the uint8 batch into CLIP-
normalized f32, so the host hands over 1 byte per pixel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# CLIP normalization constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_eval_image(path: str, image_res: int) -> np.ndarray:
    """Decode + Resize(image_res²) → uint8 [image_res, image_res, 3]."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as img:
        out = img.convert("RGB").resize((image_res, image_res),
                                        Image.BICUBIC)
        return np.asarray(out, np.uint8)


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] → CLIP-normalized f32 [B,H,W,3] on the same device."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.from_numpy(CLIP_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_STD).to(x.device)
    return (x - mean) / std


def preprocess_train_images(images_u8: torch.Tensor,
                            flip: Optional[torch.Tensor],
                            randaugment_n: int = 0) -> torch.Tensor:
    """Device-side train preprocessing: /255, CLIP normalize, then a
    horizontal flip of the images where flip [B] (bool) is set."""
    if randaugment_n > 0:
        raise NotImplementedError(
            "device RandAugment (randaugment_n > 0) comes with a later "
            "slice of the port")
    x = normalize_images(images_u8)
    if flip is not None:
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return x
