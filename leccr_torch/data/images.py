"""Eval image decode (host) and normalization (device).

The host decodes and resizes to uint8 [H, W, 3] (PIL, bicubic, the
reference's test transform); the device turns the uint8 batch into CLIP-
normalized f32, so the host hands over 1 byte per pixel.
"""

from __future__ import annotations

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
