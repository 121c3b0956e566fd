"""Where the port runs: the GPU unless the caller names another device."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a torch.device; None means the GPU, and raises when no
    GPU is present (the port never falls back to the CPU on its own)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: leccr_torch runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda")
