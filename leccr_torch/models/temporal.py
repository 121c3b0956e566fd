"""Video temporal tower: self-attention over precomputed per-frame features
(the port of `leccr_tpu/models/temporal.py`).

The reference's `SelfAttention(d_model=vision_width, nhead=8,
num_layers=vision_layer)` stack (models/video_model_retrieval_caption.py:
27-34) applied to padded frame-feature sequences with a key padding mask.
MSR-VTT ships 4096-d frame CNN features.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from leccr_torch.ops.attention import SelfAttentionStack
from leccr_torch.ops.dropout import Generators


class TemporalTower(nn.Module):
    """forward(frames [B, T, D], frame_mask [B, T] bool True = VALID) ->
    [B, T, D] contextualized frame features in the compute dtype.  The
    valid mask is flipped into the attention's padding mask here, as the
    reference flips it before its attention."""

    def __init__(self, d_model: int, num_heads: int = 8, num_layers: int = 1,
                 dropout: float = 0.1):
        super().__init__()
        self.encoder = SelfAttentionStack(d_model, num_heads, num_layers,
                                          dropout)
        self.compute_dtype = torch.float32

    def forward(self, frames: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                gen: Optional[Generators] = None) -> torch.Tensor:
        padding_mask = None if frame_mask is None else ~frame_mask.bool()
        return self.encoder(frames.to(self.compute_dtype), padding_mask,
                            deterministic, gen)


def masked_mean_pool(embeds: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Mean over the sequence axis of the rows where `mask` is set
    (reference models/xvlm_video.py:268-271), in embeds' dtype."""
    mask = mask.to(embeds.dtype)[..., None]
    return (embeds * mask).sum(dim=1) / torch.clamp_min(mask.sum(dim=1),
                                                        1e-6)
