"""The traffic generator's shared pieces.  A mix's data file
(`benchmark/traffic/<mix>.json`) gives the parameters (lengths, counts,
shares); its kind's input maker (`benchmark/kinds/<kind>.py`, `inputs`)
turns them into inputs on the device from the run's seed with these.

Lengths are drawn on the host from the seed (a few hundred numbers); ids,
images and flips on the device in a few large calls.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

FIRST_ID = 1000  # ids below are special tokens in both vocabularies


def bucket_width(lengths: Sequence[int], buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ the longest sequence, clamped to the largest (the
    program's loaders, `data.pipeline.bucket_width`)."""
    need = max(lengths)
    for b in sorted(buckets):
        if b >= need:
            return b
    return sorted(buckets)[-1]


def lengths(host: np.random.Generator, span: Sequence[int], n: int
            ) -> np.ndarray:
    """n real lengths drawn uniformly from [low, high]."""
    return host.integers(span[0], span[1] + 1, n)


def tokens(g: torch.Generator, lens: np.ndarray, width: int, vocab: int,
           device) -> tuple:
    """(ids [N, width] int64, mask [N, width] int32): real tokens then
    zero padding; a length past the width is cut to it."""
    n = len(lens)
    lens = torch.as_tensor(np.minimum(lens, width), device=device)
    mask = (torch.arange(width, device=device)[None, :] < lens[:, None])
    ids = torch.randint(min(FIRST_ID, vocab // 2), vocab, (n, width),
                        generator=g, device=device)
    return ids * mask, mask.to(torch.int32)


def images(g: torch.Generator, n: int, res: int, device) -> torch.Tensor:
    """n uint8 [res, res, 3] images."""
    return torch.randint(0, 256, (n, res, res, 3), dtype=torch.uint8,
                         generator=g, device=device)
