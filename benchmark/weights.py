"""Initial weights made from the run's seed, on the device, in one call.

Both sides take these: the program copies them into its model's f32
master parameters, and the reference reads them as a dict.  The scheme is
the usual one for these layers (flax's defaults): LayerNorm scales 1,
biases 0, linear weights N(0, 1/fan_in), embedding tables N(0, 1/width),
CLIP's class and position embeddings and projection N(0, 1/width), the
query slots 0 and the temperature the configuration's.  The leaves are
told apart by name; a name no rule knows raises.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import torch

_NORM = re.compile(r"(^|\.)(ln_1|ln_2|ln_pre|ln_post|ln_final|embeddings_ln|"
                   r"out_ln|output_ln|norm)\.weight$")
_EMBED = re.compile(r"\.(word|position|token_type)_embeddings\.weight$")
_CLIP_RAW = ("vision_tower.class_embedding",
             "vision_tower.positional_embedding", "vision_tower.proj")


def stream_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed of the run's `seed` for one purpose (weights, data,
    ...), so that the streams do not overlap."""
    return (seed * 0x9E3779B97F4A7C15 + purpose * 0xBF58476D1CE4E5B9) \
        & 0x7FFFFFFFFFFFFFFF


@torch.no_grad()
def initial_weights(shapes: Sequence[Tuple[str, Tuple[int, ...]]],
                    temp: float, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for the leaves `shapes` (name, shape), views of
    one buffer drawn from `seed`."""
    total = sum(_numel(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    flat = torch.randn(total, generator=g, device=device)
    out, offset = {}, 0
    width = dict(shapes).get("vision_tower.class_embedding", (1,))[0]
    for name, shape in shapes:
        n = _numel(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        if name.endswith(".bias") or name == "queries":
            t.zero_()
        elif _NORM.search(name):
            t.fill_(1.0)
        elif name == "temp":
            t.fill_(temp)
        elif name in _CLIP_RAW:
            t.mul_(width ** -0.5)
        elif _EMBED.search(name):
            t.mul_(shape[1] ** -0.5)
        elif name.endswith(".weight") and len(shape) == 2:
            t.mul_(shape[1] ** -0.5)
        else:
            raise ValueError(f"no initial value rule for parameter {name} "
                             f"{tuple(shape)}")
        out[name] = t
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
