"""Initial weights of a model whose text tower is DeepSeek-V2's
(`text.kind: deepseek_v2`), made from the run's seed on the device.

The scheme of `benchmark.weights` for every leaf that module knows (the
vision tower, the caption interaction, the heads, the temperature); for
the text tower's own leaves, from a stream of their own: RMSNorm scales 1,
the token embedding N(0, 1/width), every linear weight [out, in] (the
router's too) N(0, 1/in), and each expert of a stack [E, out, in]
N(0, 1/in).  A name no rule knows raises.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import torch

from benchmark.weights import initial_weights as base_weights
from benchmark.weights import stream_seed

_TOWER = "text_encoder."
_RMS = re.compile(r"(^|\.)(input_layernorm|post_attention_layernorm|"
                  r"kv_a_layernorm|norm)\.weight$")
_STACK = re.compile(r"\.experts\.(gate|up|down)_proj$")


@torch.no_grad()
def initial_weights(shapes: Sequence[Tuple[str, Tuple[int, ...]]],
                    temp: float, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for the leaves `shapes` (name, shape)."""
    tower = [(n, s) for n, s in shapes if n.startswith(_TOWER)]
    out = base_weights([(n, s) for n, s in shapes
                        if not n.startswith(_TOWER)], temp, seed, device)
    total = sum(_numel(s) for _, s in tower)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 4))
    flat = torch.randn(total, generator=g, device=device)
    offset = 0
    for name, shape in tower:
        n = _numel(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        if _RMS.search(name):
            t.fill_(1.0)
        elif name.endswith("embed_tokens.weight"):
            t.mul_(shape[1] ** -0.5)
        elif _STACK.search(name) and len(shape) == 3:
            t.mul_(shape[2] ** -0.5)
        elif name.endswith(".weight") and len(shape) == 2:
            t.mul_(shape[1] ** -0.5)
        else:
            raise ValueError(f"no initial value rule for parameter {name} "
                             f"{tuple(shape)}")
        out[name] = t
    return {name: out[name] for name, _ in shapes}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
