"""Operations, bytes and rooflines: the published H100 peaks, the bound of
each kernel launch at its shapes, the model FLOPs of a train step and of
an eval, and the kernel families of profiled kernel names.

Bounds count each input byte read once and each output byte written once,
and the operations the algorithm needs (two per multiply-add); a launch's
bound is the larger of bytes / HBM rate and operations / peak.  The
formulas of kernels 1-5 give the per-step bounds PERF.md's kernel table
lists (`benchmark/tests/test_benchmark_roofline.py`).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

_KERNEL_NAME = re.compile(r"(?:^|::|\s)(\w+)[<(]")
# the __global__ functions of the port's kernels, by family
_FAMILIES = {"fwd_kernel": "single_fwd", "single_fwd_wgmma_kernel": "single_fwd",
             "bwd_dq_kernel": "single_bwd", "bwd_dkv_kernel": "single_bwd",
             "single_bwd_wgmma_kernel": "single_bwd",
             "chunk_fwd_wgmma_kernel": "chunked",
             "chunk_bwd_dq_wgmma_kernel": "chunked",
             "chunk_bwd_dkv_wgmma_kernel": "chunked",
             "tiled_fwd_wgmma_kernel": "tiled_fwd",
             "tiled_dq_wgmma_kernel": "tiled_dq",
             "tiled_dkv_wgmma_kernel": "tiled_dkv"}


def kernel_family(key: str) -> Optional[str]:
    """The family of a profiled kernel name: "single_fwd" / "single_bwd"
    (kernels 2 / 3), "chunked" (4/5), "tiled_fwd" / "tiled_dq" /
    "tiled_dkv" (6 / 7 / 8), "infonce" (9-11), "fca" (kernel 1); None for
    every other kernel."""
    match = _KERNEL_NAME.search(key)
    if match is None:
        return None
    fn = match.group(1)
    if fn in _FAMILIES:
        return _FAMILIES[fn]
    if fn.startswith("chunk_"):
        return "chunked"
    for n in ("fwd", "dq", "dkv"):
        if fn.startswith(f"tiled_{n}_"):
            return f"tiled_{n}"
    if fn.startswith("infonce_"):
        return "infonce"
    if fn.startswith("fca_"):
        return "fca"
    return None


def bound_ms(n_bytes: float, flops: float, dtype: str = "bfloat16"
             ) -> Tuple[float, str]:
    """(the least ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_launch(direction: str, b: int, h: int, length: int, dh: int,
                 masked: bool, regime: str = "single", item: int = 2,
                 dtype: str = "bfloat16") -> Tuple[float, str]:
    """Bound of one self-attention launch of kernels 2/3 (regime "single")
    or 4/5 ("chunked"): the forward reads q, k, v and writes out and the
    row logsumexp; the backward reads q, k, v, g, lse (and out for the
    chunked one, which takes delta from it) and writes dq, dk, dv; both
    read the key mask, a byte a key, where there is one."""
    numel = b * h * length * dh
    extra = 4 * b * h * length + (b * length if masked else 0)
    if direction == "fwd":
        n_bytes = 4 * numel * item + extra
        flops = 4 * b * h * length * length * dh
    else:
        n_bytes = (7 if regime == "single" else 8) * numel * item + extra
        flops = 10 * b * h * length * length * dh
    return bound_ms(n_bytes, flops, dtype)


def fca_launch(b: int, h: int, lq: int, lk: int, dh: int, masked: bool,
               item: int = 2, dtype: str = "bfloat16") -> Tuple[float, str]:
    """Bound of one kernel 1 launch (eval cross-attention): q, k, v read,
    out written, the key mask (a byte a key) read where given."""
    n_bytes = item * (2 * b * h * lq * dh + 2 * b * h * lk * dh) + (
        b * lk if masked else 0)
    return bound_ms(n_bytes, 4 * b * h * lq * lk * dh, dtype)


# ----------------------------------------------------------- model FLOPs


def vision_forward_flops(arch, images: int) -> float:
    """Matmul FLOPs of the CLIP ViT forward over `images` images."""
    grid = arch.image_res // arch.patch
    t, w = grid * grid + 1, arch.width
    patch = 2 * (t - 1) * arch.patch ** 2 * 3 * w
    layer = 24 * t * w * w + 4 * t * t * w
    return images * (patch + arch.layers * layer + 2 * t * w * arch.vision_dim)


def text_forward_flops(arch, seqs: int, length: int) -> float:
    """Matmul FLOPs of the BERT-family tower over `seqs` rows of `length`
    tokens (padding included: the tower computes it)."""
    d = arch.text_hidden
    layer = 8 * length * d * d + 4 * length * length * d \
        + 4 * length * d * arch.text_intermediate
    return seqs * arch.text_layers * layer


def _cross_layer(tq: int, tk: int, d: int) -> float:
    # q and out projections of the tq rows, k and v of the tk rows, the two
    # attention products, the d -> d -> d feed-forward of the tq rows
    return 4 * tq * d * d + 4 * tk * d * d + 4 * tq * tk * d + 4 * tq * d * d


def interaction_flops(arch, images: int, caption_len: int,
                      train: bool) -> float:
    """Caption projection, the three cross-attention stacks and the heads
    over `images` rows."""
    d, n, embed_dim = arch.vision_dim, arch.queries, arch.embed_dim
    grid = arch.image_res // arch.patch
    t = grid * grid + 1
    per = (2 * caption_len * arch.text_hidden * d
           + arch.ca_layers * _cross_layer(n, caption_len, d)
           + arch.interaction_layers * (_cross_layer(t, n, d)
                                        + _cross_layer(n, t, d))
           + 2 * d * embed_dim)
    if train:  # caption_proj1 on the slots, cproj, vproj
        per += 2 * n * d * embed_dim + 2 * n * d * d + 2 * t * d * d
    return images * per


def train_step_flops(arch, batch: int, text_len: int,
                     caption_len: int) -> float:
    """Model FLOPs of one train step: forward and backward (2× the
    forward) of everything that takes a gradient, the caption encoder's
    forward alone (it runs without one); remat's recompute not counted."""
    grad_part = (vision_forward_flops(arch, batch)
                 + text_forward_flops(arch, 2 * batch, text_len)
                 + 2 * 2 * batch * arch.text_hidden * arch.embed_dim
                 + interaction_flops(arch, batch, caption_len, train=True))
    captions = text_forward_flops(arch, batch, caption_len)
    return 3 * grad_part + captions


def eval_flops(arch, images: int, caption_len: int, texts: int,
               text_len: int) -> float:
    """Model FLOPs of one eval: the image side (tower, caption encoder,
    interaction) over `images`, the text tower over `texts`, the score
    matrix."""
    return (vision_forward_flops(arch, images)
            + text_forward_flops(arch, images, caption_len)
            + interaction_flops(arch, images, caption_len, train=False)
            + text_forward_flops(arch, texts, text_len)
            + 2 * texts * arch.text_hidden * arch.embed_dim
            + 2 * images * texts * arch.embed_dim)


def share(bounds: Iterable[float], measured_ms: float) -> Optional[float]:
    """Σ bound ms / measured ms as a percentage; None without a reading."""
    total = sum(bounds)
    if measured_ms <= 0 or total <= 0:
        return None
    return 100.0 * total / measured_ms


def family_ms(families: Dict[str, float], *names: str) -> float:
    return sum(families.get(n, 0.0) for n in names)


# ------------------------------------------------- launches of the traffic


def flash_regime(h: int, length: int, dh: int) -> str:
    """"single" (kernels 2/3) where the single-block budget holds five
    [H, L, L] f32 tiles and seven [H, L, Dh] ones in 10 MiB, else
    "chunked" (kernels 4/5; the tiled regime starts past 2560 tokens)."""
    tiles = 5 * h * length * length * 4
    qkv = 7 * h * length * dh * 4
    return "single" if tiles + qkv <= 10 * 2 ** 20 else "chunked"


def train_launches(arch, batch: int, text_len: int, caption_len: int):
    """The tower-attention launches of one train step as (regime,
    direction, B, H, L, Dh, masked) rows with their counts: the vision
    tower's blocks (no dropout, no mask), the caption encoder's forward
    (no gradient), the source and target texts in one call; with remat a
    block that takes a gradient runs its forward once more."""
    fwd_times = 2 if arch.remat else 1
    vh, th = arch.heads, arch.text_heads
    t = (arch.image_res // arch.patch) ** 2 + 1
    vdh, tdh = arch.width // vh, arch.text_hidden // th
    rows = []
    for b, h, length, dh, masked, n_fwd, n_bwd in (
            (batch, vh, t, vdh, False, fwd_times * arch.layers, arch.layers),
            (batch, th, caption_len, tdh, True, arch.text_layers, 0),
            (2 * batch, th, text_len, tdh, True, fwd_times * arch.text_layers,
             arch.text_layers)):
        regime = flash_regime(h, length, dh)
        rows.append(((regime, "fwd", b, h, length, dh, masked), n_fwd))
        if n_bwd:
            rows.append(((regime, "bwd", b, h, length, dh, masked), n_bwd))
    return rows


def launch_counts(rows) -> dict:
    """{"single_fwd", "single_bwd", "chunk_fwd", "chunk_bwd": count}."""
    out = {"single_fwd": 0, "single_bwd": 0, "chunk_fwd": 0, "chunk_bwd": 0}
    for (regime, direction, *_), n in rows:
        out[("single" if regime == "single" else "chunk") + "_"
            + direction] += n
    return out


def eval_fca_launches(arch, batch: int, caption_len: int, batches: int):
    """Kernel 1's launches of an eval as ((B, H, Lq, Lk, Dh, masked),
    count): per image batch the caption-query stack (the slots over the
    caption, masked), then the visual tokens over the slots and the slots
    over the visual tokens."""
    h = arch.interaction_heads
    dh = arch.vision_dim // h
    t = (arch.image_res // arch.patch) ** 2 + 1
    n = arch.queries
    return [((batch, h, n, caption_len, dh, True), arch.ca_layers * batches),
            ((batch, h, t, n, dh, False), arch.interaction_layers * batches),
            ((batch, h, n, t, dh, False), arch.interaction_layers * batches)]
