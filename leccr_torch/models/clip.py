"""OpenAI-CLIP-architecture vision tower.

The port of the vision half of `leccr_tpu/models/clip.py`: pre-LN residual
transformer with QuickGELU MLPs, a ViT patch embedding with a class token,
and ln_post + proj applied to EVERY token (LECCR consumes per-token
features).  Images are NHWC.  LayerNorms use CLIP's epsilon, 1e-5.

The patch embedding (a stride-P convolution with no bias) is written as a
reshape of each P×P×3 patch into one row and a matmul, so no cuDNN (and no
TF32 convolution) is involved; its weight is the flax conv kernel
[kh, kw, in, out] flattened to [out, kh·kw·in].

The tower's position embedding has one row per patch of `image_res` (plus
the class token): a checkpoint trained at another resolution is carried
over by `interpolate_pos_embed` (see `models/convert.py`).

The tower has no dropout.  With `fused_attention` and in training
(`deterministic=False`) each block's attention core is the flash
tower-attention kernel pair at rate 0 (`models/clip.py:78-80` of the JAX
package); in eval it stays plain PyTorch ops, as in the JAX package.
`flash_tower_attention` takes the single-block kernels at ViT-B/32 @384
(145 tokens), the chunked ones at ViT-L/14 @336 (577 tokens) and the tiled
ones at ViT-L/14 @728 (2705 tokens; past 1408 tokens in f32).

With `remat` (flax's `nn.remat` per residual block) each block runs under
`checkpoint_block` whenever a gradient is being taken.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from leccr_torch.ops.attention import Dense, LayerNorm
from leccr_torch.ops.dropout import checkpoint_block
from leccr_torch.ops.flash_attention import flash_tower_attention


@dataclasses.dataclass(frozen=True)
class CLIPVariant:
    vision_width: int
    vision_layers: int
    vision_heads: int
    patch_size: int
    embed_dim: int  # projection dim == the "vision_width" LECCR sees
    text_width: int
    text_layers: int
    text_heads: int
    vocab_size: int = 49408
    context_length: int = 77


CLIP_VARIANTS = {
    "ViT-B/32": CLIPVariant(768, 12, 12, 32, 512, 512, 12, 8),
    "ViT-B/16": CLIPVariant(768, 12, 12, 16, 512, 512, 12, 8),
    "ViT-L/14": CLIPVariant(1024, 24, 16, 14, 768, 768, 12, 12),
}


def interpolate_pos_embed(pos_embed: torch.Tensor,
                          target_grid: int) -> torch.Tensor:
    """Bicubic-resample a [1+G*G, W] CLIP position embedding to a
    target_grid × target_grid patch grid, keeping the class token's row
    (the port of `leccr_tpu/models/clip.py:167-186`).  `jax.image.resize`'s
    bicubic is Keys' cubic at a = −0.5 with antialiasing, which is what
    `F.interpolate(..., antialias=True)` computes, up and down (without
    antialiasing PyTorch takes a = −0.75 and differs by ~0.3 on a unit
    normal grid).  Computed in f32; returns pos_embed's dtype."""
    num_tokens, width = pos_embed.shape
    grid = int(round((num_tokens - 1) ** 0.5))
    if grid * grid + 1 != num_tokens:
        raise ValueError(f"{num_tokens} rows are not a class token and a "
                         f"square patch grid")
    if grid == target_grid:
        return pos_embed
    patches = pos_embed[1:].float().reshape(grid, grid, width)
    patches = F.interpolate(patches.permute(2, 0, 1)[None],
                            size=(target_grid, target_grid), mode="bicubic",
                            align_corners=False, antialias=True)
    patches = patches[0].permute(1, 2, 0).reshape(-1, width)
    return torch.cat([pos_embed[:1], patches.to(pos_embed.dtype)])


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


class _CLIPAttention(nn.Module):
    """Non-causal self-attention of a CLIP block (packed in_proj)."""

    def __init__(self, width: int, heads: int, fused: bool = False):
        super().__init__()
        self.heads = heads
        self.fused = fused
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)

    def forward(self, x: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        b, l, width = x.shape
        head_dim = width // self.heads
        q, k, v = (t.view(b, l, self.heads, head_dim).transpose(1, 2)
                   for t in self.in_proj(x).chunk(3, dim=-1))
        if self.fused and not deterministic:
            out = flash_tower_attention(q, k, v, None, 0, 0.0)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / (head_dim ** 0.5)
            probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
            out = torch.matmul(probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, width))


class _ResidualBlock(nn.Module):
    """Pre-LN residual attention block."""

    def __init__(self, width: int, heads: int, fused: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = _CLIPAttention(width, heads, fused)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.c_fc = Dense(width, 4 * width)
        self.c_proj = Dense(4 * width, width)

    def forward(self, x: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), deterministic)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 fused: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            _ResidualBlock(width, heads, fused) for _ in range(layers))

    def forward(self, x: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for block in self.resblocks:
            x = (checkpoint_block(block, None, x, deterministic) if remat
                 else block(x, deterministic))
        return x


class CLIPVisionTower(nn.Module):
    """CLIP ViT returning the full projected hidden state.

    Input [B, H, W, 3] (NHWC, normalized); output [B, 1+G², embed_dim] with
    G = image_res / patch_size.  For ViT-B/32 @ 384²: [B, 145, 512].
    """

    compute_dtype = torch.float32

    def __init__(self, width: int, layers: int, heads: int, patch_size: int,
                 embed_dim: int, image_res: int,
                 fused_attention: bool = False, remat: bool = False):
        super().__init__()
        if image_res % patch_size:
            raise ValueError(f"image_res {image_res} is not a multiple of "
                             f"the patch size {patch_size}")
        grid = image_res // patch_size
        self.patch_size = patch_size
        self.conv1 = Dense(patch_size * patch_size * 3, width, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, layers, heads,
                                        fused_attention, remat)
        self.ln_post = LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, image: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        b, h, w, c = image.shape
        p = self.patch_size
        n_tokens = self.positional_embedding.shape[0]
        if h % p or w % p or (h // p) * (w // p) + 1 != n_tokens:
            raise ValueError(f"image {h}x{w} does not match the tower's "
                             f"{n_tokens - 1} patches of {p}x{p}")
        dtype = self.compute_dtype
        patches = image.to(dtype).reshape(b, h // p, p, w // p, p, c)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
            b, (h // p) * (w // p), p * p * c)
        x = self.conv1(patches)
        cls = self.class_embedding.to(dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.transformer(self.ln_pre(x), deterministic)
        return self.ln_post(x) @ self.proj.to(dtype)


def build_vision_tower(cfg, remat: bool = False
                       ) -> Tuple[CLIPVisionTower, int]:
    """Build a CLIPVisionTower from a VisionConfig; returns (tower, width
    seen by the retrieval head).  Test-size overrides (cfg.width/depth)
    follow the JAX package's rules: heads = width // 64 and embed_dim =
    width when the width is overridden."""
    var = CLIP_VARIANTS[cfg.variant]
    width = cfg.width or var.vision_width
    depth = cfg.depth or var.vision_layers
    heads = (var.vision_heads if width == var.vision_width
             else max(1, width // 64))
    embed_dim = var.embed_dim if not cfg.width else width
    tower = CLIPVisionTower(width=width, layers=depth, heads=heads,
                            patch_size=var.patch_size, embed_dim=embed_dim,
                            image_res=cfg.image_res,
                            fused_attention=cfg.fused_attention,
                            remat=remat)
    return tower, embed_dim
