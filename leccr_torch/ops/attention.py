"""Attention blocks of the LECCR caption-interaction branch (inference).

The port of `leccr_tpu/ops/attention.py`: batch-first [B, L, D] tensors,
q/k/v split as [B, H, L, Dh], key padding masks with True = padding, and
the reference's unusual residual (the attention output feeds the FFN, and
the residual joins the *block input* to the FFN output):

    out = LayerNorm(tgt + FFN(MHA(tgt, memory)))

Eval mode only: no dropout.  With `fused=True` the attention core runs as
the hand-written CUDA kernel (`ops/fused_cross_attention.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from leccr_torch.ops.fused_cross_attention import fused_cross_attention


class LayerNorm(nn.LayerNorm):
    """flax-style LayerNorm: statistics and affine map in f32 whatever the
    input dtype (params stay f32), result cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain multi-head attention core in the inputs' dtype (softmax in f32).

    q: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh]; key_padding_mask: [B, Lk] bool,
    True = padding."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :],
                             torch.finfo(scores.dtype).min, scores)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q/k/v/out projections."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
    ) -> torch.Tensor:
        d_model = self.q_proj.out_features
        head_dim = d_model // self.num_heads

        def split(x):
            b, l, _ = x.shape
            return x.view(b, l, self.num_heads, head_dim).transpose(1, 2)

        q = split(self.q_proj(query))
        k = split(self.k_proj(key))
        v = split(self.v_proj(value))
        if fused:
            out = fused_cross_attention(q, k, v, key_padding_mask)
        else:
            out = dot_product_attention(q, k, v, key_padding_mask)
        b, _, lq, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, d_model))


class _FFN(nn.Module):
    """d→d feed-forward with the exact (erf) GELU."""

    def __init__(self, d_model: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_model)
        self.linear2 = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class CrossAttentionBlock(nn.Module):
    """One LECCR cross-attention layer.  Its LayerNorm uses flax's default
    epsilon, 1e-6 (not torch's 1e-5)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, num_heads)
        self.ffn = _FFN(d_model)
        self.norm = LayerNorm(d_model, eps=1e-6)

    def forward(
        self,
        tgt: torch.Tensor,
        memory: torch.Tensor,
        memory_key_padding_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
    ) -> torch.Tensor:
        attn_out = self.attn(tgt, memory, memory, memory_key_padding_mask,
                             fused)
        return self.norm(tgt + self.ffn(attn_out))


class CrossAttentionStack(nn.Module):
    """N cross-attention layers over the same memory."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            CrossAttentionBlock(d_model, num_heads)
            for _ in range(num_layers))

    def forward(
        self,
        tgt: torch.Tensor,
        memory: torch.Tensor,
        memory_key_padding_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
    ) -> torch.Tensor:
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, memory_key_padding_mask, fused)
        return out
