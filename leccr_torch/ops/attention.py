"""Attention blocks of the LECCR caption-interaction branch and of the
video temporal tower, and the layers every module of the port is built
from.

The port of `leccr_tpu/ops/attention.py`: batch-first [B, L, D] tensors,
q/k/v split as [B, H, L, Dh], key padding masks with True = padding, and
the reference's unusual residual (the attention output feeds the FFN, and
the residual joins the *block input* to the FFN output):

    out = LayerNorm(tgt + Dropout(FFN(MHA(tgt, memory))))

Parameters stay f32 (master weights); `Dense` and `Embed` compute in their
`compute_dtype`, casting input, weight and bias at use, as flax's
`Dense(dtype=...)` does.  Dropout runs when a caller passes
`deterministic=False` with a `Generators`.  In eval (`deterministic`) with
`fused=True` the attention core runs as the hand-written CUDA kernel
(`ops/fused_cross_attention.py`), as the JAX package does only then.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from leccr_torch.ops.dropout import Generators, lean_dropout
from leccr_torch.ops.fused_cross_attention import fused_cross_attention


class Dense(nn.Linear):
    """nn.Linear with f32 master params that computes in `compute_dtype`
    (input, weight and bias cast at use)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Embedding):
    """nn.Embedding with an f32 table whose rows come out in
    `compute_dtype`."""

    compute_dtype = torch.float32

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Set the compute dtype of every submodule that has one."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


class LayerNorm(nn.LayerNorm):
    """flax-style LayerNorm: statistics and affine map in f32 whatever the
    input dtype (params stay f32), result cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class RMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + eps) · weight, computed in f32 whatever the
    input dtype (the weight stays f32), the result cast back."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    gen: Optional[Generators] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain multi-head attention core in the inputs' dtype (softmax in f32).

    q: [B, H, Lq, Dh]; k: [B, H, Lk, Dh]; v: [B, H, Lk, Dv];
    key_padding_mask: [B, Lk] bool, True = padding.  `causal`: query i sees
    keys j ≤ i alone.  The scores are q·kᵀ / √Dh, or q·kᵀ · `scale` where
    given.  In training the probabilities keep with probability 1 − rate
    and are scaled by 1/(1 − rate), in q's dtype."""
    if scale is None:
        scores = torch.matmul(q, k.transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    else:
        scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :],
                             torch.finfo(scores.dtype).min, scores)
    if causal:
        lq, lk = scores.shape[-2:]
        future = torch.ones(lq, lk, dtype=torch.bool,
                            device=scores.device).triu(1)
        scores = torch.where(future, torch.finfo(scores.dtype).min, scores)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and not deterministic:
        keep = torch.rand(probs.shape, generator=gen.device,
                          device=probs.device) < 1.0 - dropout_rate
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.matmul(probs, v)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q/k/v/out projections."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = Dense(d_model, d_model)
        self.k_proj = Dense(d_model, d_model)
        self.v_proj = Dense(d_model, d_model)
        self.out_proj = Dense(d_model, d_model)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
        deterministic: bool = True,
        gen: Optional[Generators] = None,
    ) -> torch.Tensor:
        d_model = self.q_proj.out_features
        head_dim = d_model // self.num_heads

        def split(x):
            b, l, _ = x.shape
            return x.view(b, l, self.num_heads, head_dim).transpose(1, 2)

        q = split(self.q_proj(query))
        k = split(self.k_proj(key))
        v = split(self.v_proj(value))
        if fused and deterministic:
            out = fused_cross_attention(q, k, v, key_padding_mask)
        else:
            out = dot_product_attention(q, k, v, key_padding_mask,
                                        self.dropout, deterministic, gen)
        b, _, lq, _ = out.shape
        # under tensor parallelism out_proj is row-parallel on this
        # replicated output (`parallel.tensor`)
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, d_model))


class _FFN(nn.Module):
    """d→d feed-forward with the exact (erf) GELU, dropout after it."""

    def __init__(self, d_model: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Dense(d_model, d_model)
        self.linear2 = Dense(d_model, d_model)
        # (dim, m, M) when linear1 is column-parallel (`parallel.tensor`):
        # the dropout takes rank m's slice of the whole activation's mask
        self.dropout_shard = None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                gen: Optional[Generators] = None) -> torch.Tensor:
        x = F.gelu(self.linear1(x))
        return self.linear2(lean_dropout(x, self.dropout, deterministic, gen,
                                         self.dropout_shard))


class CrossAttentionBlock(nn.Module):
    """One LECCR cross-attention layer.  Its LayerNorm uses flax's default
    epsilon, 1e-6 (not torch's 1e-5)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.ffn = _FFN(d_model, dropout)
        self.norm = LayerNorm(d_model, eps=1e-6)

    def forward(
        self,
        tgt: torch.Tensor,
        memory: torch.Tensor,
        memory_key_padding_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
        deterministic: bool = True,
        gen: Optional[Generators] = None,
    ) -> torch.Tensor:
        attn_out = self.attn(tgt, memory, memory, memory_key_padding_mask,
                             fused, deterministic, gen)
        ffn_out = self.ffn(attn_out, deterministic, gen)
        ffn_out = lean_dropout(ffn_out, self.dropout, deterministic, gen)
        return self.norm(tgt + ffn_out)


class CrossAttentionStack(nn.Module):
    """N cross-attention layers over the same memory."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int = 1,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            CrossAttentionBlock(d_model, num_heads, dropout)
            for _ in range(num_layers))

    def forward(
        self,
        tgt: torch.Tensor,
        memory: torch.Tensor,
        memory_key_padding_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
        deterministic: bool = True,
        gen: Optional[Generators] = None,
    ) -> torch.Tensor:
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, memory_key_padding_mask, fused,
                        deterministic, gen)
        return out


class SelfAttentionBlock(CrossAttentionBlock):
    """One LECCR self-attention layer: the cross block's residual and norm
    pattern with q = k = v = src, the key padding mask over src's own
    positions (the video temporal tower over padded frames).  Its core is
    always the plain attention, as the JAX package's (which never passes
    `fused` here)."""

    def forward(
        self,
        src: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        gen: Optional[Generators] = None,
    ) -> torch.Tensor:
        return super().forward(src, src, key_padding_mask, False,
                               deterministic, gen)


class SelfAttentionStack(nn.Module):
    """N self-attention layers."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int = 1,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            SelfAttentionBlock(d_model, num_heads, dropout)
            for _ in range(num_layers))

    def forward(
        self,
        src: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        gen: Optional[Generators] = None,
    ) -> torch.Tensor:
        out = src
        for layer in self.layers:
            out = layer(out, key_padding_mask, deterministic, gen)
        return out
