"""DeepSeek-V2's decoder block as a causal text tower (`text.kind:
deepseek_v2`; the port alone: the JAX package has no such tower).

The layer equations of the DeepSeek-V2 paper (arXiv 2405.04434) and of
`modeling_deepseek.py` beside its published checkpoints, in pre-norm
residual form on the hidden state h:

    h ← h + MLA(RMSNorm(h)),   h ← h + FFN(RMSNorm(h))

- RMSNorm: x · rsqrt(mean(x²) + eps) · g in f32, cast back.
- Multi-head latent attention (no query compression): q = W_q x split per
  head into a `qk_nope_head_dim` part and a `qk_rope_head_dim` part;
  [c, k_pe] = W_kva x, the latent c RMS-normed and up-projected by W_kvb to
  each head's k_nope and v; RoPE (YaRN-scaled where `rope_scaling` says)
  on q_pe and on the one k_pe every head shares, in the de-interleaved
  layout of `modeling_deepseek.py`; a causal softmax over the valid keys
  at scale (q_head_dim)^-½ · mscale(factor, mscale_all_dim)²; W_o.
- FFN: SwiGLU of width `intermediate_size` in the first
  `first_k_dense_replace` layers; after them a mixture of experts
  (`MoE`): a softmax router over `n_routed_experts` in f32, the greedy
  top `num_experts_per_tok` unnormalised, each chosen expert a SwiGLU of
  width `moe_intermediate_size`, plus `n_shared_experts` shared ones as
  one SwiGLU of that many times the width.

The MoE layer holds `experts_held` experts from `expert_offset` on (0 =
all) and computes their part alone (`ops.moe`): one card's share of an
expert-parallel deployment, with no exchange.  Padded positions (texts
are right-padded) route to no expert; under the causal mask they never
reach a valid position.  No dropout.  The tower returns the final
RMS-normed hidden state; `LECCRModel` pools its last valid token.

Each MoE layer keeps its last routing of each call (`call`: "text" or
"caption") in `routing_record[call]` (`RoutingRecord`, device tensors):
the choices [B, L, k] (-1 at padding) and the slots of each held expert
[held + 1] (the rest last).  Spans: `text.mla` around each layer's
attention, `text.moe` around each MoE layer.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from leccr_torch.config import DeepseekConfig, TextConfig
from leccr_torch.ops.attention import (
    Dense,
    Embed,
    RMSNorm,
    dot_product_attention,
)
from leccr_torch.ops.moe import (
    ExpertStack,
    balance_loss,
    route,
    routed_experts,
)
from leccr_torch.utils.tracing import span


class RoutingRecord(NamedTuple):
    choices: torch.Tensor  # [B, L, k] experts chosen, -1 at padding
    counts: torch.Tensor  # [held + 1] slots of each held expert, the rest


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_inv_freq(cfg: DeepseekConfig, device=None
                  ) -> Tuple[torch.Tensor, float]:
    """(the inverse frequencies [rope_dim / 2] in f32 on `device`, the
    cos/sin scale): DeepSeek-V2's YaRN (`DeepseekV2YarnRotaryEmbedding`)
    where `rope_scaling` is set, plain RoPE otherwise."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    ys = cfg.rope_scaling
    if not ys:
        return extra, 1.0
    factor = ys["factor"]
    inter = 1.0 / (factor * base ** exps)
    orig = ys["original_max_position_embeddings"]

    def correction(rotations):
        return (dim * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction(ys["beta_fast"])), 0)
    high = min(math.ceil(correction(ys["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    extra_mask = 1.0 - ramp
    inv_freq = inter * (1 - extra_mask) + extra * extra_mask
    scale = (yarn_mscale(factor, ys.get("mscale", 1.0))
             / yarn_mscale(factor, ys.get("mscale_all_dim", 0.0)))
    return inv_freq, scale


def softmax_scale(cfg: DeepseekConfig) -> float:
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    ys = cfg.rope_scaling
    if ys and ys.get("mscale_all_dim"):
        m = yarn_mscale(ys["factor"], ys["mscale_all_dim"])
        scale = scale * m * m
    return scale


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """RoPE on x [..., L, d] in `modeling_deepseek.py`'s layout: the pairs
    (2i, 2i + 1) are first moved to (i, i + d/2); in f32, cast back."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(
        *lead, d)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.gate_proj = Dense(dim, inner, bias=False)
        self.up_proj = Dense(dim, inner, bias=False)
        self.down_proj = Dense(inner, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(Dense):
    """The MoE gate's [E, dim] weight, applied in f32 whatever the compute
    dtype, as `modeling_deepseek.py`'s `MoEGate` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float())


class MLA(nn.Module):
    """Multi-head latent attention without query compression."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        h, nh, d = cfg.hidden_size, cfg.num_heads, cfg.deepseek
        self.num_heads, self.d = nh, d
        q_dim = d.qk_nope_head_dim + d.qk_rope_head_dim
        self.q_proj = Dense(h, nh * q_dim, bias=False)
        self.kv_a_proj_with_mqa = Dense(
            h, d.kv_lora_rank + d.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(d.kv_lora_rank, d.rms_norm_eps)
        self.kv_b_proj = Dense(
            d.kv_lora_rank, nh * (d.qk_nope_head_dim + d.v_head_dim),
            bias=False)
        self.o_proj = Dense(nh * d.v_head_dim, h, bias=False)
        self.scale = softmax_scale(d)

    def forward(self, x: torch.Tensor, pad: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        d = self.d
        b, l, _ = x.shape
        nh, nope, rope = self.num_heads, d.qk_nope_head_dim, \
            d.qk_rope_head_dim
        q = self.q_proj(x).view(b, l, nh, nope + rope).transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split(
            [d.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(
            b, l, nh, nope + d.v_head_dim).transpose(1, 2)
        k_nope, v = kv.split([nope, d.v_head_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe.unsqueeze(1), cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, nh, l, rope)], dim=-1)
        out = dot_product_attention(q, k, v, pad, causal=True,
                                    scale=self.scale)
        return self.o_proj(out.transpose(1, 2).reshape(
            b, l, nh * d.v_head_dim))


class MoE(nn.Module):
    """The routed experts this layer holds and the shared experts."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        h, d = cfg.hidden_size, cfg.deepseek
        self.top_k = d.num_experts_per_tok
        self.held = d.experts_held or d.n_routed_experts
        self.offset = d.expert_offset
        if not 0 <= self.offset <= d.n_routed_experts - self.held:
            raise ValueError(f"experts [{self.offset}, {self.offset} + "
                             f"{self.held}) of {d.n_routed_experts}")
        self.gate = Router(h, d.n_routed_experts, bias=False)
        self.experts = ExpertStack(self.held, h, d.moe_intermediate_size)
        self.shared_experts = SwiGLU(
            h, d.moe_intermediate_size * d.n_shared_experts)
        self.routing_record: Dict[str, RoutingRecord] = {}

    def forward(self, x: torch.Tensor, valid: torch.Tensor, call: str,
                balance: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, l, h = x.shape
        t = x.reshape(b * l, h)
        logits = self.gate(t)
        scores = torch.softmax(logits, dim=-1, dtype=torch.float32)
        r = route(scores, valid.reshape(-1), self.top_k, self.held,
                  self.offset)
        self.routing_record[call] = RoutingRecord(
            torch.where(valid.reshape(-1, 1), r.experts, -1).view(b, l, -1),
            r.counts)
        st = self.experts
        y = (routed_experts(t, r, st.gate_proj, st.up_proj, st.down_proj)
             + self.shared_experts(t)).view(b, l, h)
        aux = (balance_loss(scores.view(b, l, -1), r.experts.view(b, l, -1),
                            valid) if balance else None)
        return y, aux


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig, moe: bool):
        super().__init__()
        eps = cfg.deepseek.rms_norm_eps
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.mlp = (MoE(cfg) if moe
                    else SwiGLU(cfg.hidden_size, cfg.intermediate_size))

    def forward(self, h, valid, cos, sin, call: str, balance: bool):
        with span("text.mla"):
            h = h + self.self_attn(self.input_layernorm(h), ~valid, cos, sin)
        x = self.post_attention_layernorm(h)
        if not isinstance(self.mlp, MoE):
            return h + self.mlp(x), None
        with span("text.moe"):
            y, aux = self.mlp(x, valid, call, balance)
            return h + y, aux


class DeepseekV2Encoder(nn.Module):
    """The tower: token embedding, `num_layers` decoder layers, the final
    RMSNorm -> [B, L, hidden] in the compute dtype."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i >= cfg.deepseek.first_k_dense_replace)
            for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.deepseek.rms_norm_eps)

    def rope(self, length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """cos and sin [length, qk_rope_head_dim] f32, made on the device
        (nothing crosses from the host)."""
        inv_freq, scale = rope_inv_freq(self.cfg.deepseek, device)
        freqs = torch.outer(torch.arange(length, dtype=torch.float32,
                                         device=device), inv_freq)
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos() * scale, emb.sin() * scale

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                call: str = "text", balance: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the hidden state [B, L, hidden], the balance loss summed over
        the MoE layers and weighted by `aux_loss_alpha`, or None unless
        `balance`)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        valid = attention_mask.bool()
        cos, sin = self.rope(input_ids.shape[1], input_ids.device)
        h = self.embed_tokens(input_ids)
        total = None
        for layer in self.layers:
            h, aux = layer(h, valid, cos, sin, call, balance)
            if aux is not None:
                total = aux if total is None else total + aux
        if total is not None:
            total = total * self.cfg.deepseek.aux_loss_alpha
        return self.norm(h), total
