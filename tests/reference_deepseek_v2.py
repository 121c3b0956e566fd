"""A plain float32 reference of DeepSeek-V2's decoder block as a causal
text tower, for the port's CPU tests (`test_torch_deepseek_text.py`).

Written from the DeepSeek-V2 paper (arXiv 2405.04434) and
`modeling_deepseek.py` beside the published checkpoints: RMSNorm, multi-head
latent attention without query compression and with YaRN RoPE on the
decoupled key and query part, a dense SwiGLU first layer, then MoE layers
(softmax router over all experts, greedy top-k unnormalised, routed
SwiGLU experts plus shared ones), a final RMSNorm.  Weights come as a dict
of tensors under the port's parameter names (`text_encoder.` dropped).
The MoE layer computes the part of the experts [offset, offset + held)
alone, each expert by a loop over its tokens.  Departure from
`modeling_deepseek.py`: the balance loss counts valid tokens only.

It imports neither JAX nor any module of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate.T) * (x @ up.T)) @ down.T


def _yarn_mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_cos_sin(c: dict, length: int):
    """cos, sin [length, rope dim] of DeepSeek-V2's YaRN rotary embedding."""
    d, base = c["qk_rope_head_dim"], c["rope_theta"]
    y = c["rope_scaling"]
    half = torch.arange(0, d, 2, dtype=torch.float64) / d
    extra = base ** -half
    inter = extra / y["factor"]
    dim_of = [d * math.log(y["original_max_position_embeddings"]
                           / (r * 2 * math.pi)) / (2 * math.log(base))
              for r in (y["beta_fast"], y["beta_slow"])]
    lo = max(math.floor(dim_of[0]), 0)
    hi = min(math.ceil(dim_of[1]), d - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float64) - lo) / (hi - lo)
            ).clamp(0, 1)
    inv = inter * ramp + extra * (1 - ramp)
    scale = (_yarn_mscale(y["factor"], y["mscale"])
             / _yarn_mscale(y["factor"], y["mscale_all_dim"]))
    ang = torch.arange(length, dtype=torch.float64)[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)
    return ((ang.cos() * scale).float(), (ang.sin() * scale).float())


def apply_rope(x, cos, sin):
    """modeling_deepseek.py: de-interleave the pairs, then rotate halves."""
    d = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def attention(P, pre, x, valid, c, cos, sin):
    b, l, _ = x.shape
    nh, nope, rp, vd = (c["num_heads"], c["qk_nope_head_dim"],
                        c["qk_rope_head_dim"], c["v_head_dim"])
    q = (x @ P[f"{pre}.q_proj.weight"].T).view(b, l, nh, nope + rp)
    q = q.permute(0, 2, 1, 3)
    kv_a = x @ P[f"{pre}.kv_a_proj_with_mqa.weight"].T
    latent, k_pe = kv_a[..., :c["kv_lora_rank"]], kv_a[..., c["kv_lora_rank"]:]
    kv = rms(latent, P[f"{pre}.kv_a_layernorm.weight"], c["rms_norm_eps"]) \
        @ P[f"{pre}.kv_b_proj.weight"].T
    kv = kv.view(b, l, nh, nope + vd).permute(0, 2, 1, 3)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin)], -1)
    k_pe = apply_rope(k_pe[:, None], cos, sin).expand(b, nh, l, rp)
    k = torch.cat([k_nope, k_pe], -1)
    y = c["rope_scaling"]
    m = _yarn_mscale(y["factor"], y["mscale_all_dim"])
    scale = (nope + rp) ** -0.5 * m * m
    s = q @ k.transpose(-1, -2) * scale
    allowed = torch.tril(torch.ones(l, l, dtype=torch.bool)) & valid[:, None,
                                                                     None, :]
    s = s.masked_fill(~allowed, -torch.inf)
    out = (torch.softmax(s, -1) @ v).permute(0, 2, 1, 3).reshape(b, l, -1)
    return out @ P[f"{pre}.o_proj.weight"].T


def routed(P, pre, x, valid, c, held: int, offset: int):
    """(the part [B, L, H] of the experts [offset, offset + held), whose
    stacks hold those experts alone, router scores [B, L, E], top-k
    choices [B, L, k]): each expert's tokens in a loop."""
    scores = torch.softmax(x @ P[f"{pre}.gate.weight"].T, -1)
    top_w, top_e = torch.topk(scores, c["num_experts_per_tok"], -1)
    out = torch.zeros_like(x)
    for e in range(held):
        for bi, li, j in (top_e == offset + e).nonzero().tolist():
            if not valid[bi, li]:
                continue
            out[bi, li] = out[bi, li] + top_w[bi, li, j] * swiglu(
                x[bi, li], P[f"{pre}.experts.gate_proj"][e],
                P[f"{pre}.experts.up_proj"][e],
                P[f"{pre}.experts.down_proj"][e])
    return out, scores, top_e


def balance_loss(scores, top_e, valid):
    """Σ_i f_i P_i a sequence over its valid tokens, the mean over them."""
    e, k = scores.shape[-1], top_e.shape[-1]
    per_seq = []
    for bi in range(scores.shape[0]):
        v = valid[bi]
        n = max(int(v.sum()), 1)
        counts = torch.zeros(e)
        for row in top_e[bi][v]:
            counts[row] += 1
        f = counts * e / (k * n)
        p = scores[bi][v].sum(0) / n
        per_seq.append((f * p).sum())
    return torch.stack(per_seq).mean()


def tower(P: Dict[str, torch.Tensor], c: dict, ids, mask, held: int,
          offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                    List[torch.Tensor]]:
    """(hidden [B, L, H], α-weighted balance loss, each MoE layer's
    choices) of the tower on right-padded ids with `mask`."""
    valid = mask.bool()
    eps = c["rms_norm_eps"]
    h = P["embed_tokens.weight"][ids]
    cos, sin = rope_cos_sin(c, ids.shape[1])
    aux, choices = torch.zeros(()), []
    for i in range(c["num_layers"]):
        pre = f"layers.{i}"
        h = h + attention(P, f"{pre}.self_attn",
                          rms(h, P[f"{pre}.input_layernorm.weight"], eps),
                          valid, c, cos, sin)
        x = rms(h, P[f"{pre}.post_attention_layernorm.weight"], eps)
        m = f"{pre}.mlp"
        if i < c["first_k_dense_replace"]:
            h = h + swiglu(x, P[f"{m}.gate_proj.weight"],
                           P[f"{m}.up_proj.weight"],
                           P[f"{m}.down_proj.weight"])
            continue
        part, scores, top_e = routed(P, m, x, valid, c, held, offset)
        h = h + part + swiglu(x, P[f"{m}.shared_experts.gate_proj.weight"],
                              P[f"{m}.shared_experts.up_proj.weight"],
                              P[f"{m}.shared_experts.down_proj.weight"])
        aux = aux + balance_loss(scores, top_e, valid)
        choices.append(top_e)
    return rms(h, P["norm.weight"], eps), aux * c["aux_loss_alpha"], choices


def last_token(hidden, mask):
    return torch.stack([hidden[b, int(mask[b].sum()) - 1]
                        for b in range(hidden.shape[0])])
