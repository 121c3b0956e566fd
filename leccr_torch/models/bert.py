"""Multilingual BERT-family text tower (inference).

The port of `leccr_tpu/models/bert.py`: post-LN layers, exact-erf GELU,
LayerNorm epsilon `layer_norm_eps` (1e-12 for mBERT), and the same module
for both `kind`s — `xlmr` only changes the position ids (RoBERTa style:
cumulative over real tokens, offset by `pad_token_id`).

The attention-mask bias follows the JAX order of casts:
(1 - mask) · f32 min, computed in f32 and THEN cast to the compute dtype.
In bf16 that cast rounds to -inf; in f32 it stays finite.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from leccr_torch.config import TextConfig
from leccr_torch.ops.attention import LayerNorm


class _BertSelfAttention(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)
        self.out_ln = LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, hidden: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        b, l, width = hidden.shape
        head_dim = width // self.num_heads

        def split(x):
            return x.view(b, l, self.num_heads, head_dim).transpose(1, 2)

        q = split(self.query(hidden))
        k = split(self.key(hidden))
        v = split(self.value(hidden))
        scores = torch.matmul(q, k.transpose(-1, -2)) / (head_dim ** 0.5)
        bias = 1.0 - attention_mask[:, None, None, :].float()
        scores = scores + (bias * torch.finfo(torch.float32).min).to(
            scores.dtype)
        probs = torch.softmax(scores.float(), dim=-1).to(hidden.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, width)
        return self.out_ln(self.out(out) + hidden)


class _BertLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.attention = _BertSelfAttention(cfg)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.output_ln = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, hidden: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        attn = self.attention(hidden, attention_mask)
        out = self.output(F.gelu(self.intermediate(attn)))
        return self.output_ln(out + attn)


class BertEncoder(nn.Module):
    """BERT encoder returning last_hidden_state [B, L, H]."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.embeddings_ln = LayerNorm(h, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            _BertLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if self.cfg.kind == "xlmr":
            mask = attention_mask.long()
            positions = torch.cumsum(mask, dim=1) * mask + self.cfg.pad_token_id
        else:
            positions = torch.arange(input_ids.shape[1],
                                     device=input_ids.device)[None, :]
        hidden = (self.word_embeddings(input_ids)
                  + self.position_embeddings(positions)
                  + self.token_type_embeddings(token_type_ids))
        hidden = self.embeddings_ln(hidden)
        for layer in self.layers:
            hidden = layer(hidden, attention_mask)
        return hidden
