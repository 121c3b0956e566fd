"""Multilingual BERT-family text tower.

The port of `leccr_tpu/models/bert.py`: post-LN layers, exact-erf GELU,
LayerNorm epsilon `layer_norm_eps` (1e-12 for mBERT), and the same module
for both `kind`s — `xlmr` only changes the position ids (RoBERTa style:
cumulative over real tokens, offset by `pad_token_id`).

The attention-mask bias of the plain path follows the JAX order of casts:
(1 - mask) · f32 min, computed in f32 and THEN cast to the compute dtype.
In bf16 that cast rounds to -inf; in f32 it stays finite.

Training (`deterministic=False`, with a `Generators`): dropout at
`hidden_dropout` after the embeddings LayerNorm, the attention output
projection and the FFN output.  With `fused_attention` the attention core
is the flash tower-attention kernel pair, with its dropout at
`attention_dropout` drawn in-kernel from one fresh int32 seed per layer per
call (taken from the host generator, so no device sync); otherwise the
plain core with dropout on the probabilities.

With `remat` (the config's `model.remat`, flax's `nn.remat` per layer) each
layer runs under `checkpoint_block` whenever a gradient is being taken: its
activations are recomputed in the backward, with the same random draws.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from leccr_torch.config import TextConfig
from leccr_torch.ops.attention import Dense, Embed, LayerNorm
from leccr_torch.ops.dropout import Generators, checkpoint_block, lean_dropout
from leccr_torch.ops.flash_attention import flash_tower_attention


class _BertSelfAttention(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.query = Dense(h, h)
        self.key = Dense(h, h)
        self.value = Dense(h, h)
        self.out = Dense(h, h)
        self.out_ln = LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                deterministic: bool = True,
                gen: Optional[Generators] = None) -> torch.Tensor:
        cfg = self.cfg
        b, l, width = hidden.shape
        head_dim = width // self.num_heads

        def split(x):
            return x.view(b, l, self.num_heads, head_dim).transpose(1, 2)

        q = split(self.query(hidden))
        k = split(self.key(hidden))
        v = split(self.value(hidden))
        if cfg.fused_attention and not deterministic:
            rate = cfg.attention_dropout
            seed = gen.flash_seed() if rate > 0.0 else 0
            # padding = 1 - mask, nonzero where mask != 1
            out = flash_tower_attention(q, k, v, attention_mask != 1, seed,
                                        rate)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / (head_dim ** 0.5)
            bias = 1.0 - attention_mask[:, None, None, :].float()
            scores = scores + (bias * torch.finfo(torch.float32).min).to(
                scores.dtype)
            probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
            probs = lean_dropout(probs, cfg.attention_dropout, deterministic,
                                 gen)
            out = torch.matmul(probs, v)
        out = self.out(out.transpose(1, 2).reshape(b, l, width))
        out = lean_dropout(out, cfg.hidden_dropout, deterministic, gen)
        return self.out_ln(out + hidden)


class _BertLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.hidden_dropout = cfg.hidden_dropout
        self.attention = _BertSelfAttention(cfg)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.output_ln = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                deterministic: bool = True,
                gen: Optional[Generators] = None) -> torch.Tensor:
        attn = self.attention(hidden, attention_mask, deterministic, gen)
        out = self.output(F.gelu(self.intermediate(attn)))
        out = lean_dropout(out, self.hidden_dropout, deterministic, gen)
        return self.output_ln(out + attn)


class BertEncoder(nn.Module):
    """BERT encoder returning last_hidden_state [B, L, H]."""

    def __init__(self, cfg: TextConfig, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        h = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, h)
        self.position_embeddings = Embed(cfg.max_position_embeddings, h)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, h)
        self.embeddings_ln = LayerNorm(h, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            _BertLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        gen: Optional[Generators] = None,
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
        hidden = lean_dropout(hidden, self.cfg.hidden_dropout, deterministic,
                              gen)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                hidden = checkpoint_block(layer, gen, hidden, attention_mask,
                                          deterministic, gen)
            else:
                hidden = layer(hidden, attention_mask, deterministic, gen)
        return hidden
