"""The LECCR retrieval model in plain PyTorch, float32: the reference that
decides whether the benchmark's timed path computed the right thing.

Written from the model's description (the LECCR paper, arXiv 2409.19961:
a CLIP ViT vision tower, a BERT-family text tower that also encodes the
MLLM caption, learned query slots cross-attending to the caption, the
visual tokens and the slots attending to each other, 256-d L2-normalized
features).  It imports nothing of the program and of the JAX package:
parameters arrive as a dict from name to tensor, under the names the
benchmark's weights (`benchmark.weights`) give them, and every shape comes
from the configuration file.

Dropout is part of what a training step computes, so a training forward
draws the same bits as the program it is held against: the step's random
streams are seeded from the configuration's seed and the step number
(`Streams`), the bits of every dropout are drawn in the program's order
and shapes (16-bit integers for dropout on activations, uniform floats on
the caption-interaction probabilities), and the towers' fused attention
keeps a probability where a murmur3 hash of its position and a per-layer
seed clears the rate (`keep_mask`).

`Precision` carries the arithmetic of every matrix product: float32 (the
reference) or float32 on operands rounded to fp8 as a scaled fp8 training
path rounds them (e4m3 forward, e5m2 gradients, one scale per tensor), the
control that a comparison has to fail.  Building a `Model` turns TF32
off for the process: the reference runs after the program's window.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32_MIN = torch.finfo(torch.float32).min
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# (width, layers, heads, patch, embed_dim) of OpenAI CLIP's vision towers
CLIP_VISION = {"ViT-B/32": (768, 12, 12, 32, 512),
               "ViT-B/16": (768, 12, 12, 16, 512),
               "ViT-L/14": (1024, 24, 16, 14, 768)}


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to the fp8 format `dtype` under one scale for the tensor
    (its largest magnitude maps to the format's largest value)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """An fp8 training path's operand: e4m3 going forward, and the gradient
    that flows back through the product rounded to e5m2, each under its
    own per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """Matrix products in float32, or (fp8=True) on operands rounded to
    fp8 as a scaled fp8 training path rounds them (`_RoundFp8`), the
    products summed in f32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(x) if self.fp8 else x

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._round(a), self._round(b))

    def linear(self, x, w, b=None):
        return F.linear(self._round(x), self._round(w), b)


@dataclasses.dataclass(frozen=True)
class Arch:
    """The shapes and rates of one configuration (its `model` section)."""

    width: int
    layers: int
    heads: int
    patch: int
    vision_dim: int
    image_res: int
    vision_fused: bool
    text_kind: str
    text_hidden: int
    text_layers: int
    text_heads: int
    text_intermediate: int
    text_eps: float
    text_fused: bool
    hidden_dropout: float
    attention_dropout: float
    pad_token_id: int
    interaction_heads: int
    ca_layers: int
    interaction_layers: int
    dropout: float
    cv_dim: int
    remat: bool
    weights: Dict[str, float]
    dstl_alpha: float
    temp: float
    queries: int
    embed_dim: int

    @staticmethod
    def of(model: dict) -> "Arch":
        vision, text = model["vision"], model["text"]
        width, layers, heads, patch, dim = CLIP_VISION[vision["variant"]]
        if vision.get("width"):  # the test-size rules of narrowed towers
            width, heads, dim = vision["width"], max(1, vision["width"] // 64), \
                vision["width"]
        layers = vision.get("depth") or layers
        ih = 8 if dim % 8 == 0 else max(h for h in (1, 2, 4) if dim % h == 0)
        return Arch(
            width=width, layers=layers, heads=heads, patch=patch,
            vision_dim=dim, image_res=vision["image_res"],
            vision_fused=bool(vision.get("fused_attention", False)),
            text_kind=text.get("kind", "bert"),
            text_hidden=text["hidden_size"], text_layers=text["num_layers"],
            text_heads=text["num_heads"],
            text_intermediate=text["intermediate_size"],
            text_eps=float(text.get("layer_norm_eps", 1e-12)),
            text_fused=bool(text.get("fused_attention", False)),
            hidden_dropout=float(text.get("hidden_dropout", 0.1)),
            attention_dropout=float(text.get("attention_dropout", 0.1)),
            pad_token_id=int(text.get("pad_token_id", 0)),
            interaction_heads=ih,
            ca_layers=model.get("caption_ca_layer", 3),
            interaction_layers=model.get("caption_interaction_layer", 2),
            dropout=float(model.get("dropout", 0.1)),
            cv_dim=1 if model.get("cv_normalize_dim", 1) == 1 else -1,
            remat=bool(model.get("remat", False)),
            weights={k: float(model.get(k, v)) for k, v in (
                ("weight_caption_loss", 0.01), ("weight_reg_loss", 0.01),
                ("weight_dstl_loss", 0.5), ("weight_cv_loss", 0.01))},
            dstl_alpha=float(model.get("dstl_alpha", 0.8)),
            temp=float(model.get("temp", 0.07)),
            queries=model.get("num_queries", 4),
            embed_dim=model.get("embed_dim", 256))


class Streams:
    """The random streams of one training step: a device generator for the
    dropout bits and a host generator for the fused attention's per-layer
    seeds, seeded as the program seeds the step (`seed` is
    (train.seed + 17) · 2³² + step)."""

    def __init__(self, seed: int, device):
        self.device = torch.Generator(device=device).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed ^ 0x5DEECE66D)

    def flash_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))


def step_stream_seed(train_seed: int, step_no: int) -> int:
    return ((train_seed + 17) << 32) + step_no


# ------------------------------------------------------------- dropout


def drop_bits(x: torch.Tensor, rate: float, streams: Optional[Streams]):
    """Activation dropout: 16-bit draws, kept where ≥ round(rate · 2¹⁶),
    survivors scaled by 1/(1 − rate)."""
    if streams is None or rate == 0.0:
        return x
    thresh = min(65535, int(round(rate * 65536.0)))
    bits = torch.randint(0, 65536, x.shape, generator=streams.device,
                         device=x.device, dtype=torch.int32)
    return torch.where(bits >= thresh, x * (1.0 / (1.0 - rate)),
                       torch.zeros((), device=x.device))


def _u32(x):
    return x & 0xFFFFFFFF


def _mul_u32(x, c):
    lo, hi = c & 0xFFFF, c >> 16
    return _u32(x * lo + (_u32(x * hi) & 0xFFFF) * 65536)


def keep_mask(seed: int, b: int, h: int, lq: int, lk: int, rate: float,
              device) -> torch.Tensor:
    """The fused tower attention's dropout factor [B, H, Lq, Lk]: element
    (b, h, i, j) hashes the counter h·Lq·Lk + i·Lk + j plus
    s_b · 0x9E3779B9 with s_b = seed + b · 0x9E3779B9 (all mod 2³²) through
    the murmur3 finalizer; kept where the hash ≥ rate · 2³², scaled by
    1/(1 − rate)."""
    ctr = torch.arange(h * lq * lk, dtype=torch.int64, device=device)
    seeds = _u32(int(seed) + _mul_u32(
        torch.arange(b, dtype=torch.int64, device=device), 0x9E3779B9))
    x = _u32(ctr[None, :] + _mul_u32(seeds, 0x9E3779B9)[:, None])
    x = _mul_u32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul_u32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    keep = (x >= int(rate * 4294967296.0)).to(torch.float32)
    return (keep * (1.0 / (1.0 - rate))).view(b, h, lq, lk)


# ---------------------------------------------------------------- layers


class Model:
    """The reference forward passes over a parameter dict `P`."""

    def __init__(self, P: Dict[str, torch.Tensor], arch: Arch,
                 prec: Optional[Precision] = None):
        self.P, self.a = P, arch
        self.q = prec or Precision()
        # a float32 product on this card may run in TF32 unless told not to
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def lin(self, x, name, bias=True):
        return self.q.linear(x, self.P[name + ".weight"],
                             self.P[name + ".bias"] if bias else None)

    def ln(self, x, name, eps):
        return F.layer_norm(x, (x.shape[-1],), self.P[name + ".weight"],
                            self.P[name + ".bias"], eps)

    @staticmethod
    def heads(x, h):
        b, l, d = x.shape
        return x.view(b, l, h, d // h).transpose(1, 2)

    @staticmethod
    def merge(x):
        b, h, l, dh = x.shape
        return x.transpose(1, 2).reshape(b, l, h * dh)

    def attend(self, q, k, v, pad=None, keep=None):
        """softmax(q kᵀ / √d, padded keys at the f32 minimum) [· keep] v."""
        s = self.q.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if pad is not None:
            s = torch.where(pad[:, None, None, :], F32_MIN, s)
        p = torch.softmax(s, dim=-1)
        if keep is not None:
            p = p * keep
        return self.q.matmul(p, v)

    # ------------------------------------------------------------ vision

    def vision(self, images: torch.Tensor, grad: bool) -> torch.Tensor:
        """Normalized NHWC images -> [B, 1 + G², vision_dim]."""
        a, pre = self.a, "vision_tower"
        b, h, w, c = images.shape
        p = a.patch
        patches = images.reshape(b, h // p, p, w // p, p, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)
        x = self.lin(patches, f"{pre}.conv1", bias=False)
        cls = self.P[f"{pre}.class_embedding"].expand(b, 1, -1)
        x = torch.cat([cls, x], 1) + self.P[f"{pre}.positional_embedding"]
        x = self.ln(x, f"{pre}.ln_pre", 1e-5)
        for i in range(a.layers):
            name = f"{pre}.transformer.resblocks.{i}"
            if grad and a.remat:
                x = checkpoint(self._vision_block, x, name,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = self._vision_block(x, name)
        x = self.ln(x, f"{pre}.ln_post", 1e-5)
        return self.q.matmul(x, self.P[f"{pre}.proj"])

    def _vision_block(self, x, name):
        y = self.ln(x, f"{name}.ln_1", 1e-5)
        q, k, v = (self.heads(t, self.a.heads)
                   for t in self.lin(y, f"{name}.attn.in_proj").chunk(3, -1))
        x = x + self.lin(self.merge(self.attend(q, k, v)),
                         f"{name}.attn.out_proj")
        y = self.lin(self.ln(x, f"{name}.ln_2", 1e-5), f"{name}.c_fc")
        return x + self.lin(y * torch.sigmoid(1.702 * y), f"{name}.c_proj")

    # -------------------------------------------------------------- text

    def text(self, ids: torch.Tensor, mask: torch.Tensor,
             streams: Optional[Streams]) -> torch.Tensor:
        """The BERT-family tower -> [B, L, hidden]; `streams` = training
        (dropout on)."""
        a, pre = self.a, "text_encoder"
        if a.text_kind == "xlmr":
            m = mask.long()
            pos = torch.cumsum(m, dim=1) * m + a.pad_token_id
        else:
            pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        h = (self.P[f"{pre}.word_embeddings.weight"][ids]
             + self.P[f"{pre}.position_embeddings.weight"][pos]
             + self.P[f"{pre}.token_type_embeddings.weight"][
                 torch.zeros_like(ids)])
        h = self.ln(h, f"{pre}.embeddings_ln", a.text_eps)
        h = drop_bits(h, a.hidden_dropout, streams)
        pad = mask != 1
        for i in range(a.text_layers):
            h = self._text_layer(h, pad, f"{pre}.layers.{i}", streams)
        return h

    def _text_layer(self, h, pad, name, streams):
        a = self.a
        q, k, v = (self.heads(self.lin(h, f"{name}.attention.{n}"),
                              a.text_heads) for n in ("query", "key", "value"))
        keep = None
        if streams is not None and a.attention_dropout > 0.0:
            b, nh, l, _ = q.shape
            if a.text_fused:
                keep = keep_mask(streams.flash_seed(), b, nh, l, l,
                                 a.attention_dropout, q.device)
            else:
                bits = torch.randint(0, 65536, (b, nh, l, l),
                                     generator=streams.device,
                                     device=q.device, dtype=torch.int32)
                thresh = min(65535, int(round(a.attention_dropout * 65536)))
                keep = (bits >= thresh).float() / (1 - a.attention_dropout)
        out = self.lin(self.merge(self.attend(q, k, v, pad, keep)),
                       f"{name}.attention.out")
        out = drop_bits(out, a.hidden_dropout, streams)
        attn = self.ln(out + h, f"{name}.attention.out_ln", a.text_eps)
        out = self.lin(F.gelu(self.lin(attn, f"{name}.intermediate")),
                       f"{name}.output")
        out = drop_bits(out, a.hidden_dropout, streams)
        return self.ln(out + attn, f"{name}.output_ln", a.text_eps)

    # ------------------------------------------------- caption interaction

    def cross_stack(self, pre, n, tgt, mem, pad, streams):
        for i in range(n):
            tgt = self._cross_block(f"{pre}.layers.{i}", tgt, mem, pad,
                                    streams)
        return tgt

    def _cross_block(self, name, tgt, mem, pad, streams):
        a = self.a
        q = self.heads(self.lin(tgt, f"{name}.attn.q_proj"),
                       a.interaction_heads)
        k = self.heads(self.lin(mem, f"{name}.attn.k_proj"),
                       a.interaction_heads)
        v = self.heads(self.lin(mem, f"{name}.attn.v_proj"),
                       a.interaction_heads)
        keep = None
        if streams is not None and a.dropout > 0.0:
            shape = (q.shape[0], q.shape[1], q.shape[2], k.shape[2])
            keep = (torch.rand(shape, generator=streams.device,
                               device=q.device) < 1.0 - a.dropout
                    ).float() / (1.0 - a.dropout)
        attn = self.lin(self.merge(self.attend(q, k, v, pad, keep)),
                        f"{name}.attn.out_proj")
        ffn = F.gelu(self.lin(attn, f"{name}.ffn.linear1"))
        ffn = self.lin(drop_bits(ffn, a.dropout, streams),
                       f"{name}.ffn.linear2")
        ffn = drop_bits(ffn, a.dropout, streams)
        return self.ln(tgt + ffn, f"{name}.norm", 1e-6)

    def interact(self, vis, cap_hidden, cap_pad, streams):
        b = vis.shape[0]
        queries = self.P["queries"].expand(b, -1, -1)
        cap = self.lin(cap_hidden, "caption_proj")
        ori_slots = self.cross_stack("crossattn_query", self.a.ca_layers,
                                     queries, cap, cap_pad, streams)
        fused_vis = self.cross_stack("crossattn", self.a.interaction_layers,
                                     vis, ori_slots, None, streams)
        fused_slots = self.cross_stack("crossattn2",
                                       self.a.interaction_layers, ori_slots,
                                       vis, None, streams)
        return fused_vis, fused_slots, ori_slots

    # -------------------------------------------------------- full passes

    def train_forward(self, batch, streams: Streams) -> Dict[str, torch.Tensor]:
        """The loss inputs of one training forward (dropout on)."""
        images = train_images(batch["vision"], batch.get("flip"))
        vis = self.vision(images, grad=True)
        with torch.no_grad():
            cap_hidden = self.text(batch["caption_ids"],
                                   batch["caption_mask"], streams)
        fused_vis, fused_slots, ori_slots = self.interact(
            vis, cap_hidden, ~batch["caption_mask"].bool(), streams)
        image_feat = l2n(self.lin(fused_vis[:, 0], "vision_proj"))
        b = batch["text_ids_s"].shape[0]
        text = self.text(torch.cat([batch["text_ids_s"], batch["text_ids_t"]]),
                         torch.cat([batch["text_mask_s"],
                                    batch["text_mask_t"]]), streams)
        text_feat = l2n(self.lin(text[:, 0], "text_proj"))
        cap_norm = l2n(self.lin(ori_slots, "cproj"), dim=self.a.cv_dim)
        vis_norm = l2n(self.lin(vis, "vproj"), dim=self.a.cv_dim)
        return {"image_feat": image_feat, "text_feat_s": text_feat[:b],
                "text_feat_t": text_feat[b:],
                "slots": self.lin(fused_slots, "caption_proj1"),
                "ori_slots": ori_slots,
                "cv_caption_mean": cap_norm.mean(dim=1),
                "cv_vision_mean": vis_norm.mean(dim=1),
                "temp": self.P["temp"]}

    @torch.no_grad()
    def embed_images(self, images_u8, caption_ids, caption_mask):
        """Eval-side image features [B, E] (no dropout)."""
        vis = self.vision(normalize(images_u8), grad=False)
        cap_hidden = self.text(caption_ids, caption_mask, None)
        fused_vis, _, _ = self.interact(vis, cap_hidden,
                                        ~caption_mask.bool(), None)
        return l2n(self.lin(fused_vis[:, 0], "vision_proj"))

    @torch.no_grad()
    def embed_texts(self, ids, mask):
        return l2n(self.lin(self.text(ids, mask, None)[:, 0], "text_proj"))


def l2n(x, dim=-1):
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True
                                        ).clamp_min(1e-12)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def train_images(images_u8, flip):
    x = normalize(images_u8)
    if flip is not None:
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return x
