"""The LECCR retrieval model: towers, caption interaction, heads.

The port of `leccr_tpu/models/leccr.py`, image (`vision.kind: clip_vit`)
and video (`temporal`: self-attention over precomputed frame features, at
the frame features' width `frame_feat_dim`).  With
`caption_encoder_name: mbert` the caption encoder IS the text tower (the
same submodule, called twice); with `clip` it is CLIP's causal text tower
(`clip_text_tower`), whose dims come from the CLIP variant's text fields
and whose caption padding is `caption_ids == 0`.  No gradient
reaches the caption encoder.  `num_queries` learned query slots
cross-attend to the projected caption tokens, then the visual tokens attend
to the slots and the slots attend back to the visual tokens (for video,
past the padded frames' mask).  Features are 256-d L2-normalized
projections of the CLS token (images), of the mean over the valid frames
(video) and of the first token (texts).

Parameters are made on the chosen device from a seeded torch.Generator and
stay f32 (master weights); every Dense and Embed computes in `cfg.dtype`,
casting at use, and the raw tensors (class/position embeddings, proj,
queries) are cast at use too — what flax does with `dtype=` and f32 params.
A fresh model is in eval mode with gradients on: `embed_images` /
`embed_texts` serve, `model.train()` and `model(batch, generators)` train.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from leccr_torch.config import ModelConfig
from leccr_torch.device import resolve_device
from leccr_torch.models.bert import BertEncoder
from leccr_torch.models.clip import (
    CLIP_VARIANTS,
    CLIPTextTower,
    CLIPVisionTower,
    build_vision_tower,
)
from leccr_torch.models.temporal import TemporalTower, masked_mean_pool
from leccr_torch.ops.attention import (
    CrossAttentionStack,
    Dense,
    Embed,
    LayerNorm,
    set_compute_dtype,
)
from leccr_torch.ops.dropout import Generators
from leccr_torch.utils.tracing import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainEmbeddings:
    """Everything the loss suite consumes, all f32.  B = batch,
    n = num_queries, E = embed_dim, Dv = vision width."""

    image_feat: torch.Tensor  # [B, E] L2-normalized fused visual feature
    text_feat_s: torch.Tensor  # [B, E] source-language text feature
    text_feat_t: torch.Tensor  # [B, E] target-language text feature
    slots: torch.Tensor  # [B, n, E] caption_proj1(fused caption slots)
    ori_slots: torch.Tensor  # [B, n, Dv] caption-only slots (pre-fusion)
    cv_caption_mean: torch.Tensor  # [B, Dv] token-mean of normalized slots
    cv_vision_mean: torch.Tensor  # [B, Dv] token-mean of normalized tokens
    # (for video the mean over the valid frames, or over all of them when
    # `video_cv_mask_frames` is off)
    temp: torch.Tensor  # scalar temperature


class LECCRModel(nn.Module):
    """LECCR retrieval model, image or video by `cfg.vision.kind`.

    device: None = the GPU (raises when there is none); pass "cpu" to run
    on the CPU ("meta" builds the module tree without weights).  seed: the
    generator seed of the random initial weights (load trained weights with
    `models.weights.load_jax_params`).
    """

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        if cfg.vision.kind not in ("clip_vit", "temporal"):
            raise ValueError(f"unknown vision tower: {cfg.vision.kind}")
        if cfg.caption_encoder_name not in ("mbert", "clip"):
            raise ValueError(
                f"unknown caption encoder: {cfg.caption_encoder_name}")
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"unsupported compute dtype {cfg.dtype!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.dtype]

        with torch.device("meta"):
            if cfg.vision.kind == "temporal":
                d = cfg.vision.frame_feat_dim
                self.vision_tower = TemporalTower(
                    d, cfg.vision.num_heads, cfg.vision.num_layers,
                    cfg.dropout)
            else:
                self.vision_tower, d = build_vision_tower(cfg.vision,
                                                          remat=cfg.remat)
            self.text_encoder = BertEncoder(cfg.text, remat=cfg.remat)
            if cfg.caption_encoder_name == "clip":
                # the vendored CLIP's own text branch encodes the captions;
                # its dims are the variant's text fields, not the vision
                # tower's overrides (no dropout, no remat)
                var = CLIP_VARIANTS[cfg.vision.variant]
                self.clip_text_tower = CLIPTextTower(
                    width=var.text_width, layers=var.text_layers,
                    heads=var.text_heads, embed_dim=d,
                    vocab_size=var.vocab_size,
                    context_length=var.context_length)
                caption_width = d
            else:
                self.clip_text_tower = None
                caption_width = cfg.text.hidden_size
            heads = 8 if d % 8 == 0 else max(
                h for h in (1, 2, 4) if d % h == 0)
            self.caption_proj = Dense(caption_width, d)
            self.queries = nn.Parameter(torch.empty(cfg.num_queries, d))
            self.crossattn_query = CrossAttentionStack(
                d, heads, cfg.caption_ca_layer, cfg.dropout)
            self.crossattn = CrossAttentionStack(
                d, heads, cfg.caption_interaction_layer, cfg.dropout)
            self.crossattn2 = CrossAttentionStack(
                d, heads, cfg.caption_interaction_layer, cfg.dropout)
            self.caption_proj1 = Dense(d, cfg.embed_dim)
            self.cproj = Dense(d, d)
            self.vproj = Dense(d, d)
            self.text_proj = Dense(cfg.text.hidden_size, cfg.embed_dim)
            if cfg.use_one_cl_proj_only:
                if d != cfg.text.hidden_size:
                    raise ValueError("use_one_cl_proj_only needs equal "
                                     "vision and text widths")
                self.vision_proj = None
            else:
                self.vision_proj = Dense(d, cfg.embed_dim)
            self.temp = nn.Parameter(torch.empty(()))
        self.to_empty(device=device)
        if device.type != "meta":
            self._init_weights(
                torch.Generator(device=device).manual_seed(seed))
        set_compute_dtype(self, self.compute_dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.temp.device

    @torch.no_grad()
    def serve_in_compute_dtype_(self) -> "LECCRModel":
        """Hold every Dense and Embed weight in the compute dtype, in place,
        dropping the f32 masters: a model that only serves then skips the
        cast at every call.  A model that trains keeps f32."""
        for m in self.modules():
            if isinstance(m, (Dense, Embed)):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(self.compute_dtype)
        return self

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """flax's default initializers: lecun-normal kernels, zero biases,
        unit LayerNorms, embeddings of std 1/√dim, CLIP's width^-½ raw
        params, zero query slots, temp = cfg.temp."""
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Dense):
                m.weight.normal_(0.0, m.in_features ** -0.5, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, Embed):
                m.weight.normal_(0.0, m.embedding_dim ** -0.5, generator=gen)
            elif isinstance(m, CLIPVisionTower):
                std = m.class_embedding.shape[0] ** -0.5
                for p in (m.class_embedding, m.positional_embedding, m.proj):
                    p.normal_(0.0, std, generator=gen)
            elif isinstance(m, CLIPTextTower):
                m.positional_embedding.normal_(0.0, 0.01, generator=gen)
                m.text_projection.normal_(
                    0.0, m.text_projection.shape[0] ** -0.5, generator=gen)
        self.queries.zero_()
        self.temp.fill_(self.cfg.temp)

    # ------------------------------------------------------------- towers

    def encode_vision(self, vision: torch.Tensor,
                      vision_mask: Optional[torch.Tensor] = None,
                      deterministic: bool = True,
                      gen: Optional[Generators] = None) -> torch.Tensor:
        """Image [B,H,W,3] -> [B, 1+G², Dv]; video frames [B,T,Df] with
        their valid mask [B,T] -> [B,T,Dv]."""
        with span("model.vision"):
            if self.cfg.vision.kind == "temporal":
                return self.vision_tower(vision, vision_mask, deterministic,
                                         gen)
            return self.vision_tower(vision, deterministic)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor, deterministic: bool = True,
                    gen: Optional[Generators] = None) -> torch.Tensor:
        with span("model.text"):
            return self.text_encoder(input_ids, attention_mask,
                                     deterministic=deterministic, gen=gen)

    def encode_caption(
        self,
        caption_ids: Optional[torch.Tensor],
        caption_mask: torch.Tensor,
        caption_feats: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        gen: Optional[Generators] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode the MLLM-generated caption -> (embeds [B,L,Dc],
        key_padding_mask [B,L] True=pad).  caption_feats short-circuits the
        encoder with precomputed per-token features.  No gradient reaches
        the caption encoder: in training it runs under no_grad (the mBERT
        one with its dropout), the counterpart of the JAX package's
        stop_gradient.  The CLIP caption encoder's padding is
        `caption_ids == 0`."""
        with span("model.caption"):
            if caption_feats is not None:
                return (caption_feats.to(self.compute_dtype).detach(),
                        ~caption_mask.bool())
            with torch.no_grad():
                if self.clip_text_tower is not None:
                    _, hidden = self.clip_text_tower(caption_ids)
                    return hidden, caption_ids == 0
                hidden = self.text_encoder(caption_ids, caption_mask,
                                           deterministic=deterministic,
                                           gen=gen)
            return hidden, ~caption_mask.bool()

    # ------------------------------------------------- caption interaction

    def interact(
        self,
        vision_embeds: torch.Tensor,
        caption_embeds: torch.Tensor,
        caption_padding_mask: Optional[torch.Tensor],
        vision_padding_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
        deterministic: bool = True,
        gen: Optional[Generators] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (fused_vision [B,L,Dv], fused_slots [B,n,Dv],
        ori_slots [B,n,Dv]).  fused=True runs the eval attention cores as
        the fused cross-attention kernel."""
        with span("model.interact"):
            b = vision_embeds.shape[0]
            queries = self.queries.to(vision_embeds.dtype).expand(b, -1, -1)
            cap = self.caption_proj(caption_embeds)
            ori_slots = self.crossattn_query(queries, cap,
                                             caption_padding_mask, fused,
                                             deterministic, gen)
            fused_vision = self.crossattn(vision_embeds, ori_slots, None,
                                          fused, deterministic, gen)
            fused_slots = self.crossattn2(ori_slots, vision_embeds,
                                          vision_padding_mask, fused,
                                          deterministic, gen)
            return fused_vision, fused_slots, ori_slots

    # ------------------------------------------------------------ features

    def vision_features(self, vision_embeds: torch.Tensor,
                        vision_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """L2-normalized projection of the CLS token (images) or of the
        mean over the valid frames (video)."""
        proj = self.vision_proj if self.vision_proj is not None \
            else self.text_proj
        if self.cfg.vision.kind == "temporal":
            pooled = masked_mean_pool(vision_embeds, vision_mask)
        else:
            pooled = vision_embeds[:, 0]
        return _l2_normalize(proj(pooled))

    def text_features(self, text_embeds: torch.Tensor) -> torch.Tensor:
        return _l2_normalize(self.text_proj(text_embeds[:, 0]))

    # --------------------------------------------------------- full passes

    def forward(self, batch: Dict[str, torch.Tensor],
                generators: Optional[Generators] = None) -> TrainEmbeddings:
        """Training forward: towers + interaction + all loss inputs, with
        dropout when the module is in training mode (`generators` then
        gives the random streams).

        batch: "vision" [B,H,W,3] normalized images (or, for video, frames
        [B,T,Df] with "vision_mask" [B,T] bool, True = a real frame),
        "text_ids_s" / "text_mask_s", "text_ids_t" / "text_mask_t",
        "caption_mask" and "caption_ids" or "caption_feats"."""
        deterministic = not self.training
        if not deterministic and generators is None:
            raise ValueError("a training forward needs its Generators")
        gen = generators
        vision_mask = self._vision_mask(batch)
        ori_vision = self.encode_vision(batch["vision"], vision_mask,
                                        deterministic, gen)
        caption_embeds, caption_padding = self.encode_caption(
            batch.get("caption_ids"), batch["caption_mask"],
            batch.get("caption_feats"), deterministic, gen)
        fused_vision, fused_slots, ori_slots = self.interact(
            ori_vision, caption_embeds, caption_padding,
            None if vision_mask is None else ~vision_mask,
            deterministic=deterministic, gen=gen)
        image_feat = self.vision_features(fused_vision, vision_mask)
        # source and target texts in one tower call (doubled batch)
        b = batch["text_ids_s"].shape[0]
        text_embeds_st = self.encode_text(
            torch.cat([batch["text_ids_s"], batch["text_ids_t"]]),
            torch.cat([batch["text_mask_s"], batch["text_mask_t"]]),
            deterministic, gen)
        text_feat_st = self.text_features(text_embeds_st)
        slots = self.caption_proj1(fused_slots)
        # caption_vision_loss inputs: L2-normalize cproj/vproj outputs over
        # cv_normalize_dim (1 = the TOKEN axis, the reference's F.normalize
        # default), then the token mean; for video over the valid frames
        # unless video_cv_mask_frames is off (the reference's plain mean,
        # video_model_retrieval_caption.py:144-160; equal when no frame is
        # padded)
        cv_dim = 1 if self.cfg.cv_normalize_dim == 1 else -1
        cap_norm = _l2_normalize(self.cproj(ori_slots), dim=cv_dim)
        vis_norm = _l2_normalize(self.vproj(ori_vision), dim=cv_dim)
        if vision_mask is not None and self.cfg.video_cv_mask_frames:
            cv_vision_mean = masked_mean_pool(vis_norm, vision_mask)
        else:
            cv_vision_mean = vis_norm.mean(dim=1)
        return TrainEmbeddings(
            image_feat=image_feat.float(),
            text_feat_s=text_feat_st[:b].float(),
            text_feat_t=text_feat_st[b:].float(),
            slots=slots.float(),
            ori_slots=ori_slots.float(),
            cv_caption_mean=cap_norm.mean(dim=1).float(),
            cv_vision_mean=cv_vision_mean.float(),
            temp=self.temp.float(),
        )

    @torch.inference_mode()
    def embed_images(self, batch: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Eval-side visual embedding: towers + caption interaction.

        batch: "vision" [B,H,W,3] normalized images (or video frames
        [B,T,Df] with "vision_mask" [B,T]), "caption_mask" [B,L], and
        "caption_ids" [B,L] or "caption_feats" [B,L,Dc].  Returns
        {"feat": [B,E], "slots": [B,n,E]}, both f32."""
        vision_mask = self._vision_mask(batch)
        ori_vision = self.encode_vision(batch["vision"], vision_mask)
        caption_embeds, caption_padding = self.encode_caption(
            batch.get("caption_ids"), batch["caption_mask"],
            batch.get("caption_feats"))
        fused_vision, fused_slots, _ = self.interact(
            ori_vision, caption_embeds, caption_padding,
            None if vision_mask is None else ~vision_mask,
            fused=self.cfg.fused_eval_attention)
        return {"feat": self.vision_features(fused_vision,
                                             vision_mask).float(),
                "slots": self.caption_proj1(fused_slots).float()}

    def _vision_mask(self, batch: Dict[str, torch.Tensor]
                     ) -> Optional[torch.Tensor]:
        """A video batch's valid-frame mask [B,T] as bool; None for
        images."""
        if self.cfg.vision.kind != "temporal":
            return None
        return batch["vision_mask"].bool()

    @torch.inference_mode()
    def embed_texts(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """Eval-side text embedding -> [B, E] L2-normalized, f32."""
        hidden = self.encode_text(input_ids, attention_mask)
        return self.text_features(hidden).float()


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12,
                  dim: int = -1) -> torch.Tensor:
    """F.normalize semantics (clamped norm), computed in f32 and cast back
    to x's dtype."""
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=dim, keepdim=True).clamp_min(eps)
    return (xf / norm).to(x.dtype)
