"""The LECCR multi-level loss suite on one device, in f32.

The port of the dense part of `leccr_tpu/models/losses.py`: soft-label
InfoNCE, the max-over-slot caption contrastive loss, the KL soft-label
distillation (dstl), the token-mean caption↔vision loss, the slot-diversity
regularizer, and `compute_losses`, which composes them exactly as the
reference does and returns the same 10 keys.

`num_blocks` reproduces the reference's per-rank-local losses: the global
batch is split into that many contiguous blocks and the loss is the mean of
the per-block losses.  For large batches `compute_losses` takes another
InfoNCE (`itc_loss_fn`, e.g. `ops.infonce.infonce_loss`, which never builds
the [B, B] logits) and streams the dstl and caption-vision losses in row
blocks (`stream_block_rows`: `dstl_loss_blockwise`,
`caption_vision_loss_blockwise`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from leccr_torch.models.leccr import TrainEmbeddings

LOSS_KEYS = ("loss_itc_vs", "loss_itc_vt", "loss_itc_st", "loss_itc_c",
             "loss_reg_c", "raw_itc_vs", "raw_itc_vt", "raw_dstl", "raw_cv",
             "total")


def _log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(x.float(), dim=dim)


def soft_label_contrastive_loss(
    feat_a: torch.Tensor,
    feat_b: torch.Tensor,
    temp: torch.Tensor,
    idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional InfoNCE with duplicate-aware soft labels: rows with
    equal idx are all positives, the positive mass split uniformly.  The
    row-normalized label matrix serves both directions, as in the
    reference."""
    logits = (feat_a @ feat_b.T) / temp
    if idx is None:
        labels = torch.eye(logits.shape[0], device=logits.device)
    else:
        pos = (idx[:, None] == idx[None, :]).float()
        labels = pos / pos.sum(dim=1, keepdim=True)
    loss_a2b = -(_log_softmax(logits, 1) * labels).sum(dim=1).mean()
    loss_b2a = -(_log_softmax(logits.T, 1) * labels).sum(dim=1).mean()
    return (loss_a2b + loss_b2a) / 2.0


def caption_contrastive_loss(
    slots: torch.Tensor,
    text_feat: torch.Tensor,
    temp: torch.Tensor,
    num_blocks: int = 1,
) -> torch.Tensor:
    """Max-over-slot caption↔text InfoNCE, local to each of `num_blocks`
    blocks.  slots: [B, n, E] (not normalized); text_feat: [B, E]."""
    b, n, e = slots.shape
    if b % num_blocks:
        raise ValueError(f"batch {b} does not split into {num_blocks} blocks")
    bl = b // num_blocks
    sim = torch.einsum("wbne,wce->wbnc", slots.reshape(num_blocks, bl, n, e),
                       text_feat.reshape(num_blocks, bl, e))
    logits = sim.amax(dim=2) / temp
    diag = torch.arange(bl, device=slots.device)
    loss_i2t = -_log_softmax(logits, 2)[:, diag, diag].mean()
    loss_t2i = -_log_softmax(logits.transpose(1, 2), 2)[:, diag, diag].mean()
    return (loss_i2t + loss_t2i) / 2.0


def _norm_score(score: torch.Tensor) -> torch.Tensor:
    """Global min-max normalization."""
    score = score - score.min()
    return score / score.max()


def dstl_loss(
    image_feat: torch.Tensor,
    slots: torch.Tensor,
    text_feat_s: torch.Tensor,
    text_feat_t: torch.Tensor,
    alpha: float = 0.8,
) -> torch.Tensor:
    """KL soft-label distillation: target-text↔image logits pulled toward a
    detached blend of normalized source-text↔image and source-text↔slot
    scores.  The blend mixes logits_sv[text, image] with
    logits_sc[image, text], as the reference does (the matrices are
    square)."""
    logits_tv = text_feat_t @ image_feat.T
    logits_sv = text_feat_s @ image_feat.T
    logits_sc = torch.einsum("bne,ce->bnc", slots, text_feat_s).amax(dim=1)
    labels = (alpha * _norm_score(logits_sv)
              + (1.0 - alpha) * _norm_score(logits_sc))
    labels = torch.softmax(labels.float(), dim=1).detach()
    logp = _log_softmax(logits_tv, 1)
    # F.kl_div(logp, labels, reduction="batchmean"); xlogy is 0 at labels 0
    kl = (torch.special.xlogy(labels, labels) - labels * logp).sum()
    return kl / logits_tv.shape[0]


def caption_vision_loss(
    cv_caption_mean: torch.Tensor,
    cv_vision_mean: torch.Tensor,
    idx: torch.Tensor,
    num_blocks: int = 1,
) -> torch.Tensor:
    """Token-level caption↔vision matching on the per-sample token means
    (the mean over token pairs of dot products is the dot of the means),
    soft labels from duplicate idx, softmax without temperature."""
    b, d = cv_caption_mean.shape
    if b % num_blocks:
        raise ValueError(f"batch {b} does not split into {num_blocks} blocks")
    bl = b // num_blocks
    cap = cv_caption_mean.reshape(num_blocks, bl, d)
    vis = cv_vision_mean.reshape(num_blocks, bl, d)
    idx_b = idx.reshape(num_blocks, bl)
    sim = torch.einsum("wcd,wvd->wcv", cap, vis)
    pos = (idx_b[:, :, None] == idx_b[:, None, :]).float()
    labels = pos / pos.sum(dim=2, keepdim=True)
    return -(_log_softmax(sim, 2) * labels).sum(dim=2).mean()


def _row_blocks(b: int, block_rows: int) -> int:
    block_rows = min(block_rows, b)
    if b % block_rows:
        raise ValueError(f"batch {b} does not split into blocks of "
                         f"{block_rows} rows")
    return block_rows


def _dstl_scores(image_feat, slots_b, text_feat_s, ts_b):
    """The dstl label scores of one row block: sv [rb, B] (rows = source
    texts) and sc [rb, B] (rows = images, the reference's mixed
    orientation, see `dstl_loss`)."""
    sv = ts_b @ image_feat.T
    sc = torch.einsum("bne,ce->bnc", slots_b, text_feat_s).amax(dim=1)
    return sv, sc


def _dstl_block(tt_b, ts_b, slots_b, image_feat, text_feat_s, bounds,
                alpha):
    sv_lo, sv_hi, sc_lo, sc_hi = bounds
    with torch.no_grad():  # the labels are detached
        sv, sc = _dstl_scores(image_feat, slots_b, text_feat_s, ts_b)
        # norm_score: (x − min) / max after the shift = (x − lo) / (hi − lo)
        sv_n = (sv - sv_lo) / torch.clamp_min(sv_hi - sv_lo, 1e-12)
        sc_n = (sc - sc_lo) / torch.clamp_min(sc_hi - sc_lo, 1e-12)
        labels = torch.softmax(
            (alpha * sv_n + (1.0 - alpha) * sc_n).float(), dim=1)
    logp = _log_softmax(tt_b @ image_feat.T, 1)
    return (torch.special.xlogy(labels, labels) - labels * logp).sum()


def dstl_loss_blockwise(
    image_feat: torch.Tensor,
    slots: torch.Tensor,
    text_feat_s: torch.Tensor,
    text_feat_t: torch.Tensor,
    alpha: float = 0.8,
    block_rows: int = 256,
) -> torch.Tensor:
    """`dstl_loss` in row blocks of `block_rows`: a [block, B] working set
    instead of three [B, B] matrices.  Pass 1 takes the global min and max
    of the raw sv and sc scores (the reference's norm_score is a global
    min-max) without a graph; pass 2 sums the per-block KL, each block
    under a checkpoint, so that the backward recomputes one block at a
    time.  The blocks draw no random numbers."""
    b = image_feat.shape[0]
    rb = _row_blocks(b, block_rows)
    blocks = [slice(r, r + rb) for r in range(0, b, rb)]
    with torch.no_grad():
        lo_hi = []
        for rows in blocks:
            sv, sc = _dstl_scores(image_feat, slots[rows], text_feat_s,
                                  text_feat_s[rows])
            lo_hi.append(torch.stack([sv.min(), sv.max(), sc.min(),
                                      sc.max()]))
        lo_hi = torch.stack(lo_hi)
        bounds = (lo_hi[:, 0].min(), lo_hi[:, 1].max(), lo_hi[:, 2].min(),
                  lo_hi[:, 3].max())
    total = sum(checkpoint(_dstl_block, text_feat_t[rows], text_feat_s[rows],
                           slots[rows], image_feat, text_feat_s, bounds,
                           alpha, use_reentrant=False,
                           preserve_rng_state=False)
                for rows in blocks)
    return total / b


def _cv_block(cap_b, idx_b, cv_vision_mean, idx):
    pos = (idx_b[:, None] == idx[None, :]).float()
    labels = pos / pos.sum(dim=1, keepdim=True)
    return -(_log_softmax(cap_b @ cv_vision_mean.T, 1) * labels).sum()


def caption_vision_loss_blockwise(
    cv_caption_mean: torch.Tensor,
    cv_vision_mean: torch.Tensor,
    idx: torch.Tensor,
    block_rows: int = 256,
) -> torch.Tensor:
    """`caption_vision_loss` (the global variant, num_blocks = 1) in row
    blocks of the [B, B] token-mean similarity matrix, each block under a
    checkpoint."""
    b = cv_caption_mean.shape[0]
    rb = _row_blocks(b, block_rows)
    total = sum(checkpoint(_cv_block, cv_caption_mean[r:r + rb],
                           idx[r:r + rb], cv_vision_mean, idx,
                           use_reentrant=False, preserve_rng_state=False)
                for r in range(0, b, rb))
    return total / b


def caption_regularization(ori_slots: torch.Tensor) -> torch.Tensor:
    """Slot-diversity penalty: the mean of (cosine-sim matrix − I) over all
    [B, n, n] entries."""
    x = ori_slots.float()
    slots = x / torch.linalg.vector_norm(x, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bnd,bmd->bnm", slots, slots)
    n = ori_slots.shape[1]
    return (sim - torch.eye(n, device=sim.device)[None]).mean()


def compute_losses(
    emb: TrainEmbeddings,
    idx: torch.Tensor,
    *,
    weight_caption_loss: float,
    weight_reg_loss: float,
    weight_dstl_loss: float,
    weight_cv_loss: float,
    dstl_alpha: float = 0.8,
    num_blocks: int = 1,
    cv_loss_local: bool = False,
    itc_loss_fn: Optional[Callable[..., torch.Tensor]] = None,
    stream_block_rows: int = 0,
) -> Dict[str, torch.Tensor]:
    """The 5-term objective as the reference composes it, plus the raw
    losses: the 10 keys of `LOSS_KEYS`.  A weight of 0 skips its loss.
    cv_loss_local selects the video semantics (local caption-vision
    loss).  itc_loss_fn replaces the InfoNCE of the three ITC losses
    (signature (feat_a, feat_b, temp, idx), e.g. `ops.infonce.infonce_loss`);
    stream_block_rows > 0 streams dstl and the global caption-vision loss
    in row blocks of that many rows."""
    temp = emb.temp
    zero = torch.zeros((), device=temp.device)
    itc = itc_loss_fn or soft_label_contrastive_loss
    loss_itc_vs = itc(emb.image_feat, emb.text_feat_s, temp, idx)
    loss_itc_vt = itc(emb.image_feat, emb.text_feat_t, temp, idx)
    loss_itc_st = itc(emb.text_feat_s, emb.text_feat_t, temp, idx)
    loss_itc_c = (
        caption_contrastive_loss(emb.slots, emb.text_feat_s, temp, num_blocks)
        + caption_contrastive_loss(emb.slots, emb.text_feat_t, temp,
                                   num_blocks))
    loss_dstl = zero
    if weight_dstl_loss != 0.0:
        dstl_args = (emb.image_feat, emb.slots, emb.text_feat_s,
                     emb.text_feat_t, dstl_alpha)
        loss_dstl = (dstl_loss_blockwise(*dstl_args, stream_block_rows)
                     if stream_block_rows > 0
                     else dstl_loss(*dstl_args)) * weight_dstl_loss
    loss_cv = zero
    if weight_cv_loss != 0.0:
        if stream_block_rows > 0 and not cv_loss_local:
            loss_cv = caption_vision_loss_blockwise(
                emb.cv_caption_mean, emb.cv_vision_mean, idx,
                stream_block_rows)
        else:
            loss_cv = caption_vision_loss(
                emb.cv_caption_mean, emb.cv_vision_mean, idx,
                num_blocks if cv_loss_local else 1)
        loss_cv = loss_cv * weight_cv_loss
    loss_reg = caption_regularization(emb.ori_slots)

    term_vs = loss_itc_vs + loss_cv
    term_vt = loss_itc_vt * (1.0 - weight_dstl_loss) + loss_dstl
    term_st = loss_itc_st
    term_c = loss_itc_c * weight_caption_loss
    term_reg = loss_reg * weight_reg_loss
    return {
        "loss_itc_vs": term_vs,
        "loss_itc_vt": term_vt,
        "loss_itc_st": term_st,
        "loss_itc_c": term_c,
        "loss_reg_c": term_reg,
        "raw_itc_vs": loss_itc_vs,
        "raw_itc_vt": loss_itc_vt,
        "raw_dstl": loss_dstl,
        "raw_cv": loss_cv,
        "total": term_vs + term_vt + term_st + term_c + term_reg,
    }
