"""Retrieval evaluation: streaming two-pass ranker + Recall@K.

The port of `leccr_tpu/eval/retrieval.py`.  Ranks are computed on the
device in row blocks of the image×text score matrix, which is never
materialized whole:

    rank(row, gt) = #{j : s_j > s_gt} + #{j : s_j == s_gt and j > gt}

which reproduces `np.argsort(score, kind='stable')[::-1]`: equal scores
rank in descending index order.

Exactness: ground-truth scores are GATHERED in pass 1 from the same block
products that pass 2 compares against (same call, same shapes, so the same
bits), never recomputed from the embeddings — a separately computed dot
product can differ in the last ulp and demote an exact-tie self-match.
Every score is a sum over E in one fixed order (`pairwise_scores`), so
identical embedding rows give identical bits wherever they sit in a block
and whatever the thread count: a blocked matrix product sums edge rows in
another order, and the tie rule then sees no tie where JAX's product, which
gives equal rows equal bits, sees one.

Fusion (video double-sim and the image alpha blend) is affine in the raw
scores: pass 1 also collects the global min/max, and the same affine map is
applied to the blocks and to the gathered gt values alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from leccr_torch.device import resolve_device
from leccr_torch.utils.tracing import span

_FUSIONS = ("none", "raw", "minmax")


def score_matrix(img_embeds: torch.Tensor,
                 txt_embeds: torch.Tensor) -> torch.Tensor:
    """Dense [N_img, N_txt] cosine score matrix (embeddings are already
    L2-normalized)."""
    return img_embeds @ txt_embeds.T


def pairwise_scores(a: torch.Tensor, b: torch.Tensor,
                    chunk_elems: int = 1 << 25) -> torch.Tensor:
    """[M, N] = a @ b.T for a [M, E], b [N, E], each entry the same
    fixed-order reduction of a[i] * b[j] over E: equal rows of a (or of b)
    give bit-equal scores, wherever they sit and whatever the thread
    count.  Columns go in chunks of one width (b zero-padded), so every
    reduction has one shape; a chunk holds about `chunk_elems` products."""
    m, e = a.shape
    n = b.shape[0]
    step = max(1, min(n, chunk_elems // max(1, m * e)))
    b = torch.nn.functional.pad(b, (0, 0, 0, (-n) % step))
    return torch.cat([(a[:, None, :] * b[None, j:j + step]).sum(-1)
                      for j in range(0, b.shape[0], step)], dim=1)[:, :n]


def _gt_arrays(txt2img, img2txt, n_img: int):
    if isinstance(txt2img, dict):
        txt2img = [txt2img[t] for t in range(len(txt2img))]
    txt2img = np.asarray(txt2img, np.int64)
    if isinstance(img2txt, dict):
        n_gt = max(len(v) for v in img2txt.values())
        arr = np.full((n_img, n_gt), -1, np.int64)
        for i, txts in img2txt.items():
            arr[i, : len(txts)] = txts
        img2txt = arr
    return txt2img, np.asarray(img2txt, np.int64)


@torch.inference_mode()
def retrieval_ranks(
    img_embeds,
    txt_embeds,
    txt2img: Union[Dict[int, int], np.ndarray],
    img2txt: Union[Dict[int, List[int]], np.ndarray],
    slots=None,
    fusion: str = "none",
    alpha: float = 0.9,
    block: int = 256,
    device: Optional[Union[str, torch.device]] = None,
):
    """(i2t_ranks [N_img], t2i_ranks [N_txt]) as int32 numpy arrays.

    Embeddings may be tensors (the ranker runs on their device) or numpy
    arrays (it runs on `device`: the GPU unless given).  txt2img/img2txt
    take the reference's dict ground-truth maps or arrays (img2txt padded
    with -1).  fusion: "none" | "raw" (image alpha blend) | "minmax" (video
    double-sim, needs slots [N_img, n, E])."""
    if fusion not in _FUSIONS:
        raise ValueError(f"unknown fusion {fusion!r}")
    if fusion != "none" and slots is None:
        raise ValueError(f"fusion={fusion!r} needs slots")
    with span("eval.rank"):
        return _ranks(img_embeds, txt_embeds, txt2img, img2txt, slots,
                      fusion, alpha, block, device)


def _ranks(img_embeds, txt_embeds, txt2img, img2txt, slots, fusion: str,
           alpha: float, block: int, device):
    """`retrieval_ranks` past its argument checks."""
    if isinstance(img_embeds, torch.Tensor):
        device = img_embeds.device
    else:
        device = resolve_device(device)
    n_img = img_embeds.shape[0]
    txt2img, img2txt = _gt_arrays(txt2img, img2txt, n_img)
    block = min(block, n_img)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    pad = (-n_img) % block
    img = torch.nn.functional.pad(dev(img_embeds), (0, 0, 0, pad))
    txt = dev(txt_embeds)
    t2i = dev(txt2img, torch.long)
    i2t_gt = torch.nn.functional.pad(dev(img2txt, torch.long), (0, 0, 0, pad),
                                     value=-1)
    if fusion != "none":
        slots = torch.nn.functional.pad(dev(slots), (0, 0, 0, 0, 0, pad))
    n_pad, n_txt = img.shape[0], txt.shape[0]
    gt_valid = i2t_gt >= 0
    gt_idx = i2t_gt.clamp_min(0)
    txt_ids = torch.arange(n_txt, device=device)

    def raw_scores(r0):
        s = pairwise_scores(img[r0:r0 + block], txt)  # [blk, n_txt]
        if fusion == "none":
            return s, None
        sl = slots[r0:r0 + block]
        c = pairwise_scores(sl.reshape(-1, sl.shape[-1]), txt).view(
            sl.shape[0], sl.shape[1], n_txt).amax(dim=1)
        return s, c

    # ---- pass 1: min/max (minmax fusion) + exact gt gathers ------------
    inf = torch.tensor(float("inf"), device=device)
    s_lo, s_hi, c_lo, c_hi = inf, -inf, inf, -inf
    gts_t2i = torch.zeros(n_txt, device=device)
    gtc_t2i = torch.zeros(n_txt, device=device)
    gts_i2t = torch.zeros(i2t_gt.shape, device=device)
    gtc_i2t = torch.zeros(i2t_gt.shape, device=device)
    for r0 in range(0, n_pad, block):
        n_valid = min(block, n_img - r0)  # real rows lead each block
        s, c = raw_scores(r0)
        s_lo = torch.minimum(s_lo, s[:n_valid].min())
        s_hi = torch.maximum(s_hi, s[:n_valid].max())
        # t2i gt: entry (txt2img[t], t) when that image row is in the block
        cols = torch.nonzero((t2i >= r0) & (t2i < r0 + n_valid)).squeeze(1)
        gts_t2i[cols] = s[t2i[cols] - r0, cols]
        gidx = gt_idx[r0:r0 + block]
        gts_i2t[r0:r0 + block] = torch.gather(s, 1, gidx)
        if fusion != "none":
            c_lo = torch.minimum(c_lo, c[:n_valid].min())
            c_hi = torch.maximum(c_hi, c[:n_valid].max())
            gtc_t2i[cols] = c[t2i[cols] - r0, cols]
            gtc_i2t[r0:r0 + block] = torch.gather(c, 1, gidx)

    if fusion == "minmax":
        sa = 1.0 / torch.clamp_min(s_hi - s_lo, 1e-12)
        ca = 1.0 / torch.clamp_min(c_hi - c_lo, 1e-12)
        a0, a1 = alpha * sa, alpha * (-s_hi * sa)
        b0, b1 = (1.0 - alpha) * ca, (1.0 - alpha) * (-c_hi * ca)
    else:
        a0, a1, b0, b1 = alpha, 0.0, 1.0 - alpha, 0.0

    def fuse(s, c):
        if fusion == "none":
            return s
        return s * a0 + a1 + c * b0 + b1

    gt_t2i = fuse(gts_t2i, gtc_t2i)  # [n_txt]
    gt_i2t = fuse(gts_i2t, gtc_i2t)  # [n_pad, n_gt]

    # i2t rank = min over a row's gt texts of their ranks; the minimum is
    # the best-scoring gt, ties broken by the LARGEST text index (its tie
    # term is smallest), so pass 2 compares each row with ONE (score,
    # index) pair
    gt_masked = torch.where(gt_valid, gt_i2t, -inf)
    g_best = gt_masked.amax(dim=1)
    best = gt_valid & (gt_masked == g_best[:, None])
    gidx_best = torch.where(best, gt_idx, -1).amax(dim=1)

    # ---- pass 2: streaming rank counts ---------------------------------
    t2i_ranks = torch.zeros(n_txt, dtype=torch.long, device=device)
    i2t_ranks = torch.zeros(n_pad, dtype=torch.long, device=device)
    for r0 in range(0, n_pad, block):
        n_valid = min(block, n_img - r0)
        s = fuse(*raw_scores(r0))[:n_valid]
        rows = r0 + torch.arange(n_valid, device=device)
        ahead = (s > gt_t2i) | ((s == gt_t2i) & (rows[:, None] > t2i))
        t2i_ranks += ahead.sum(dim=0)
        g = g_best[r0:r0 + n_valid, None]
        gi = gidx_best[r0:r0 + n_valid, None]
        ahead = (s > g) | ((s == g) & (txt_ids > gi))
        i2t_ranks[r0:r0 + n_valid] = ahead.sum(dim=1)
    return (i2t_ranks[:n_img].int().cpu().numpy(),
            t2i_ranks.int().cpu().numpy())


def itm_metrics_from_ranks(
    i2t_ranks: np.ndarray, t2i_ranks: np.ndarray
) -> Dict[str, float]:
    """R@1/5/10 + means + sumR from 0-based rank vectors (the reference's
    itm_eval)."""
    def recalls(ranks):
        ranks = np.asarray(ranks)
        return tuple(100.0 * np.mean(ranks < k) for k in (1, 5, 10))

    tr1, tr5, tr10 = recalls(i2t_ranks)
    ir1, ir5, ir10 = recalls(t2i_ranks)
    tr_mean = (tr1 + tr5 + tr10) / 3
    ir_mean = (ir1 + ir5 + ir10) / 3
    txt_sumr = tr1 + tr5 + tr10
    img_sumr = ir1 + ir5 + ir10
    return {
        "txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10,
        "txt_r_mean": tr_mean, "txt_sum_r": txt_sumr,
        "img_r1": ir1, "img_r5": ir5, "img_r10": ir10,
        "img_r_mean": ir_mean,
        "r_mean": (tr_mean + ir_mean) / 2,
        "img_sumr": img_sumr,
        "sumr_avg": float(np.round((txt_sumr + img_sumr) / 6, 2)),
        "sumr_sum": txt_sumr + img_sumr,
    }
