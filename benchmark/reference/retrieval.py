"""Recall@K from embeddings, in plain PyTorch: the reference of the eval's
ranking and metrics.

Every score is the same fixed-order sum over E of a[i] · b[j], taken in
column chunks of one shape (blocks of 256 image rows, chunks of about 2²⁵
products), so two runs over the same embeddings on one device give the
same bits, and the ranks, which count the scores above a ground truth's
with ties going to the larger index (`np.argsort(kind="stable")[::-1]`),
come out exactly equal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BLOCK = 256
CHUNK_ELEMS = 1 << 25


def scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, e = a.shape
    n = b.shape[0]
    step = max(1, min(n, CHUNK_ELEMS // max(1, m * e)))
    b = torch.nn.functional.pad(b, (0, 0, 0, (-n) % step))
    return torch.cat([(a[:, None, :] * b[None, j:j + step]).sum(-1)
                      for j in range(0, b.shape[0], step)], dim=1)[:, :n]


@torch.no_grad()
def ranks(img: torch.Tensor, txt: torch.Tensor, txt2img: np.ndarray,
          img2txt: np.ndarray):
    """(i2t ranks [N_img], t2i ranks [N_txt]), 0-based, int numpy.
    img2txt: [N_img, n_gt] text ids padded with -1."""
    dev = img.device
    n_img, n_txt = img.shape[0], txt.shape[0]
    block = min(BLOCK, n_img)
    pad = (-n_img) % block
    img = torch.nn.functional.pad(img.float(), (0, 0, 0, pad))
    txt = txt.float()
    t2i = torch.as_tensor(txt2img, dtype=torch.long, device=dev)
    gt = torch.as_tensor(img2txt, dtype=torch.long, device=dev)
    gt = torch.nn.functional.pad(gt, (0, 0, 0, pad), value=-1)
    valid, gidx = gt >= 0, gt.clamp_min(0)
    gt_t2i = torch.zeros(n_txt, device=dev)
    gt_i2t = torch.zeros(gt.shape, device=dev)
    for r0 in range(0, img.shape[0], block):
        n = min(block, n_img - r0)
        s = scores(img[r0:r0 + block], txt)
        cols = torch.nonzero((t2i >= r0) & (t2i < r0 + n)).squeeze(1)
        gt_t2i[cols] = s[t2i[cols] - r0, cols]
        gt_i2t[r0:r0 + block] = torch.gather(s, 1, gidx[r0:r0 + block])
    masked = torch.where(valid, gt_i2t, -torch.inf)
    best = masked.amax(dim=1)
    best_idx = torch.where(valid & (masked == best[:, None]), gidx,
                           -1).amax(dim=1)
    txt_ids = torch.arange(n_txt, device=dev)
    r_t2i = torch.zeros(n_txt, dtype=torch.long, device=dev)
    r_i2t = torch.zeros(img.shape[0], dtype=torch.long, device=dev)
    for r0 in range(0, img.shape[0], block):
        n = min(block, n_img - r0)
        s = scores(img[r0:r0 + block], txt)[:n]
        rows = r0 + torch.arange(n, device=dev)
        r_t2i += ((s > gt_t2i) | ((s == gt_t2i) & (rows[:, None] > t2i))
                  ).sum(0)
        g, gi = best[r0:r0 + n, None], best_idx[r0:r0 + n, None]
        r_i2t[r0:r0 + n] = ((s > g) | ((s == g) & (txt_ids > gi))).sum(1)
    return r_i2t[:n_img].cpu().numpy(), r_t2i.cpu().numpy()


def metrics(i2t: np.ndarray, t2i: np.ndarray) -> Dict[str, float]:
    """The 13 keys of the reference's itm_eval."""
    def recalls(r):
        return tuple(100.0 * np.mean(np.asarray(r) < k) for k in (1, 5, 10))

    tr1, tr5, tr10 = recalls(i2t)
    ir1, ir5, ir10 = recalls(t2i)
    tr_mean, ir_mean = (tr1 + tr5 + tr10) / 3, (ir1 + ir5 + ir10) / 3
    txt_sum, img_sum = tr1 + tr5 + tr10, ir1 + ir5 + ir10
    return {"txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10,
            "txt_r_mean": tr_mean, "txt_sum_r": txt_sum,
            "img_r1": ir1, "img_r5": ir5, "img_r10": ir10,
            "img_r_mean": ir_mean, "r_mean": (tr_mean + ir_mean) / 2,
            "img_sumr": img_sum,
            "sumr_avg": float(np.round((txt_sum + img_sum) / 6, 2)),
            "sumr_sum": txt_sum + img_sum}
