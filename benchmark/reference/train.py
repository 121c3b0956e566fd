"""The reference training steps: the LECCR loss suite, its gradient and
AdamW, in plain float32 PyTorch (`benchmark.reference.model`).

`reference_steps` starts from the benchmark's initial weights, takes the
first steps of a run on the same batches with the same dropout bits as the
program, and returns what the comparison reads: each step's losses, each
parameter's first gradient and each parameter's change after the last
step.  `leaf_gap`, `change_gap` and `negligible` are the comparison's
measures.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference.model import (
    Arch,
    Model,
    Precision,
    Streams,
    step_stream_seed,
)

LOSS_KEYS = ("loss_itc_vs", "loss_itc_vt", "loss_itc_st", "loss_itc_c",
             "loss_reg_c", "raw_itc_vs", "raw_itc_vt", "raw_dstl", "raw_cv",
             "total")
_NORMS = re.compile(r"(^|\.)(ln_1|ln_2|ln_pre|ln_post|ln_final|embeddings_ln|"
                    r"out_ln|output_ln|norm)\.weight$")


def soft_label_nce(a, b, temp, idx):
    logits = (a @ b.T) / temp
    pos = (idx[:, None] == idx[None, :]).float()
    labels = pos / pos.sum(dim=1, keepdim=True)
    a2b = -(torch.log_softmax(logits, 1) * labels).sum(1).mean()
    b2a = -(torch.log_softmax(logits.T, 1) * labels).sum(1).mean()
    return (a2b + b2a) / 2


def caption_nce(slots, text, temp):
    logits = torch.einsum("bne,ce->bnc", slots, text).amax(dim=1) / temp
    diag = torch.arange(slots.shape[0], device=slots.device)
    i2t = -torch.log_softmax(logits, 1)[diag, diag].mean()
    t2i = -torch.log_softmax(logits.T, 1)[diag, diag].mean()
    return (i2t + t2i) / 2


def minmax(x):
    x = x - x.min()
    return x / x.max()


def dstl(image, slots, text_s, text_t, alpha):
    sv = text_s @ image.T
    sc = torch.einsum("bne,ce->bnc", slots, text_s).amax(dim=1)
    labels = torch.softmax(alpha * minmax(sv) + (1 - alpha) * minmax(sc),
                           dim=1).detach()
    logp = torch.log_softmax(text_t @ image.T, 1)
    return (torch.special.xlogy(labels, labels) - labels * logp).sum() \
        / text_t.shape[0]


def caption_vision(cap_mean, vis_mean, idx):
    pos = (idx[:, None] == idx[None, :]).float()
    labels = pos / pos.sum(dim=1, keepdim=True)
    return -(torch.log_softmax(cap_mean @ vis_mean.T, 1) * labels).sum(1).mean()


def regularization(ori_slots):
    s = ori_slots / torch.linalg.vector_norm(ori_slots, dim=-1, keepdim=True
                                             ).clamp_min(1e-12)
    sim = torch.einsum("bnd,bmd->bnm", s, s)
    return (sim - torch.eye(s.shape[1], device=s.device)[None]).mean()


def losses(emb: Dict[str, torch.Tensor], idx, arch: Arch):
    """The 10 losses of the suite; "total" is the objective."""
    w, t = arch.weights, emb["temp"]
    vs = soft_label_nce(emb["image_feat"], emb["text_feat_s"], t, idx)
    vt = soft_label_nce(emb["image_feat"], emb["text_feat_t"], t, idx)
    st = soft_label_nce(emb["text_feat_s"], emb["text_feat_t"], t, idx)
    c = (caption_nce(emb["slots"], emb["text_feat_s"], t)
         + caption_nce(emb["slots"], emb["text_feat_t"], t))
    d = dstl(emb["image_feat"], emb["slots"], emb["text_feat_s"],
             emb["text_feat_t"], arch.dstl_alpha) * w["weight_dstl_loss"]
    cv = caption_vision(emb["cv_caption_mean"], emb["cv_vision_mean"],
                        idx) * w["weight_cv_loss"]
    reg = regularization(emb["ori_slots"])
    terms = {"loss_itc_vs": vs + cv,
             "loss_itc_vt": vt * (1 - w["weight_dstl_loss"]) + d,
             "loss_itc_st": st,
             "loss_itc_c": c * w["weight_caption_loss"],
             "loss_reg_c": reg * w["weight_reg_loss"]}
    return {**terms, "raw_itc_vs": vs, "raw_itc_vt": vt, "raw_dstl": d,
            "raw_cv": cv, "total": sum(terms.values())}


def schedule(lr: float, total_steps: int, warmup) -> callable:
    """Linear warm-up then linear decay to 0; a float warm-up is a share of
    the steps."""
    warm = int(total_steps * warmup) if isinstance(warmup, float) \
        else int(warmup)

    def at(step: int) -> float:
        frac = (step / max(1.0, warm) if step < warm
                else (total_steps - step) / max(1.0, total_steps - warm))
        return lr * min(max(frac, 0.0), 1.0)
    return at


def decays(name: str) -> bool:
    """AdamW's weight decay skips biases and LayerNorm scales."""
    return not (name.endswith(".bias") or _NORMS.search(name))


def settings(config: dict, total_steps: int) -> dict:
    """The configuration's AdamW and schedule: "lr_at" (an optimizer
    step's learning rate), "betas", "eps", "weight_decay", "seed" (the
    train seed the step streams derive from)."""
    train = config.get("train", {})
    opt = train.get("optimizer", {})
    sched = train.get("schedular", {})
    return {"lr_at": schedule(float(opt.get("lr", 1e-5)), total_steps,
                              sched.get("num_warmup_steps", 0.1)),
            "betas": tuple(opt.get("betas", (0.9, 0.98))),
            "eps": float(opt.get("eps", 1e-8)),
            "weight_decay": float(opt.get("weight_decay", 0.01)),
            "seed": int(train.get("seed", 42))}


def leaf_decay(name: str, config: dict) -> float:
    """The weight decay AdamW gives the leaf `name`."""
    wd = float(config.get("train", {}).get("optimizer", {})
               .get("weight_decay", 0.01))
    return wd if decays(name) else 0.0


def reference_steps(P0: Dict[str, torch.Tensor], config: dict,
                    batches: Sequence[Dict[str, torch.Tensor]],
                    step_nos: Sequence[int], total_steps: int,
                    prec: Optional[Precision] = None) -> dict:
    """Take len(batches) AdamW steps from the weights P0 (left as they are).

    config: the configuration file's `config` section.  Returns {"losses":
    [[10] per step] (host), "grads": {name: first gradient}, "grad_norms":
    {name: ‖first gradient‖}, "change": {name: P_last − P0}}."""
    arch = Arch.of(config["model"])
    s = settings(config, total_steps)
    lr_at, (b1, b2), eps, seed = s["lr_at"], s["betas"], s["eps"], s["seed"]
    P = {n: p.detach().clone().requires_grad_(True) for n, p in P0.items()}
    m = {n: torch.zeros_like(p) for n, p in P.items()}
    v = {n: torch.zeros_like(p) for n, p in P.items()}
    model = Model(P, arch, prec)
    out: dict = {"losses": []}
    for k, (batch, step_no) in enumerate(zip(batches, step_nos)):
        for p in P.values():
            p.grad = None
        emb = model.train_forward(batch, Streams(
            step_stream_seed(seed, step_no), batch["vision"].device))
        loss = losses(emb, batch["idx"], arch)
        loss["total"].backward()
        out["losses"].append(torch.stack([loss[key].detach()
                                          for key in LOSS_KEYS]).cpu())
        del emb, loss
        lr = lr_at(k)
        with torch.no_grad():
            if k == 0:
                out["grads"] = {n: p.grad.clone() if p.grad is not None
                                else torch.zeros_like(p)
                                for n, p in P.items()}
                out["grad_norms"] = norms(out["grads"])
            for n, p in P.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                wd = leaf_decay(n, config)
                if wd:
                    p.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / (1 - b2 ** (k + 1)) ** 0.5).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** (k + 1)))
    with torch.no_grad():
        out["change"] = {n: P[n].detach() - P0[n] for n in P}
    return out


def reference_loss(P: Dict[str, torch.Tensor], config: dict,
                   batch: Dict[str, torch.Tensor], step_no: int,
                   prec: Optional[Precision] = None) -> torch.Tensor:
    """The 10 losses ([10], host) of one training step's forward from the
    weights P, with step `step_no`'s dropout bits."""
    arch = Arch.of(config["model"])
    seed = int(config.get("train", {}).get("seed", 42))
    with torch.no_grad():
        emb = Model(P, arch, prec).train_forward(batch, Streams(
            step_stream_seed(seed, step_no), batch["vision"].device))
        loss = losses(emb, batch["idx"], arch)
        return torch.stack([loss[key] for key in LOSS_KEYS]).cpu()


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                          for n in names]).cpu().tolist()
    return dict(zip(names, values))


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             exclude: Sequence[str] = ()) -> tuple:
    """(the worst leaf's gap, its name): |‖got‖ − ‖want‖| over the larger
    of the leaf's ‖want‖ and the median leaf's, over the leaves not
    excluded."""
    keep = [n for n in want if n not in set(exclude)]
    med = float(torch.tensor([want[n] for n in keep]).median())
    worst, name = 0.0, ""
    for n in keep:
        gap = abs(got[n] - want[n]) / max(want[n], med, 1e-30)
        if gap > worst:
            worst, name = gap, n
    return worst, name


def change_gap(got: Dict[str, torch.Tensor], ref: dict,
               exclude: Sequence[str]) -> tuple:
    """(the worst leaf's gap of ‖P_last − P0‖, its name), taken over the
    elements whose reference first gradient is at least a thousandth of
    the median leaf's RMS gradient: an element whose gradient is nought to
    rounding (a key's bias under softmax, a third of a packed q/k/v bias)
    moves under Adam by round-off alone, in the program and in the
    reference alike, but not by the same amount."""
    grads = ref["grads"]
    rms = [float(torch.linalg.vector_norm(g)) / max(1, g.numel()) ** 0.5
           for g in grads.values()]
    floor = 1e-3 * float(torch.tensor(rms).median())
    have, want = {}, {}
    for n in grads:
        if n in set(exclude):
            continue
        keep = grads[n].abs() >= floor
        want[n] = float(torch.linalg.vector_norm(ref["change"][n][keep]))
        have[n] = float(torch.linalg.vector_norm(
            got[n].to(keep.device)[keep]))
    return leaf_gap(have, want)


def negligible(grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is under a thousandth of the
    median leaf's: round-off moves them under Adam."""
    med = float(torch.tensor(list(grad_norms.values())).median())
    return [n for n, g in grad_norms.items() if g < 1e-3 * med]
