"""One training step on one device: the port of the train step of
`leccr_tpu/train/trainer.py` (`_make_train_step`, without GradCache, EMA or
a mesh).

    step = make_train_step(cfg, model, total_steps)
    losses = step(batch, step_no)   # dict of the 10 loss keys, as floats

Each step builds its random streams from (cfg.train.seed + 17, step_no),
preprocesses the uint8 images on the device (normalize, per-image flip),
runs the model forward in training mode, computes the loss suite, takes
the gradient of the `grad_total` objective (the DDP-parity weighting of the
JAX trainer; with num_blocks = 1 it equals `total`), clips by global norm
when `train.grad_clip` > 0, and takes one optimizer and one scheduler step.
The losses are read back from the device once, as one tensor.

`parallel.negatives`: on one device (num_blocks = 1) `ring` and
`ring_fused` are the dense losses, as in the JAX trainer, whose ring
applies only across blocks (trainer.py:342-359); `ring` sets the streaming
rows to 256 when the config leaves them at 0.  `fused` (the fused InfoNCE
kernels) raises until that slice is ported.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from leccr_torch.config import LECCRConfig, ModelConfig
from leccr_torch.data.images import preprocess_train_images
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.losses import LOSS_KEYS, compute_losses
from leccr_torch.ops.dropout import Generators
from leccr_torch.train.optim import build_optimizer, clip_by_global_norm
from leccr_torch.train.schedule import linear_warmup_decay


def step_generators(seed: int, step_no: int, device) -> Generators:
    """The random streams of step `step_no` of a run seeded with `seed`."""
    return Generators.from_seed((seed << 32) + step_no, device)


def grad_total(losses: Dict[str, torch.Tensor], mc: ModelConfig,
               num_blocks: int = 1) -> torch.Tensor:
    """The objective the JAX trainer differentiates: the gathered
    (global-negative) terms scaled by 1/num_blocks plus the per-block local
    terms (caption contrastive and regularization), so that a DDP mean of
    per-rank gradients equals the reference's."""
    gathered = (losses["raw_itc_vs"]
                + losses["raw_itc_vt"] * (1 - mc.weight_dstl_loss)
                + losses["loss_itc_st"] + losses["raw_dstl"]
                + losses["raw_cv"])
    local = losses["loss_itc_c"] + losses["loss_reg_c"]
    return gathered / num_blocks + local


def make_train_step(cfg: LECCRConfig, model: LECCRModel, total_steps: int,
                    num_blocks: int = 1
                    ) -> Callable[[Dict[str, torch.Tensor], int],
                                  Dict[str, float]]:
    """A train step over `model` (put in training mode here), with the
    optimizer and scheduler of `cfg.train` for a run of `total_steps`
    optimizer steps; they are the returned function's `optimizer` and
    `scheduler` attributes.

    batch: "vision" uint8 [B,H,W,3], "flip" bool [B] (optional), "idx" [B],
    "text_ids_s"/"text_mask_s", "text_ids_t"/"text_mask_t", "caption_ids"/
    "caption_mask", all on the model's device."""
    tc, mc = cfg.train, cfg.model
    negatives = cfg.parallel.negatives
    stream_rows = cfg.parallel.stream_loss_block_rows
    if negatives == "fused":
        raise NotImplementedError(
            "negatives: fused (the fused InfoNCE kernels 9-11, "
            "leccr_tpu/ops/infonce.py) comes with a later slice of the port")
    if negatives not in ("gather", "ring", "ring_fused"):
        raise ValueError(f"unknown negatives: {negatives!r}")
    if negatives != "gather" and num_blocks > 1:
        raise NotImplementedError(
            f"negatives: {negatives} over {num_blocks} blocks (the ring "
            "InfoNCE) comes with the multi-device slice of the port")
    if negatives == "ring" and stream_rows == 0:
        stream_rows = 256  # the JAX trainer's default (trainer.py:344-345)
    if tc.grad_cache_microbatches > 1 or tc.ema_decay > 0:
        raise NotImplementedError(
            "GradCache and the EMA come with the trainer slice of the port")
    schedule = linear_warmup_decay(tc.optimizer.lr, total_steps,
                                   tc.schedular.num_warmup_steps)
    optimizer, scheduler = build_optimizer(
        tc.optimizer, model, schedule,
        lr_mult_paths=tuple(tc.optimizer.lr_mult_paths),
        frozen_paths=("clip_text_tower",))
    params = list(model.parameters())
    randaugment_n = cfg.data.randaugment_n if cfg.data.randaugment else 0
    model.train()

    def step(batch: Dict[str, torch.Tensor], step_no: int
             ) -> Dict[str, float]:
        gens = step_generators(tc.seed + 17, step_no, model.device)
        batch = dict(batch)
        idx = batch.pop("idx")
        batch["vision"] = preprocess_train_images(
            batch["vision"], batch.pop("flip", None), randaugment_n)
        optimizer.zero_grad(set_to_none=True)
        emb = model(batch, gens)
        b = idx.shape[0]
        losses = compute_losses(
            emb, idx,
            weight_caption_loss=mc.weight_caption_loss,
            weight_reg_loss=mc.weight_reg_loss,
            weight_dstl_loss=mc.weight_dstl_loss,
            weight_cv_loss=mc.weight_cv_loss,
            dstl_alpha=mc.dstl_alpha,
            num_blocks=num_blocks,
            stream_block_rows=(stream_rows if 0 < stream_rows < b
                               and b % stream_rows == 0 else 0))
        grad_total(losses, mc, num_blocks).backward()
        for p in params:  # optax decays a param whose gradient is zero
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if tc.grad_clip > 0.0:
            clip_by_global_norm(params, tc.grad_clip)
        optimizer.step()
        scheduler.step()
        values = torch.stack([losses[k].detach().float() for k in LOSS_KEYS])
        return dict(zip(LOSS_KEYS, values.tolist()))

    step.optimizer = optimizer
    step.scheduler = scheduler
    return step
