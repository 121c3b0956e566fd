"""The large-batch training slice on CPU: `negatives: fused` (the fused
InfoNCE), GradCache (`train.grad_cache_microbatches`) and the streaming
dstl and caption-vision losses (`parallel.stream_loss_block_rows`) in one
train step at `tiny_test_config`, B = 8, 2 microbatches, blocks of 4 rows.

(a) Every dropout at 0: the port's `make_train_step` against the JAX
    trainer's `_grad_cache_grads` with its `infonce_loss` and the streaming
    `compute_losses`, then `tx.update`, with `test_torch_train`'s
    tolerances (losses atol 1e-5, gradients atol 1e-4, updated params 1e-6,
    2·lr where the gradient is f32 noise).
(b) Dropout 0.1, remat off and on: the GradCache gradient equals the
    gradient of the same objective taken monolithically, every microbatch
    forwarded with grad under its own generators (`microbatch_generators`):
    the second forward of each microbatch draws what the first drew.  Both
    forwards run every flash attention forward (the plain versions here,
    kernel 2 on a card).
(c) `ring` and `ring_fused` on one device stream their losses once the
    streaming rows divide a larger batch (the ring's default is 256 rows):
    the same losses and gradients as the dense `gather` step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.data.images import preprocess_train_images as port_preprocess
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.leccr import TrainEmbeddings as TorchEmb
from leccr_torch.models.losses import compute_losses as port_losses
from leccr_torch.models.weights import load_jax_params, params_from_jax
from leccr_torch.ops import flash_attention as port_fa
from leccr_torch.ops.infonce import infonce_loss
from leccr_torch.train.step import (
    grad_total,
    make_train_step,
    microbatch_generators,
)
from leccr_tpu.config import tiny_test_config
from leccr_tpu.data.images import preprocess_train_images
from leccr_tpu.models.leccr import LECCRModel
from leccr_tpu.models.losses import compute_losses
from leccr_tpu.ops.infonce import infonce_loss as jax_infonce_loss
from leccr_tpu.train.optim import build_optimizer
from leccr_tpu.train.schedule import linear_warmup_decay
from leccr_tpu.train.trainer import _grad_cache_grads

LR = 1e-3
B, L, M_MICRO, ROWS = 8, 16, 2, 4
LARGE = {"parallel.negatives": "fused",
         "train.grad_cache_microbatches": M_MICRO,
         "parallel.stream_loss_block_rows": ROWS,
         "train.optimizer.lr": LR, "train.schedular.num_warmup_steps": 0}
NO_DROPOUT = {"model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
              "model.text.attention_dropout": 0.0}
DROPOUT = {"model.dropout": 0.1, "model.text.hidden_dropout": 0.1,
           "model.text.attention_dropout": 0.1,
           "model.vision.fused_attention": True,
           "model.text.fused_attention": True}


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    res = cfg.model.vision.image_res
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    mask[6, 4:] = 0
    batch = {"vision": rs.randint(0, 256, (B, res, res, 3)).astype(np.uint8),
             "flip": rs.rand(B) < 0.5,
             # duplicates inside a microbatch and across the two
             "idx": np.array([0, 1, 2, 0, 3, 1, 4, 3], np.int32)}
    for key in ("text_ids_s", "text_ids_t", "caption_ids"):
        batch[key] = (rs.randint(5, 512, (B, L)) * mask).astype(np.int32)
    for key in ("text_mask_s", "text_mask_t", "caption_mask"):
        batch[key] = mask
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("text_ids_s", "text_ids_t", "caption_ids"):
        out[k] = out[k].long()
    return out


def _loss_kwargs(mc):
    return dict(weight_caption_loss=mc.weight_caption_loss,
                weight_reg_loss=mc.weight_reg_loss,
                weight_dstl_loss=mc.weight_dstl_loss,
                weight_cv_loss=mc.weight_cv_loss, dstl_alpha=mc.dstl_alpha,
                stream_block_rows=ROWS)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX trainer's GradCache step on one device with fused negatives
    and streaming losses: params, losses, gradients, updated params."""
    cfg = tiny_test_config(**LARGE, **NO_DROPOUT)
    mc = cfg.model
    batch = _batch(cfg)
    model = LECCRModel(mc)
    model_batch = {k: jnp.asarray(v) for k, v in batch.items()
                   if k not in ("idx", "flip")}
    init_batch = dict(model_batch, vision=model_batch["vision"].astype(
        jnp.float32))
    rs = np.random.RandomState(1)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        init_batch)["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    params["temp"] = np.float32(mc.temp)
    tx = build_optimizer(cfg.train.optimizer, params,
                         linear_warmup_decay(LR, 100, 0),
                         frozen_paths=("clip_text_tower",))
    idx = jnp.asarray(batch["idx"])

    def forward(p, mb, mb_flip, k):
        mb = dict(mb)
        mb["vision"] = preprocess_train_images(mb["vision"], mb_flip)
        return model.apply({"params": p}, mb, deterministic=False,
                           rngs={"dropout": jax.random.fold_in(
                               jax.random.PRNGKey(2), k)})

    def loss_from_emb(emb):
        losses = compute_losses(emb, idx, itc_loss_fn=jax_infonce_loss,
                                **_loss_kwargs(mc))
        gathered = (losses["raw_itc_vs"]
                    + losses["raw_itc_vt"] * (1 - mc.weight_dstl_loss)
                    + losses["loss_itc_st"] + losses["raw_dstl"]
                    + losses["raw_cv"])
        return gathered + losses["loss_itc_c"] + losses["loss_reg_c"], losses

    @jax.jit
    def step(p):
        losses, grads = _grad_cache_grads(forward, loss_from_emb, p,
                                          model_batch,
                                          jnp.asarray(batch["flip"]),
                                          M_MICRO)
        updates, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, optax.apply_updates(p, updates)

    losses, grads, new_params = jax.tree.map(np.asarray, step(params))
    return batch, params, losses, grads, new_params


def test_large_batch_step_matches_jax(jax_step):
    batch, params, want_losses, want_grads, want_params = jax_step
    cfg = torch_tiny_config(**LARGE, **NO_DROPOUT)
    model = TorchLECCR(cfg.model, device="cpu")
    load_jax_params(model, params)
    step = make_train_step(cfg, model, total_steps=100)
    losses = step(_torch_batch(batch), 0)
    assert set(losses) == set(want_losses)
    for key, value in losses.items():
        assert abs(value - float(want_losses[key])) <= 1e-5, key
    grads = params_from_jax(want_grads, cfg.model)
    after = params_from_jax(want_params, cfg.model)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[name], rtol=0, atol=1e-4,
                                   msg=name)
        signal = grads[name].abs() > 1e-4
        diff = (p.detach() - after[name]).abs()
        assert diff.where(signal, 0).max().item() <= 1e-6, name
        assert diff.where(~signal, 0).max().item() <= 2 * LR, name


@pytest.fixture
def flash_forwards(monkeypatch):
    """A list that grows by one at each call of the single-block flash
    forward's plain version (the CPU side of kernel 2)."""
    calls = []
    plain = port_fa.flash_tower_attention_fwd_reference

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(port_fa, "flash_tower_attention_fwd_reference",
                        counted)
    return calls


def _monolithic(cfg, batch, step_no):
    """The GradCache objective differentiated in one backward: each
    microbatch forwarded with grad under its own generators, the
    embeddings concatenated, the losses on the whole batch."""
    mc = cfg.model
    model = TorchLECCR(mc, device="cpu", seed=4)
    model.train()
    b = batch["idx"].shape[0]
    embs = []
    for k in range(M_MICRO):
        rows = slice(k * b // M_MICRO, (k + 1) * b // M_MICRO)
        mb = {key: v[rows] for key, v in batch.items()
              if key not in ("idx", "flip")}
        mb["vision"] = port_preprocess(mb["vision"], batch["flip"][rows])
        embs.append(model(mb, microbatch_generators(
            cfg.train.seed + 17, step_no, k, "cpu")))
    emb = TorchEmb(**{
        f.name: (embs[0].temp if f.name == "temp"
                 else torch.cat([getattr(e, f.name) for e in embs]))
        for f in dataclasses.fields(TorchEmb)})
    losses = port_losses(emb, batch["idx"], itc_loss_fn=infonce_loss,
                         **_loss_kwargs(mc))
    grad_total(losses, mc).backward()
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None})


def _grad_cache(cfg, batch, step_no):
    model = TorchLECCR(cfg.model, device="cpu", seed=4)
    losses = make_train_step(cfg, model, total_steps=100)(batch, step_no)
    return losses, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", [False, True])
def test_grad_cache_replays_dropout(remat, flash_forwards):
    """Dropout 0.1 everywhere (LeanDropout bits from the device generator,
    flash masks from host-drawn seeds): GradCache's gradient equals the
    monolithic one under the same per-microbatch generators, so its second
    forward of each microbatch drew what the first drew."""
    cfg = torch_tiny_config(**LARGE, **DROPOUT, **{"model.remat": remat})
    batch = _torch_batch(_batch(cfg))
    want_losses, want_grads = _monolithic(cfg, batch, 3)
    n_mono = len(flash_forwards)
    losses, grads = _grad_cache(cfg, batch, 3)
    # per microbatch forward 2 vision + 2 text + 2 caption layers; pass 1
    # and pass 3 each forward every microbatch, and with remat pass 3 also
    # recomputes the 4 tower blocks that take a gradient
    per_pass = 6 * M_MICRO
    assert n_mono == per_pass + (4 * M_MICRO if remat else 0)
    assert len(flash_forwards) - n_mono == 2 * per_pass + (
        4 * M_MICRO if remat else 0)
    for key, value in want_losses.items():
        assert abs(losses[key] - value) <= 1e-6, key
    for name, g in grads.items():
        want = want_grads.get(name, torch.zeros_like(g))
        torch.testing.assert_close(g, want, rtol=0, atol=1e-6, msg=name)
    other, _ = _grad_cache(cfg, batch, 4)
    assert other["total"] != losses["total"]  # dropout did act


@pytest.mark.parametrize("negatives", ["ring", "ring_fused"])
def test_ring_negatives_stream_on_one_device(negatives):
    """With 4 streaming rows at B = 8 the one-device ring step takes the
    streaming dstl and caption-vision losses (it raised before they were
    ported) and matches the dense gather step: losses atol 1e-6, gradients
    atol 1e-6."""
    stream = {"parallel.stream_loss_block_rows": ROWS,
              "parallel.negatives": negatives}
    cfg = torch_tiny_config(**NO_DROPOUT)
    batch = _torch_batch(_batch(cfg))
    losses, grads = _grad_cache(torch_tiny_config(**NO_DROPOUT, **stream),
                                batch, 1)
    want_losses, want_grads = _grad_cache(cfg, batch, 1)
    for key, value in want_losses.items():
        assert abs(losses[key] - value) <= 1e-6, key
    for name, g in grads.items():
        torch.testing.assert_close(g, want_grads[name], rtol=0, atol=1e-6,
                                   msg=name)
