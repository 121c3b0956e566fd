"""The long-sequence training slice on CPU: a tiny config with the structure
of `configs/scale_vitl_32k.yaml` (ViT-L/14 variant cut to width 128 = 2
heads, depth 2, image_res 56; an XLM-R text tower of 2 layers; flash in both
towers; `remat: true`; `negatives: ring_fused`) against the JAX package.

(a) one whole train step at dropouts 0, the port forced into the chunked
    flash regime (kernels 4/5's plain versions), against JAX's
    value_and_grad + optax with remat (the JAX towers take their plain
    attention off the TPU).  Tolerances as `test_torch_train`'s whole-step
    test: losses atol 1e-5, gradients atol 1e-4, updated params 1e-6 (2·lr
    where the gradient is f32 noise).
(b) dropout 0.1: remat on against remat off at the same step seed, losses
    and every gradient within 1e-6 — the recompute replays the forward's
    random draws — and the recompute reruns each remat'd block's flash
    forward.
(c) `params_from_jax` / `params_to_jax` on the remat'd JAX tree, scanned or
    not.
(d) `ring` and `ring_fused` negatives train on one device and equal
    `gather`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.weights import (
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from leccr_torch.ops import flash_attention as port_fa
from leccr_torch.train.step import make_train_step
from leccr_tpu.config import tiny_test_config
from leccr_tpu.data.images import preprocess_train_images
from leccr_tpu.models.leccr import LECCRModel
from leccr_tpu.models.losses import compute_losses
from leccr_tpu.train.optim import build_optimizer
from leccr_tpu.train.schedule import linear_warmup_decay
from test_torch_train import _batch, _torch_batch

LR = 1e-3
SLICE = {"model.vision.variant": "ViT-L/14", "model.vision.image_res": 56,
         "model.vision.width": 128, "model.vision.depth": 2,
         "model.vision.fused_attention": True,
         "model.text.kind": "xlmr", "model.text.pad_token_id": 1,
         "model.text.type_vocab_size": 1,
         "model.text.fused_attention": True, "model.remat": True,
         "parallel.negatives": "ring_fused",
         "train.optimizer.lr": LR, "train.schedular.num_warmup_steps": 0}
NO_DROPOUT = {"model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
              "model.text.attention_dropout": 0.0}
DROPOUT = {"model.dropout": 0.1, "model.text.hidden_dropout": 0.1,
           "model.text.attention_dropout": 0.1}


@pytest.fixture
def force_chunked(monkeypatch):
    monkeypatch.setattr(port_fa, "fits_vmem", lambda *a: False)


@pytest.fixture
def chunked_forwards(monkeypatch):
    """A list that grows by one at each call of the chunked forward's plain
    version (the CPU side of kernel 4)."""
    calls = []
    plain = port_fa.flash_chunked_attention_fwd_reference

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(port_fa, "flash_chunked_attention_fwd_reference",
                        counted)
    return calls


def _init_batch(batch):
    init = {k: jnp.asarray(v) for k, v in batch.items()
            if k not in ("idx", "flip")}
    init["vision"] = init["vision"].astype(jnp.float32)
    return init


def _jax_params(cfg, seed):
    batch = _batch(cfg)
    params = LECCRModel(cfg.model).init({"params": jax.random.PRNGKey(seed)},
                                        _init_batch(batch))["params"]
    return batch, jax.tree.map(np.asarray, params)


def jax_step_of(cfg):
    """JAX's one-device train step of `cfg` (the JAX package's config) with
    remat: the batch, params, losses, the gradients of grad_total and the
    params after tx.update."""
    mc = cfg.model
    batch, params = _jax_params(cfg, 0)
    model = LECCRModel(mc)
    rs = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    params["temp"] = np.float32(mc.temp)
    tx = build_optimizer(cfg.train.optimizer, params,
                         linear_warmup_decay(LR, 100, 0),
                         frozen_paths=("clip_text_tower",))

    def loss_fn(p):
        mb = _init_batch(batch)
        mb["vision"] = preprocess_train_images(jnp.asarray(batch["vision"]),
                                               jnp.asarray(batch["flip"]))
        emb = model.apply({"params": p}, mb, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(2)})
        losses = compute_losses(
            emb, jnp.asarray(batch["idx"]),
            weight_caption_loss=mc.weight_caption_loss,
            weight_reg_loss=mc.weight_reg_loss,
            weight_dstl_loss=mc.weight_dstl_loss,
            weight_cv_loss=mc.weight_cv_loss)
        gathered = (losses["raw_itc_vs"]
                    + losses["raw_itc_vt"] * (1 - mc.weight_dstl_loss)
                    + losses["loss_itc_st"] + losses["raw_dstl"]
                    + losses["raw_cv"])
        return gathered + losses["loss_itc_c"] + losses["loss_reg_c"], losses

    @jax.jit
    def step(p):
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, optax.apply_updates(p, updates)

    losses, grads, new_params = jax.tree.map(np.asarray, step(params))
    return batch, params, losses, grads, new_params


@pytest.fixture(scope="module")
def jax_step():
    return jax_step_of(tiny_test_config(**SLICE, **NO_DROPOUT))


def test_slice_train_step_matches_jax(jax_step, force_chunked,
                                      chunked_forwards):
    batch, params, want_losses, want_grads, want_params = jax_step
    cfg = torch_tiny_config(**SLICE, **NO_DROPOUT)
    model = TorchLECCR(cfg.model, device="cpu")
    assert model.text_encoder.remat and model.vision_tower.transformer.remat
    load_jax_params(model, params)
    step = make_train_step(cfg, model, total_steps=100)
    losses = step(_torch_batch(batch), 0)
    # 2 vision + 2 text blocks, each again in the recompute, + 2 caption
    assert len(chunked_forwards) == 10
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


def _cfg(**overrides):
    return torch_tiny_config(**{**SLICE, **overrides})


def _step_grads(cfg, batch, step_no=3):
    model = TorchLECCR(cfg.model, device="cpu", seed=4)
    losses = make_train_step(cfg, model, total_steps=100)(batch, step_no)
    return losses, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_replays_dropout(force_chunked, chunked_forwards):
    """Dropout 0.1 everywhere (LeanDropout bits from the device generator,
    in-kernel flash masks from host-drawn seeds): remat on and off give the
    same losses and gradients, so the recompute drew what the forward
    drew; remat on runs each block's flash forward twice."""
    batch = _torch_batch(_batch(torch_tiny_config(**SLICE)))
    runs = {}
    for remat in (True, False):
        cfg = _cfg(**DROPOUT, **{"model.remat": remat})
        before = len(chunked_forwards)
        runs[remat] = _step_grads(cfg, batch)
        assert len(chunked_forwards) - before == (10 if remat else 6)
    (losses_on, grads_on), (losses_off, grads_off) = runs[True], runs[False]
    for key in losses_on:
        assert abs(losses_on[key] - losses_off[key]) <= 1e-6, key
    for name, g in grads_on.items():
        torch.testing.assert_close(g, grads_off[name], rtol=0, atol=1e-6,
                                   msg=name)
    other, _ = _step_grads(cfg, batch, step_no=4)
    assert other["total"] != losses_off["total"]  # dropout did act


@pytest.mark.parametrize("scan_layers", [False, True])
def test_remat_params_round_trip(scan_layers):
    """nn.remat keeps flax's module names: the remat'd tree (scan-stacked
    or not) loads strictly into the port, and the export gives back the
    unscanned tree exactly."""
    cfg = tiny_test_config(**SLICE, **{"model.scan_layers": scan_layers})
    _, params = _jax_params(cfg, 3)
    port_cfg = torch_tiny_config(**SLICE).model
    model = TorchLECCR(port_cfg, device="cpu")
    load_jax_params(model, params)
    exported = params_to_jax(model.state_dict(), port_cfg)
    if scan_layers:
        _, unscanned = _jax_params(
            tiny_test_config(**SLICE, **{"model.scan_layers": False}), 3)
        assert (jax.tree.structure(exported)
                == jax.tree.structure(unscanned))
        sd = params_from_jax(exported, port_cfg)
        for name, value in model.state_dict().items():
            torch.testing.assert_close(sd[name], value, rtol=0, atol=0)
    else:
        assert jax.tree.structure(exported) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(exported), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("negatives", ["ring", "ring_fused"])
def test_ring_negatives_train_densely_on_one_device(negatives):
    """On one device the JAX trainer's ring applies only across blocks, so
    `ring` and `ring_fused` are the dense `gather` losses; `ring` sets 256
    streaming rows, which do not engage below 256 examples."""
    batch = _torch_batch(_batch(torch_tiny_config(**SLICE)))
    want_losses, want_grads = _step_grads(
        _cfg(**{"parallel.negatives": "gather"}), batch)
    losses, grads = _step_grads(_cfg(**{"parallel.negatives": negatives}),
                                batch)
    assert losses == want_losses
    for name, g in grads.items():
        torch.testing.assert_close(g, want_grads[name], rtol=0, atol=0,
                                   msg=name)
