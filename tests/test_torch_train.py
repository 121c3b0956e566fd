"""The port's training slice against the JAX package on CPU, in f32.

One whole train step at `tiny_test_config` with every dropout at 0, with
the flash attention on and off in the port (the JAX package takes its
plain attention off the TPU either way): the port's `make_train_step`
against JAX's value_and_grad of `grad_total` followed by `tx.update`.
Losses atol 1e-5; every gradient atol 1e-4; every parameter after the step
atol 1e-6 where its gradient is above f32 noise (see
`test_train_step_matches_jax`).  Then the optimizer against optax over 3
steps, the group labels, the schedule, global-norm clipping and the weight
export back to flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leccr_torch.config import OptimConfig as TorchOptimConfig
from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.weights import (
    flax_paths,
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from leccr_torch.ops.dropout import Generators
from leccr_torch.train import optim as port_optim
from leccr_torch.train.schedule import linear_warmup_decay as port_schedule
from leccr_torch.train.step import make_train_step
from leccr_tpu.config import OptimConfig, tiny_test_config
from leccr_tpu.data.images import preprocess_train_images
from leccr_tpu.models.leccr import LECCRModel
from leccr_tpu.models.losses import compute_losses
from leccr_tpu.train.optim import build_optimizer, classify_params
from leccr_tpu.train.schedule import linear_warmup_decay

LR = 1e-3
NO_DROPOUT = {"model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
              "model.text.attention_dropout": 0.0, "train.optimizer.lr": LR,
              "train.schedular.num_warmup_steps": 0}
B, L = 6, 16


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    res = cfg.model.vision.image_res
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    batch = {"vision": rs.randint(0, 256, (B, res, res, 3)).astype(np.uint8),
             "flip": rs.rand(B) < 0.5,
             "idx": np.array([0, 1, 2, 0, 3, 1], np.int32)}  # duplicates
    for key in ("text_ids_s", "text_ids_t", "caption_ids"):
        batch[key] = (rs.randint(5, 512, (B, L)) * mask).astype(np.int32)
    for key in ("text_mask_s", "text_mask_t", "caption_mask"):
        batch[key] = mask
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in ("text_ids_s", "text_ids_t", "caption_ids"):
        out[k] = out[k].long()
    return out


@pytest.fixture(scope="module")
def jax_step():
    """JAX's train step (trainer.py:366-452 with one device): params, the
    losses, the gradients of grad_total and the params after tx.update."""
    cfg = tiny_test_config(**NO_DROPOUT)
    mc = cfg.model
    batch = _batch(cfg)
    model = LECCRModel(mc)
    init_batch = {k: jnp.asarray(v) for k, v in batch.items()
                  if k not in ("idx", "flip")}
    init_batch["vision"] = init_batch["vision"].astype(jnp.float32)
    rs = np.random.RandomState(1)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        init_batch)["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    params["temp"] = np.float32(mc.temp)  # losses of O(1), not O(30)
    tx = build_optimizer(cfg.train.optimizer, params,
                         linear_warmup_decay(LR, 100, 0),
                         frozen_paths=("clip_text_tower",))

    def loss_fn(p):
        mb = dict(init_batch)
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


@pytest.mark.parametrize("fused", [True, False])
def test_train_step_matches_jax(jax_step, fused):
    """Adam's first step moves each coordinate by ~lr·sign(g): where g is
    f32 noise around 0 (the attention key biases, whose gradient is 0 in
    exact arithmetic because softmax is shift-invariant) the two packages
    step in random directions, so those coordinates are held to the step's
    bound 2·lr instead of 1e-6."""
    batch, params, want_losses, want_grads, want_params = jax_step
    cfg = torch_tiny_config(**NO_DROPOUT, **{
        "model.vision.fused_attention": fused,
        "model.text.fused_attention": fused})
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
    moved = params_from_jax(params, cfg.model)
    assert all(not torch.equal(p.detach(), moved[n])
               for n, p in model.named_parameters())


def test_caption_encoder_gets_no_gradient():
    """The caption encoder is the text tower run under no_grad: slots that
    depend on the captions give the text tower no gradient, and the
    optimizer holds each shared parameter once."""
    cfg = torch_tiny_config()
    model = TorchLECCR(cfg.model, device="cpu")
    model.train()
    batch = _torch_batch(_batch(cfg))
    batch["vision"] = batch["vision"].float()
    emb = model(batch, Generators.from_seed(0, "cpu"))
    emb.slots.sum().backward()
    assert all(p.grad is None for p in model.text_encoder.parameters())
    assert model.caption_proj.weight.grad is not None
    optimizer, _ = port_optim.build_optimizer(cfg.train.optimizer, model,
                                              lambda s: 1e-3)
    held = [p for g in optimizer.param_groups for p in g["params"]]
    assert len(held) == len({id(p) for p in held}) == len(
        list(model.parameters()))


def test_train_step_with_dropout_is_reproducible():
    """Dropout on: finite losses that depend only on (seed, step_no)."""
    cfg = torch_tiny_config(**{"model.vision.fused_attention": True,
                               "model.text.fused_attention": True})
    runs = []
    for _ in range(2):
        model = TorchLECCR(cfg.model, device="cpu", seed=1)
        step = make_train_step(cfg, model, total_steps=100)
        runs.append(step(_torch_batch(_batch(cfg)), 5))
    assert runs[0] == runs[1]
    assert all(np.isfinite(v) for v in runs[0].values())
    model = TorchLECCR(cfg.model, device="cpu", seed=1)
    other = make_train_step(cfg, model, total_steps=100)(
        _torch_batch(_batch(cfg)), 6)
    assert other["total"] != runs[0]["total"]


def test_master_params_stay_f32_and_fresh_model_serves():
    cfg = torch_tiny_config(**{"model.dtype": "bfloat16"})
    model = TorchLECCR(cfg.model, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    assert not model.training
    assert model.vision_tower.compute_dtype == torch.bfloat16
    assert model.text_encoder.layers[0].attention.query.compute_dtype == (
        torch.bfloat16)


@pytest.mark.parametrize("legacy_eps,moment_dtype", [
    (False, "float32"), (True, "float32"), (False, "bfloat16"),
    (True, "bfloat16")])
def test_optimizer_matches_optax(legacy_eps, moment_dtype):
    """3 steps of the 4-group AdamW on the tiny model's params with the
    same gradients, a warmup (the first lr is 0) and a non-empty
    lr_mult_paths, against optax."""
    cfg = torch_tiny_config()
    model = TorchLECCR(cfg.model, device="cpu", seed=2)
    kw = dict(lr=1e-3, weight_decay=0.05, lr_mult=3.0,
              lr_mult_paths=["queries", "crossattn_query"],
              legacy_eps=legacy_eps, moment_dtype=moment_dtype)
    params = params_to_jax(model.state_dict(), cfg.model)
    tx = build_optimizer(OptimConfig(**kw), params,
                         linear_warmup_decay(1e-3, 10, 2),
                         lr_mult_paths=tuple(kw["lr_mult_paths"]))
    state = tx.init(params)
    optimizer, scheduler = port_optim.build_optimizer(
        TorchOptimConfig(**kw), model, port_schedule(1e-3, 10, 2),
        lr_mult_paths=tuple(kw["lr_mult_paths"]))
    rs = np.random.RandomState(3)
    named = dict(model.named_parameters())
    for _ in range(3):
        grads = {n: torch.from_numpy(
            np.asarray(rs.randn(*p.shape) * 0.1, np.float32))
            for n, p in named.items()}
        for n, p in named.items():
            p.grad = grads[n].clone()
        optimizer.step()
        scheduler.step()
        updates, state = tx.update(params_to_jax(grads, cfg.model), state,
                                   params)
        params = optax.apply_updates(params, updates)
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg.model)
    for n, p in named.items():
        torch.testing.assert_close(p.detach(), want[n], rtol=0, atol=1e-6,
                                   msg=n)


def test_group_labels_match_classify_params():
    cfg = torch_tiny_config()
    model = TorchLECCR(cfg.model, device="cpu")
    mult = ("queries", "crossattn_query/layer_0/attn")
    got = port_optim.classify_params(model, mult)
    want = classify_params(params_to_jax(model.state_dict(), cfg.model),
                           mult)
    paths = flax_paths(model)
    for name, label in got.items():
        node = want
        for part in paths[name]:
            node = node[part]
        assert label == node, name
    assert got["text_encoder.embeddings_ln.weight"] == "base_no_decay"
    assert got["text_encoder.word_embeddings.weight"] == "base_decay"
    assert got["queries"] == "mult_decay"
    assert got["temp"] == "base_decay"


@pytest.mark.parametrize("warmup", [0, 3, 0.1, 0.25])
def test_schedule_matches_jax(warmup):
    got = port_schedule(1e-5, 40, warmup)
    want = linear_warmup_decay(1e-5, 40, warmup)
    for step in range(0, 45):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-12)
    if warmup:
        assert got(0) == 0.0  # a float or int warmup: the first step is 0


def test_clip_by_global_norm_matches_optax():
    rs = np.random.RandomState(4)
    arrays = [rs.randn(5, 3).astype(np.float32), rs.randn(7).astype(np.float32)]
    for max_norm in (1.0, 100.0):
        params = [torch.zeros(a.shape, requires_grad=True) for a in arrays]
        for p, a in zip(params, arrays):
            p.grad = torch.from_numpy(a.copy())
        port_optim.clip_by_global_norm(params, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in arrays], None)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


def test_params_to_jax_round_trip():
    """The export is the inverse of the import both ways, and its tree has
    exactly the JAX model's structure (unscanned)."""
    cfg = tiny_test_config()
    batch = _batch(cfg)
    init_batch = {k: jnp.asarray(v) for k, v in batch.items()
                  if k not in ("idx", "flip")}
    init_batch["vision"] = init_batch["vision"].astype(jnp.float32)
    params = jax.tree.map(np.asarray, LECCRModel(cfg.model).init(
        {"params": jax.random.PRNGKey(3)}, init_batch)["params"])
    port_cfg = torch_tiny_config().model
    exported = params_to_jax(params_from_jax(params, port_cfg), port_cfg)
    assert (jax.tree.structure(exported) == jax.tree.structure(params))
    for a, b in zip(jax.tree.leaves(exported), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    model = TorchLECCR(port_cfg, device="cpu", seed=7)
    sd = params_from_jax(params_to_jax(model.state_dict(), port_cfg),
                         port_cfg)
    for name, value in model.state_dict().items():
        torch.testing.assert_close(sd[name], value, rtol=0, atol=0)


@pytest.mark.parametrize("override,error,match", [
    ({"parallel.model": 2}, ValueError, "must divide the world, 1"),
    ({"parallel.fsdp": True}, None, None),
    ({"parallel.data": 2}, ValueError, "the world, 1")])
def test_unported_train_options_raise(override, error, match):
    """Data and tensor parallelism run over processes (tests/
    test_torch_distributed_trainer.py, tests/
    test_torch_tensor_parallel_ranks.py), so `parallel.data` must name the
    world, here one block, and `parallel.model` must divide it.  FSDP
    builds and steps (error None): on one data rank it shards nothing, as
    in the JAX package (tests/test_torch_fsdp*.py run it over ranks).  The
    EMA trains (tests/test_torch_trainer.py), `negatives: fused` and
    GradCache train on one device (tests/test_torch_large_batch_step.py),
    as do `ring` and `ring_fused` (tests/test_torch_scale_step.py)."""
    cfg = torch_tiny_config(**override)
    model = TorchLECCR(cfg.model, device="cpu")
    if error is None:
        step = make_train_step(cfg, model, total_steps=10)
        assert getattr(model, "fsdp", None) is None
        losses = step(_torch_batch(_batch(cfg)), 0)
        assert all(np.isfinite(v) for v in losses.values())
        return
    with pytest.raises(error, match=match):
        make_train_step(cfg, model, total_steps=10)
