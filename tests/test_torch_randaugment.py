"""The port's device RandAugment (`leccr_torch.data.randaugment`) against the
JAX package's (`leccr_tpu.data.randaugment`), and in the train step.

- Each of the 16 ops of OP_BANK at M in {0, 3, 7, 10} on two smooth
  images (48x64 and 384x384) against JAX's op with the JAX op's own draws
  (the sign `_rand_sign(rng)` of the geometric ops, Cutout's
  `jax.random.uniform(rng, (2,))`), two draws a shape as one batch of two:
  Identity, Equalize, Solarize, Posterize, Invert and Cutout bit for bit
  (integer arithmetic, or exact float ops on the same bits); the rest
  within 1e-5 (f32 rounding of the same formulas).
- The policy: the port's draws replayed image by image through JAX's ops,
  in order, give the port's batch within 1e-5 (the live policy and the
  whole bank; each image goes through two ops).
- The gate fires at a rate within 6 sigma of 0.5, ops uniformly; the same
  generator state gives the same batch bit for bit, another state another.
- In the train step: a GradCache step (2 microbatches) with RandAugment on
  has the gradient of the monolithic objective on the same augmented
  images (each microbatch's `Generators.aug`), within 1e-6: its second
  forward drew the first's augmentation; with RandAugment off nothing
  draws from `aug`, and `device` / `host` are seeded as before it existed.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.data import randaugment as port
from leccr_torch.data.images import preprocess_train_images
from leccr_torch.models.leccr import LECCRModel as TorchLECCR
from leccr_torch.models.leccr import TrainEmbeddings as TorchEmb
from leccr_torch.models.losses import compute_losses
from leccr_torch.ops import dropout as port_dropout
from leccr_torch.ops.infonce import infonce_loss
from leccr_torch.train.step import grad_total, make_train_step
from leccr_torch.train.step import microbatch_generators
from leccr_tpu.data import randaugment as ref
from test_torch_large_batch_step import (
    LARGE,
    M_MICRO,
    NO_DROPOUT,
    _batch,
    _loss_kwargs,
    _torch_batch,
)

EXACT = {"Identity", "Equalize", "Solarize", "Posterize", "Invert",
         "Cutout"}
MAGS = (0, 3, 7, 10)
SHAPES = [(48, 64), (384, 384)]
RA = {"data.randaugment": True, "data.randaugment_n": 2,
      "data.randaugment_m": 9}


def smooth(h, w, seed):
    """A smooth RGB image in [0, 1] (slow gradients: a resampled point
    moves a pixel's value little)."""
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    chans = []
    for c in range(3):
        a, b, p = rs.uniform(0.5, 2.0, 3)
        chans.append(0.5 + 0.3 * np.sin(a * xs / w * 3 + p)
                     * np.cos(b * ys / h * 3)
                     + 0.1 * np.sin(xs * ys / (h * w) * 7 + c))
    return np.clip(np.stack(chans, -1), 0, 1).astype(np.float32)


def _jax_arg(name, rng):
    """The random argument JAX's op draws from rng, for the port's op."""
    if name == "Cutout":
        return torch.from_numpy(np.array(jax.random.uniform(rng, (2,))))
    return torch.tensor(float(ref._rand_sign(rng)))


@pytest.mark.parametrize("shape", SHAPES, ids=["48x64", "384x384"])
@pytest.mark.parametrize("name", list(ref.OP_BANK))
def test_op_matches_jax(name, shape):
    assert list(port.OP_BANK) == list(ref.OP_BANK)
    assert port.LIVE_POLICY == ref.LIVE_POLICY
    img = smooth(*shape, seed=0)
    imgs = np.stack([img, img[::-1].copy()])
    for mag in MAGS:
        rngs = [jax.random.PRNGKey(100 * s + mag) for s in range(2)]
        want = np.stack([np.asarray(ref.OP_BANK[name](jnp.asarray(x), mag, r))
                         for x, r in zip(imgs, rngs)])
        arg = torch.stack([_jax_arg(name, r) for r in rngs])
        got = port.OP_BANK[name](torch.from_numpy(imgs), mag, arg).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f"M={mag}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=f"M={mag}")


class _JaxDraws:
    """Stands for a JAX key in the replay: carries the port's draw."""

    def __init__(self, sign, centre):
        self.sign, self.centre = sign, centre


class _JaxWithDraws:
    """The `jax` module as the JAX ops see it in the replay: `random.
    uniform` returns the port's Cutout draw; everything else is jax."""

    random = SimpleNamespace(
        uniform=lambda rng, shape=(): jnp.asarray(rng.centre, jnp.float32))

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.mark.parametrize("ops", [port.LIVE_POLICY, tuple(port.OP_BANK)],
                         ids=["live", "bank"])
def test_policy_replays_through_jax_ops(ops, monkeypatch):
    monkeypatch.setattr(ref, "_rand_sign",
                        lambda rng: jnp.float32(rng.sign))
    monkeypatch.setattr(ref, "jax", _JaxWithDraws())
    b, mag = 12, 7
    images = np.stack([smooth(48, 64, seed=s) for s in range(b)])
    draws = port.sample_policy(b, 2, len(ops), torch.Generator().manual_seed(5))
    got = port.apply_policy(torch.from_numpy(images), draws, mag, ops)
    fired = 0
    for i in range(b):
        x = jnp.asarray(images[i])
        for r in range(2):
            if draws.gate[i, r] <= 0.5:
                fired += 1
                x = ref.OP_BANK[ops[int(draws.op[i, r])]](
                    x, mag, _JaxDraws(float(draws.sign[i, r]),
                                      draws.centre[i, r].numpy()))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(x), rtol=0,
                                   atol=1e-5, err_msg=f"image {i}")
    assert 0 < fired < 2 * b


def test_gate_rate_and_op_draws():
    n, bank = 20000, len(port.LIVE_POLICY)
    draws = port.sample_policy(n, 2, bank, torch.Generator().manual_seed(0))
    rate = (draws.gate <= 0.5).float().mean().item()
    assert abs(rate - 0.5) <= 6 * (0.25 / (2 * n)) ** 0.5
    counts = torch.bincount(draws.op.reshape(-1), minlength=bank).float()
    expect = 2 * n / bank
    assert counts.shape == (bank,)
    assert ((counts - expect).abs() <= 6 * expect ** 0.5).all()
    assert set(draws.sign.unique().tolist()) == {-1.0, 1.0}


def test_same_generator_state_same_batch():
    images = torch.from_numpy(np.stack([smooth(48, 64, s) for s in range(8)]))
    a = port.rand_augment_batch(images, torch.Generator().manual_seed(1))
    b = port.rand_augment_batch(images, torch.Generator().manual_seed(1))
    c = port.rand_augment_batch(images, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, images)  # the input is not written
    assert torch.equal(images, torch.from_numpy(
        np.stack([smooth(48, 64, s) for s in range(8)])))


def test_grad_cache_step_with_randaugment_equals_monolithic():
    cfg = torch_tiny_config(**LARGE, **NO_DROPOUT, **RA)
    mc = cfg.model
    batch = _torch_batch(_batch(cfg))
    step_no = 3
    model = TorchLECCR(mc, device="cpu", seed=4)
    model.train()
    b = batch["idx"].shape[0]
    embs = []
    for k in range(M_MICRO):
        rows = slice(k * b // M_MICRO, (k + 1) * b // M_MICRO)
        gens = microbatch_generators(cfg.train.seed + 17, step_no, k, "cpu")
        mb = {key: v[rows] for key, v in batch.items()
              if key not in ("idx", "flip")}
        mb["vision"] = preprocess_train_images(
            mb["vision"], batch["flip"][rows], gens.aug, 2, 9)
        embs.append(model(mb, gens))
    emb = TorchEmb(**{
        f.name: (embs[0].temp if f.name == "temp"
                 else torch.cat([getattr(e, f.name) for e in embs]))
        for f in dataclasses.fields(TorchEmb)})
    losses = compute_losses(emb, batch["idx"], itc_loss_fn=infonce_loss,
                            **_loss_kwargs(mc))
    grad_total(losses, mc).backward()

    stepped = TorchLECCR(mc, device="cpu", seed=4)
    got = make_train_step(cfg, stepped, total_steps=100)(batch, step_no)
    for key, value in losses.items():
        assert abs(got[key] - value.item()) <= 1e-6, key
    for name, p in stepped.named_parameters():
        want = dict(model.named_parameters())[name].grad
        want = torch.zeros_like(p) if want is None else want
        torch.testing.assert_close(p.grad, want, rtol=0, atol=1e-6,
                                   msg=name)
    # the augmentation did act
    plain = TorchLECCR(mc, device="cpu", seed=4)
    off = make_train_step(torch_tiny_config(**LARGE, **NO_DROPOUT), plain,
                          total_steps=100)(batch, step_no)
    assert off["total"] != got["total"]


class _Untouched:
    """A generator that fails the test when drawn from."""

    def __getattr__(self, name):
        raise AssertionError(f"RandAugment off drew from aug ({name})")


def test_randaugment_off_draws_nothing_from_aug(monkeypatch):
    """With RandAugment off, a step's losses and gradients are bit for
    bit those of generators seeded as before `aug` existed (device: the
    seed, host: seed ^ 0x5DEECE66D) whose `aug` may not be touched; dropout
    on, so the device and host streams do act."""
    cfg = torch_tiny_config(**{"model.dropout": 0.1,
                               "model.text.hidden_dropout": 0.1})
    batch = _torch_batch(_batch(cfg))

    def run():
        model = TorchLECCR(cfg.model, device="cpu", seed=4)
        losses = make_train_step(cfg, model, total_steps=10)(batch, 2)
        return losses, {n: p.grad for n, p in model.named_parameters()}

    want_losses, want_grads = run()

    def from_seed(seed, device):
        return port_dropout.Generators(
            torch.Generator(device=device).manual_seed(seed),
            torch.Generator().manual_seed(seed ^ 0x5DEECE66D), _Untouched())

    monkeypatch.setattr(port_dropout.Generators, "from_seed",
                        staticmethod(from_seed))
    losses, grads = run()
    assert losses == want_losses
    for name, g in want_grads.items():
        assert torch.equal(grads[name], g), name
