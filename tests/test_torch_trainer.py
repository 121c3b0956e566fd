"""The port's trainer loop (`leccr_torch.train.trainer`) on CPU: against the
JAX package's Trainer, then on its own, mirroring tests/test_train.py.

Against JAX (every dropout at 0, lr 1e-3, no warmup, the EMA on at decay
0.5 and evaluated; 16 synthetic images × 2 captions at bs8, one epoch,
eval on val + test; the port starts from JAX's initial parameters):
  - the JSONL record's train_* averages within 1e-4 (they are printed to
    5 decimals), its eval metrics equal;
  - the final parameters and EMA, at torch CPU thread counts 1, 4 and 8,
    within 1e-4 where the first step's gradient carries signal (above
    1e-4), elsewhere within Adam's steps; a `vproj` output channel whose
    caption-side cv target (the sign of a value that f32 noise moves, see
    `_noise_set_channels`) differs in sign from JAX's counts as noise;
  - one more JAX step against the port's EMA update on the same (EMA,
    parameters): rtol 2e-6;
  - `evaluate` on identical weights: embeddings within 1e-5, metrics
    equal.
The port alone: a 2-epoch fit whose loss falls; a checkpoint that restores
bit for bit; a mid-epoch resume equal to the uninterrupted run bit for bit;
a steps_per_epoch drift restarting at the epoch boundary; the best
checkpoint surviving rotation; the eval device cache; the EMA against its
recurrence (rtol 2e-6) and across resumes that turn it on and off; the
`python -m leccr_torch.run` CLI.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import state_equal
from leccr_torch.config import tiny_test_config as port_tiny_config
from leccr_torch.data import pipeline as port_pipe
from leccr_torch.data.tokenizers import (
    make_tokenizers,
    write_tiny_unigram_vocab,
)
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.weights import load_jax_params, params_from_jax
from leccr_torch.train import trainer as port_trainer
from leccr_torch.train.checkpoints import CheckpointManager
from leccr_torch.train.step import ema_update_, make_train_step
from leccr_tpu.config import tiny_test_config
from leccr_tpu.data import pipeline as jax_pipe
from leccr_tpu.data import tokenizers as jax_tok
from leccr_tpu.train import trainer as jax_trainer

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3
DECAY = 0.5
NO_DROPOUT = {"model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
              "model.text.attention_dropout": 0.0}


def _cfg(make_config, out, **overrides):
    """The tests' run: 16 synthetic images × 2 captions at bs8 (4 steps an
    epoch), 4 eval images, lr 1e-3 without warmup."""
    cfg = make_config(**{
        "data.dataset": "synthetic", "data.synthetic_size": 16,
        "data.synthetic_eval_images": 4,
        "data.synthetic_captions_per_image": 2, "data.num_workers": 2,
        "train.batch_size_train": 8, "train.batch_size_test": 4,
        "train.batch_size_test_text": 8, "train.schedular.epochs": 1,
        "train.schedular.num_warmup_steps": 0, "train.optimizer.lr": LR,
        "parallel.data": 1, **overrides})
    cfg.output_dir = str(out)
    return cfg


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _close_where_signal(got, want, signal, atol):
    """Each tensor within atol where `signal` (the first step's gradient
    above 1e-4), and elsewhere within 2·lr for each of the 4 steps: where
    the gradient is f32 noise around 0 (the attention key biases, whose
    gradient is 0 in exact arithmetic because softmax is shift-invariant),
    Adam scales it up to steps of ±lr in directions the noise sets, as in
    tests/test_torch_train.py's test_train_step_matches_jax."""
    for name, value in want.items():
        diff = (got[name] - value).abs()
        assert diff.where(signal[name], 0).max().item() <= atol, name
        assert diff.where(~signal[name], 0).max().item() <= 2 * LR * 4, name


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """One epoch of the JAX Trainer: the trainer, its initial parameters,
    the output root and its caption-side cv targets (`cv_caption_mean`,
    [B, D]) of each step."""
    from leccr_tpu.train.trainer import Trainer as JaxTrainer

    out = tmp_path_factory.mktemp("fit")
    options = {**NO_DROPOUT, "train.ema_decay": DECAY}
    jax_tr = JaxTrainer(_cfg(tiny_test_config, out / "jax", **options),
                        devices=jax.devices()[:1])
    init = jax.tree.map(lambda x: np.array(x, copy=True), jax_tr.state.params)
    targets = []
    losses = jax_trainer.compute_losses

    def recording(emb, *args, **kwargs):
        jax.debug.callback(lambda c: targets.append(np.array(c)),
                           emb.cv_caption_mean)
        return losses(emb, *args, **kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_trainer, "compute_losses", recording)
        jax_tr.fit()
    return jax_tr, init, out, targets[:4]


def _port_fit(jax_fit, name):
    """One epoch of the port's Trainer from JAX's initial weights, into
    `<out>/<name>`: (trainer, signal, records).  `signal` is where the
    first step's gradient (taken on a copy) exceeds 1e-4; records, for each
    step, its cv targets (cv_caption_mean [B, D]), |cproj(slot)| [B, D]
    and the slots' |slot|_1 [B, 1]."""
    _, init, out, _ = jax_fit
    options = {**NO_DROPOUT, "train.ema_decay": DECAY}
    port_tr = port_trainer.Trainer(
        _cfg(port_tiny_config, out / name, **options), device="cpu")
    load_jax_params(port_tr.state.model, init)
    step = port_tr.state.train_step
    step.ema = step.ema_of_params()
    probe = LECCRModel(port_tr.cfg.model, device="cpu")
    load_jax_params(probe, init)
    batch = next(iter(port_tr.train_loader.epoch(0)))
    make_train_step(port_tr.cfg, probe, 4)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    signal = {n: p.grad.abs() > 1e-4 for n, p in probe.named_parameters()}
    records = []
    objective, model = step.objective, port_tr.state.model

    def recording(emb, idx):
        with torch.no_grad():
            slots = emb.ori_slots.detach()
            records.append((emb.cv_caption_mean.detach().numpy().copy(),
                            model.cproj(slots).abs().amin(dim=1),
                            slots.abs().sum(-1).amax(1, keepdim=True)))
        return objective(emb, idx)

    step.objective = recording
    port_tr.fit()
    step.objective = objective
    return port_tr, signal, records


@pytest.fixture(scope="module")
def fitted(jax_fit):
    """One epoch of the JAX Trainer and of the port's from equal weights."""
    jax_tr, _, out, _ = jax_fit
    port_tr, signal, _ = _port_fit(jax_fit, "port")
    return jax_tr, port_tr, out, signal


def _records(out):
    return [json.loads(line)
            for line in (out / "log.txt").read_text().splitlines()]


def test_fit_logs_match_jax(fitted):
    _, port_tr, out, _ = fitted
    (want, want_best), (got, got_best) = (_records(out / "jax"),
                                          _records(out / "port"))
    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith("train_"):
            assert abs(float(got[key]) - float(value)) <= 1e-4, key
        else:
            assert got[key] == value, key
    assert got_best == want_best
    assert port_tr.state.step == 4


def _noise_set_channels(jax_targets, records):
    """The output channels d of `vproj` whose caption-side cv target the
    two packages set apart in sign.  The zero-initialised queries keep the
    caption slots equal, so F.normalize over the slot axis makes the target
    cv_caption_mean[b, d] = sign(cproj(slot)[b, d]) / 2; cproj's gradient
    is 0 in exact arithmetic, so Adam moves its weights by steps of up to
    lr that f32 noise points (the key biases' case), and where
    |cproj(slot)| is within those steps of 0 its sign is noise.  Each
    target that differs must be such an entry: |cproj(slot)| at most
    2·lr·k·(|slot|_1 + 1) after k steps.  The loss's gradient to vproj's
    row d then follows that sign, so that row (and bias) is held to Adam's
    noise bound, like the key biases."""
    channels = set()
    assert len(jax_targets) == len(records) == 4
    for k, (want, (got, cproj, slot_l1)) in enumerate(zip(jax_targets,
                                                         records)):
        apart = torch.from_numpy(np.sign(want) != np.sign(got))
        bound = 2 * LR * k * (slot_l1 + 1)
        assert bool((cproj <= bound).where(apart, True).all()), k
        channels |= set(torch.nonzero(apart)[:, 1].tolist())
    return sorted(channels)


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_final_params_and_ema_match_jax(jax_fit, threads):
    """At torch CPU thread counts 1, 4 and 8 (each its own port run)."""
    jax_tr, _, _, jax_targets = jax_fit
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        port_tr, signal, records = _port_fit(jax_fit,
                                             f"port_threads{threads}")
    finally:
        torch.set_num_threads(before)
    cfg = port_tr.cfg.model
    names = [n for n, _ in port_tr.state.model.named_parameters()]
    for d in _noise_set_channels(jax_targets, records):
        signal["vproj.weight"][d] = False
        signal["vproj.bias"][d] = False
    want = params_from_jax(jax.tree.map(np.asarray, jax_tr.state.params), cfg)
    _close_where_signal(_params(port_tr.state.model), want, signal, 1e-4)
    want_ema = params_from_jax(
        jax.tree.map(np.asarray, jax_tr.state.ema_params), cfg)
    _close_where_signal(dict(zip(names, port_tr.state.ema)), want_ema,
                        signal, 1e-4)


def test_ema_update_matches_jax_step(fitted):
    """One more JAX step from its final state; the port's EMA update of
    the same EMA with JAX's new parameters equals JAX's new EMA."""
    jax_tr, port_tr, _, _ = fitted
    cfg = port_tr.cfg.model
    state = jax_tr.state
    copy = lambda tree: jax.tree.map(lambda x: jax.numpy.array(x), tree)
    ema_before = params_from_jax(jax.tree.map(np.asarray, state.ema_params),
                                 cfg)
    batch = next(iter(jax_tr.train_loader.epoch(5)))
    params, _, ema, _ = jax_tr._train_step(
        copy(state.params), copy(state.opt_state), copy(state.ema_params),
        batch, np.int32(state.step))
    new_params = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    want = params_from_jax(jax.tree.map(np.asarray, ema), cfg)
    names = list(new_params)
    got = [ema_before[n].clone() for n in names]
    ema_update_(got, [new_params[n] for n in names], DECAY)
    for name, g in zip(names, got):
        torch.testing.assert_close(g, want[name], rtol=2e-6, atol=1e-7,
                                   msg=name)


def test_evaluate_matches_jax_on_equal_weights(fitted):
    """The port's EMA set to JAX's (both evaluate their EMA weights)."""
    jax_tr, port_tr, _, _ = fitted
    params = jax.tree.map(np.asarray, jax_tr.eval_params)  # JAX's EMA
    weights = params_from_jax(params, port_tr.cfg.model)
    step = port_tr.state.train_step
    saved, step.ema = step.ema, [
        weights[n].clone() for n, _ in port_tr.state.model.named_parameters()]
    try:
        _evaluate_both(jax_tr, port_tr, params)
    finally:
        step.ema = saved


def _evaluate_both(jax_tr, port_tr, params):
    from leccr_tpu.data.images import normalize_images
    from leccr_tpu.data.pipeline import EvalLoader

    for lang in port_tr.test_ds:
        port_ds, jax_ds = port_tr.test_ds[lang], jax_tr.test_ds[lang]
        img, slots, txt = port_tr.embed_split(port_ds)
        cfg = jax_tr.cfg
        loader = EvalLoader(jax_ds, jax_tr.tokenizer, cfg.data,
                            cfg.train.batch_size_test,
                            cfg.train.batch_size_test_text)
        want_txt = np.concatenate([np.asarray(jax_tr._embed_texts_stacked(
            params, ids[None], mask[None]))[0][:n]
            for ids, mask, n in loader.text_batches()])
        want_img, want_slots = [], []
        for batch, count in loader.image_batches():
            out = jax_tr._embed_images(params, {
                **batch, "vision": normalize_images(batch["vision"])})
            want_img.append(np.asarray(out["feat"])[:count])
            want_slots.append(np.asarray(out["slots"])[:count])
        for got, want in ((txt, want_txt), (img, np.concatenate(want_img)),
                          (slots, np.concatenate(want_slots))):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        # the JAX metrics of the same weights (its eval params are these),
        # with the default fusion ("auto": none for images) and the image
        # alpha blend of the slots
        for fusion in ("auto", "raw"):
            for trainer in (port_tr, jax_tr):
                trainer.cfg.train.eval_fusion = fusion
            try:
                assert (port_tr.evaluate(port_ds)
                        == jax_tr.evaluate(jax_ds)), fusion
            finally:
                for trainer in (port_tr, jax_tr):
                    trainer.cfg.train.eval_fusion = "auto"


def test_two_epoch_fit_learns_and_checkpoints(tmp_path):
    tr = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path, **{
        "train.schedular.epochs": 2}), device="cpu")
    stats = tr.fit()
    assert tr.state.step == 2 * tr.steps_per_epoch == 8
    assert 0.0 <= stats["de_test_txt_r1"] <= 100.0
    assert stats["de_test_sumr_sum"] > 0.0
    records = _records(tmp_path)
    assert [r.get("epoch") for r in records] == [0, 1, None]
    first, last = (sum(float(r[f"train_{k}"]) for k in (
        "loss_itc_vs", "loss_itc_vt", "loss_itc_st")) for r in records[:2])
    assert last < first
    assert tr.ckpt.latest_step() == 8
    info = tr.ckpt.best_info()
    assert info["epoch"] in (0, 1) and info["metrics"]["sumr_sum"] > 0
    assert records[-1] == {"best_epoch": info["epoch"],
                           "best": info["metrics"]["sumr_sum"]}
    assert json.loads((tmp_path / "checkpoints" / "config.json").read_text(
    ))["train"]["schedular"]["epochs"] == 2


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, moment_dtype):
    """Model, optimizer (torch's AdamW, or the port's with bf16 moments),
    EMA and step restore bit for bit into a second Trainer."""
    cfg = _cfg(port_tiny_config, tmp_path, **{
        "train.checkpoint_every_steps": 3, "train.ema_decay": DECAY,
        "train.optimizer.moment_dtype": moment_dtype})
    tr = port_trainer.Trainer(cfg, device="cpu")
    tr.fit()
    state = tr.state
    cfg2 = _cfg(port_tiny_config, tmp_path, **{
        "train.ema_decay": DECAY, "train.resume": True,
        "train.optimizer.moment_dtype": moment_dtype})
    tr2 = port_trainer.Trainer(cfg2, device="cpu")
    assert tr2.resume() == (1, 0)
    assert tr2.state.step == state.step == 4
    assert state_equal(tr2.state.model.state_dict(),
                        state.model.state_dict())
    assert state_equal(tr2.state.optimizer.state_dict(),
                        state.optimizer.state_dict())
    assert state_equal(tr2.state.ema, state.ema)
    assert tr2.state.train_step.scheduler.last_epoch == 4
    if moment_dtype == "bfloat16":
        assert all(s["mu"].dtype == torch.bfloat16
                   for s in tr2.state.optimizer.state.values())


def test_mid_epoch_resume_equals_uninterrupted_run(tmp_path):
    """A run with a snapshot at step 6 (epoch 1, batch 2) is cut there and
    resumed: it takes the same batches and random streams, and lands on
    the uninterrupted run's parameters, optimizer state and EMA bit for
    bit, at exactly 2 epochs of steps."""
    opts = {"train.schedular.epochs": 2, "train.checkpoint_every_steps": 6,
            "train.keep_checkpoints": 5, "train.ema_decay": DECAY}
    tr = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path, **opts),
                              device="cpu")
    tr.fit()
    ckpt_dir = tmp_path / "checkpoints"
    assert sorted(p.name for p in ckpt_dir.glob("step_*.pt"))[-2:] == [
        "step_00000006.pt", "step_00000008.pt"]
    (ckpt_dir / "step_00000008.pt").unlink()  # preempted after step 6
    tr2 = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path, **opts,
                                    **{"train.resume": True}), device="cpu")
    tr2.fit()
    assert tr2.state.step == 8
    assert [len(t["wait_s"]) for t in tr2.timing] == [2]
    assert state_equal(tr2.state.model.state_dict(),
                        tr.state.model.state_dict())
    assert state_equal(tr2.state.optimizer.state_dict(),
                        tr.state.optimizer.state_dict())
    assert state_equal(tr2.state.ema, tr.state.ema)


def test_steps_per_epoch_drift_restarts_at_the_epoch_boundary(tmp_path,
                                                              capsys):
    tr = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path, **{
        "train.checkpoint_every_steps": 2}), device="cpu")
    tr.fit()  # 4 steps an epoch; a snapshot at step 2, the epoch at 4
    (tmp_path / "checkpoints" / "step_00000004.pt").unlink()
    tr2 = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path, **{
        "train.batch_size_train": 4, "train.schedular.epochs": 2,
        "train.resume": True}), device="cpu")
    assert tr2.steps_per_epoch == 8
    capsys.readouterr()
    assert tr2.resume() == (1, 0)
    assert "steps_per_epoch changed" in capsys.readouterr().out
    assert tr2.state.step == 8
    # the schedule follows the optimizer's own count (2 steps taken)
    assert tr2.state.train_step.scheduler.last_epoch == 2
    tr2.fit()
    assert tr2.state.step == 16


def test_best_checkpoint_survives_rotation(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    opt = {"state": {0: {"m": torch.zeros(3)}}, "param_groups": []}
    ckpt.save(1, {"w": torch.full((3,), 7.0)}, opt, epoch=0,
              metrics={"sumr_sum": 9.0}, is_best=True)
    for step in (2, 3, 4):
        ckpt.save(step, {"w": torch.full((3,), float(step))}, opt, epoch=0)
    ckpt.wait()
    assert ckpt.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "checkpoints").glob("*.pt")) \
        == ["step_00000003.pt", "step_00000004.pt"]
    model, optim, ema, meta = ckpt.restore_best()
    torch.testing.assert_close(model["w"], torch.full((3,), 7.0), rtol=0,
                               atol=0)
    assert meta == {"step": 1, "epoch": 0, "steps_per_epoch": 0}
    assert ema is None and state_equal(optim, opt)
    assert ckpt.best_info() == {"step": 1, "epoch": 0,
                                "metrics": {"sumr_sum": 9.0}}
    # a newer best replaces the old one in best/
    ckpt.save(5, {"w": torch.full((3,), 5.0)}, opt, epoch=1, is_best=True)
    assert ckpt.restore_best()[3]["step"] == 5
    assert [p.name for p in (tmp_path / "checkpoints" / "best").iterdir()] \
        == ["step_00000005.pt"]
    # a failed write raises in wait(), and leaves no step file behind
    ckpt.save(6, {"w": lambda: 0}, opt, epoch=1)
    with pytest.raises(Exception):
        ckpt.wait()
    assert ckpt.latest_step() == 5


def test_restore_takes_files_without_optional_keys(tmp_path):
    """A file without "ema" and without meta.steps_per_epoch restores, and
    resume then checks the position by the epoch alone."""
    tr = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path), device="cpu")
    tr.fit()
    path = tmp_path / "checkpoints" / "step_00000004.pt"
    state = torch.load(path, weights_only=True)
    assert "ema" not in state and state["meta"]["steps_per_epoch"] == 4
    del state["meta"]["steps_per_epoch"]
    torch.save(state, path)
    model, optim, ema, meta = tr.ckpt.restore()
    assert ema is None and meta == {"step": 4, "epoch": 0,
                                    "steps_per_epoch": 0}
    tr2 = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path, **{
        "train.schedular.epochs": 2, "train.resume": True,
        "train.ema_decay": DECAY}), device="cpu")
    assert tr2.resume() == (1, 0) and tr2.state.step == 4
    assert state_equal(tr2.state.ema, [
        p.detach() for p in tr2.state.model.parameters()])


def test_eval_device_cache_reused_and_equal(tmp_path):
    tr = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path), device="cpu")
    lang = list(tr.test_ds)[0]
    ds = tr.test_ds[lang]
    first = tr.evaluate(ds)
    pinned, cached = tr._eval_device_cache[id(ds)]
    assert pinned is ds
    assert all(isinstance(b["vision"], torch.Tensor) for b, _ in cached)
    assert tr.evaluate(ds) == first
    # the budget is global, first-come, no eviction: once it is spent,
    # other splits take the uncached path each time, with equal results
    tr._eval_cache_bytes = tr.cfg.data.cache_eval_on_device_mb * 2 ** 20
    other = tr.val_ds[lang]
    uncached = tr.evaluate(other)
    assert id(other) not in tr._eval_device_cache
    assert tr.evaluate(other) == uncached


def test_ema_tracks_and_checkpoints(tmp_path):
    """The step advances ema = ema·d + p·(1−d) (against the recurrence over
    2 steps); evaluation reads the EMA weights without touching the
    trained model; a resume restores the EMA, ignores it when the EMA is
    off, and seeds it from the parameters over a checkpoint without one."""
    tr = port_trainer.Trainer(_cfg(port_tiny_config, tmp_path / "a", **{
        "train.ema_decay": DECAY}), device="cpu")
    step = tr.state.train_step
    want = [t.clone() for t in step.ema]
    from leccr_torch.data.pipeline import device_prefetch

    batches = device_prefetch(tr.train_loader.epoch(0), tr.device)
    for k in range(2):
        step.run(next(batches), k)
        want = [w * DECAY + p.detach() * (1 - DECAY)
                for w, p in zip(want, step.params)]
    batches.close()
    for got, w in zip(step.ema, want):
        torch.testing.assert_close(got, w, rtol=2e-6, atol=1e-7)
    live = _params(tr.state.model)
    assert tr.eval_params is step.ema
    model = tr.eval_model()
    assert model is not tr.state.model
    assert all(torch.equal(p, e) for p, e in zip(model.parameters(),
                                                 step.ema))
    assert state_equal(_params(tr.state.model), live)
    tr.cfg.train.ema_eval = False
    assert all(p is q for p, q in zip(tr.eval_params,
                                      tr.state.model.parameters()))
    assert tr.eval_model() is tr.state.model

    run2 = tmp_path / "b"
    tr2 = port_trainer.Trainer(_cfg(port_tiny_config, run2, **{
        "train.ema_decay": DECAY}), device="cpu")
    tr2.fit()
    tr3 = port_trainer.Trainer(_cfg(port_tiny_config, run2, **{
        "train.ema_decay": DECAY, "train.schedular.epochs": 2,
        "train.resume": True}), device="cpu")
    tr3.resume()
    assert state_equal(tr3.state.ema, tr2.state.ema)
    tr4 = port_trainer.Trainer(_cfg(port_tiny_config, run2, **{
        "train.schedular.epochs": 2, "train.resume": True}), device="cpu")
    tr4.fit()
    assert tr4.state.ema is None and tr4.state.step == 8

    run5 = tmp_path / "c"
    port_trainer.Trainer(_cfg(port_tiny_config, run5), device="cpu").fit()
    tr6 = port_trainer.Trainer(_cfg(port_tiny_config, run5, **{
        "train.ema_decay": DECAY, "train.schedular.epochs": 2,
        "train.resume": True}), device="cpu")
    tr6.resume()
    assert state_equal(tr6.state.ema, [
        p.detach() for p in tr6.state.model.parameters()])


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "leccr_torch.run", "--task", "itr_caption",
         "--config", "configs/tiny_synth.yaml", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_cli_trains_evaluates_and_resumes(tmp_path):
    out = tmp_path / "run"
    proc = _run_cli("--output_dir", str(out), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    records = _records(out)
    assert [r.get("epoch") for r in records] == [0, 1, None]
    assert "de_test_sumr_sum" in records[0]
    assert (out / "config.json").exists()
    assert (out / "checkpoints" / "best.json").exists()
    assert list((out / "checkpoints").glob("step_*.pt"))
    # evaluate the restored weights as epoch 2 of 3: the last epoch's
    # test metrics again
    proc = _run_cli("--output_dir", str(out), "--device", "cpu",
                    "--evaluate", "--resume", "--epoch", "3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "resumed from step 40" in proc.stdout
    again = _records(out)[len(records):]
    assert [r.get("epoch") for r in again] == [2, None]
    assert not any(k.startswith("train_") for k in again[0])
    assert {k: v for k, v in again[0].items() if k != "epoch"} == {
        k: v for k, v in records[1].items()
        if k != "epoch" and not k.startswith("train_")}


def test_cli_without_a_card_raises(tmp_path):
    """The entry point runs on the GPU unless told otherwise; without one
    it raises instead of running on the CPU."""
    proc = _run_cli("--output_dir", str(tmp_path / "run"))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "run" / "log.txt").exists()


@pytest.mark.parametrize("override", [{"parallel.model": 2},
                                      {"parallel.fsdp": True}])
def test_cli_unported_options_raise(tmp_path, override):
    """Every task runs, on one device or data-parallel over several
    (tests/test_torch_run_distributed.py); tensor parallelism runs over
    processes whose count the model count divides (tests/
    test_torch_tensor_parallel_run.py), so on one device it raises; FSDP
    trains on one device, where it shards nothing, as in the JAX package
    (over ranks: tests/test_torch_fsdp_ranks.py)."""
    from leccr_torch.config import load_config
    from leccr_torch.run import main

    cfg = load_config(str(ROOT / "configs" / "tiny_synth.yaml"))
    (key, value), = override.items()
    setattr(cfg.parallel, key.split(".")[1], value)
    cfg.train.schedular.epochs = 1
    cfg.save(str(tmp_path / "config.json"))
    args = ["--config", str(tmp_path / "config.json"), "--output_dir",
            str(tmp_path / "run"), "--device", "cpu"]
    if key == "parallel.fsdp":
        main(args)
        records = _records(tmp_path / "run")
        assert [r.get("epoch") for r in records] == [0, None]
        assert math.isfinite(float(records[0]["train_loss_itc_vs"]))
        return
    with pytest.raises(ValueError, match="must divide the world, 1"):
        main(args)


def test_cli_one_device_passes_the_devices_check(tmp_path):
    """--devices 1 names the one device the port runs, as the JAX
    launcher's first local device: the task goes on to its own checks."""
    from leccr_torch.run import main

    config = str(Path(__file__).resolve().parent.parent / "configs"
                 / "tiny_synth.yaml")
    with pytest.raises(SystemExit, match="requires --index"):
        main(["--task", "serve", "--devices", "1", "--config", config,
              "--output_dir", str(tmp_path), "--device", "cpu"])


def test_cli_checkpoint_from_an_orbax_directory_raises(tmp_path):
    """The port reads no orbax directory; the error names the routes from
    the JAX package."""
    from leccr_torch.run import main

    orbax = tmp_path / "orbax" / "40"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax.*params_from_jax"):
        main(["--config", str(ROOT / "configs" / "tiny_synth.yaml"),
              "--output_dir",
              str(tmp_path / "run"), "--device", "cpu", "--checkpoint",
              str(orbax)])


@pytest.mark.parametrize("overrides,error", [
    ({"parallel.fsdp": True}, None),
    ({"parallel.model": 2}, ValueError)])
def test_trainer_unported_options_raise(tmp_path, overrides, error):
    """`parallel.model: 2` raises on one process; FSDP builds and steps
    (on one data rank it shards nothing, as in the JAX package)."""
    cfg = _cfg(port_tiny_config, tmp_path, **overrides)
    if error is None:
        trainer = port_trainer.Trainer(cfg, device="cpu")
        assert getattr(trainer.state.model, "fsdp", None) is None
        batch = next(iter(trainer.train_loader.epoch(0)))
        values = trainer.state.train_step.run(
            {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
        assert bool(torch.isfinite(values).all())
        return
    with pytest.raises(error):
        port_trainer.Trainer(cfg, device="cpu")


def test_debug_nans_checks_each_step():
    """train.debug_nans: the same losses and parameters as without it,
    and a NaN in the parameters stops the step with an error."""
    from test_torch_train import _batch, _torch_batch

    runs = []
    for debug in (False, True):
        cfg = port_tiny_config(**{"train.debug_nans": debug})
        model = LECCRModel(cfg.model, device="cpu", seed=3)
        step = make_train_step(cfg, model, total_steps=10)
        losses = step(_torch_batch(_batch(cfg)), 0)
        runs.append((losses, _params(model)))
    assert runs[0][0] == runs[1][0]
    assert state_equal(runs[0][1], runs[1][1])
    with torch.no_grad():
        model.temp.fill_(float("nan"))
    with pytest.raises((FloatingPointError, RuntimeError), match="nan|NaN"):
        step(_torch_batch(_batch(cfg)), 1)
    assert not torch.is_anomaly_enabled()


# ------------------------------------- tokenizers, weights in and out, serving

WORDS = ("a man rides his red bike dog runs in the green field ein mann "
         "fährt rad").split()
MERGES = ["#version: 0.2", "r e", "re d</w>", "d o", "do g</w>", "m a",
          "ma n</w>", "a</w>", "t h", "th e</w>"]


@pytest.mark.parametrize("text_kind,caption", [
    ("xlmr", "mbert"), ("xlmr", "clip"), ("bert", "clip")])
def test_loader_batches_equal_jax_for_each_tokenizer(tmp_path, text_kind,
                                                      caption):
    """The trainer's tokenizer choice and the loaders' batches, bit for bit
    against the JAX Trainer's, for the Unigram text tokenizer and the CLIP
    BPE caption tokenizer (77-wide caption rows, mask = ids != 0)."""
    merges = tmp_path / "merges.txt"
    merges.write_text("\n".join(MERGES) + "\n", encoding="utf-8")
    overrides = {"model.text.kind": text_kind,
                 "model.caption_encoder_name": caption,
                 "data.clip_bpe_vocab": str(merges),
                 "data.token_buckets": [8, 16]}
    loaders = []
    for make, build, pipe in (
            (tiny_test_config, jax_trainer.build_datasets, jax_pipe),
            (port_tiny_config, port_trainer.build_datasets, port_pipe)):
        cfg = _cfg(make, tmp_path / make.__module__, **overrides)
        train, val, _ = build(cfg)
        if make is port_tiny_config:
            tok, cap = make_tokenizers(cfg)
        else:  # the JAX Trainer's choice (leccr_tpu/train/trainer.py)
            tok = (jax_tok.UnigramTokenizer if text_kind == "xlmr"
                   else jax_tok.WordPieceTokenizer)(cfg.data.text_vocab)
            cap = (jax_tok.ClipBPETokenizer(str(merges)) if caption == "clip"
                   else tok)
        loader = pipe.TrainLoader(train, tok, cfg.data, batch_size=4,
                                  num_workers=1, caption_tokenizer=cap)
        (split,) = val.values()
        evals = pipe.EvalLoader(split, tok, cfg.data, batch_size=3,
                                text_batch_size=4, caption_tokenizer=cap)
        loaders.append((loader, evals))
    (jax_loader, jax_eval), (port_loader, port_eval) = loaders
    assert port_loader.native  # g++ builds the library here
    for epoch in range(2):
        got, want = (list(port_loader.epoch(epoch)),
                     list(jax_loader.epoch(epoch)))
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            if caption == "clip":
                assert g["caption_ids"].shape[1] == 77
    for (g, gn), (w, wn) in zip(port_eval.image_batches(),
                                jax_eval.image_batches()):
        assert gn == wn
        for key in ("caption_ids", "caption_mask"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    for g, w in zip(port_eval.text_batches(), jax_eval.text_batches()):
        np.testing.assert_array_equal(g[0], w[0])


def test_inference_weights_take_the_newest_checkpoint_and_its_ema(fitted):
    """load_params_for_inference: the newest checkpoint of output_dir, its
    EMA when it holds one (ema_eval); seeded random weights when there is
    none."""
    from leccr_torch.serve import load_params_for_inference

    _, port_tr, out, _ = fitted
    model = load_params_for_inference(port_tr.cfg, device="cpu")
    for got, want in zip(model.parameters(), port_tr.state.ema):
        assert torch.equal(got.detach(), want)
    cfg = _cfg(port_tiny_config, out / "empty")
    fresh = load_params_for_inference(cfg, device="cpu", seed=4)
    assert state_equal(fresh.state_dict(),
                       LECCRModel(cfg.model, device="cpu",
                                  seed=4).state_dict())


def _xlmr_config(tmp_path, **overrides):
    """A config file of the tiny model with the XLM-R text tower, and the
    config itself."""
    cfg = _cfg(port_tiny_config, tmp_path / "unused", **{
        "model.text.kind": "xlmr", "model.text.type_vocab_size": 1,
        "model.text.pad_token_id": 1, "model.text.max_position_embeddings": 66,
        "train.schedular.epochs": 1, **overrides})
    path = tmp_path / "xlmr.json"
    cfg.save(str(path))
    return str(path), cfg


def test_cli_imports_trains_and_exports_the_xlmr_model(tmp_path, capsys):
    """`--checkpoint` with a reference .pth (other weights plus dead X-VLM
    keys) before training; then `--task export` of the trained checkpoint
    (config.json read beside it) gives the trained weights back."""
    from leccr_torch.models.weights import (
        export_reference_state_dict,
        load_initial_checkpoint,
        save_reference_checkpoint,
    )
    from leccr_torch.run import main

    config, cfg = _xlmr_config(tmp_path)
    source = LECCRModel(cfg.model, device="cpu", seed=21)
    ref = export_reference_state_dict(source)
    ref["itm_head.weight"] = torch.zeros(2, 64)
    save_reference_checkpoint(ref, str(tmp_path / "ref.pth"))

    loaded = []
    original = port_trainer.Trainer.load_initial_checkpoint

    def spy(self, path):
        report = original(self, path)
        loaded.append(state_equal(self.state.model.state_dict(),
                                  source.state_dict()))
        return report

    port_trainer.Trainer.load_initial_checkpoint = spy
    try:
        main(["--config", config, "--output_dir", str(tmp_path / "run"),
              "--checkpoint", str(tmp_path / "ref.pth"), "--device", "cpu"])
    finally:
        port_trainer.Trainer.load_initial_checkpoint = original
    printed = capsys.readouterr().out
    assert loaded == [True]
    assert "### Tokenizer: UnigramTokenizer (native)" in printed
    assert "itm_head.weight" in printed  # listed as unused
    records = _records(tmp_path / "run")
    assert [r.get("epoch") for r in records] == [0, None]
    assert np.isfinite(float(records[0]["train_loss_itc_vs"]))

    (step,) = (tmp_path / "run" / "checkpoints").glob("step_*.pt")
    main(["--task", "export", "--checkpoint", str(step), "--export_path",
          str(tmp_path / "export" / "ref.pth"), "--device", "cpu"])
    trained = torch.load(step, map_location="cpu",
                         weights_only=True)["model"]
    back = LECCRModel(cfg.model, device="cpu", seed=22)
    report = load_initial_checkpoint(str(tmp_path / "export" / "ref.pth"),
                                     back)
    assert report.issues == []
    assert state_equal(back.state_dict(), trained)


def test_embedder_serves_the_xlmr_model_as_jax_does(tmp_path):
    """Embedder with the Unigram tokenizer: the JAX Embedder's text
    embeddings and index at the same params, and `checkpoint=` (an
    exported reference file) serving the same weights."""
    from leccr_torch.models.weights import (
        export_reference_state_dict,
        save_reference_checkpoint,
    )
    from leccr_torch.serve import Embedder as PortEmbedder
    from leccr_tpu.models.leccr import LECCRModel as JaxLECCR
    from leccr_tpu.serve import Embedder as JaxEmbedder

    _, cfg = _xlmr_config(tmp_path)
    vocab = tmp_path / "uni.tsv"
    write_tiny_unigram_vocab(str(vocab), WORDS)
    cfg.data.text_vocab = str(vocab)
    jcfg = _cfg(tiny_test_config, tmp_path / "unused", **{
        "model.text.kind": "xlmr", "model.text.type_vocab_size": 1,
        "model.text.pad_token_id": 1,
        "model.text.max_position_embeddings": 66})
    jcfg.data.text_vocab = str(vocab)
    rs = np.random.RandomState(0)
    res = cfg.model.vision.image_res
    ids = rs.randint(2, 100, (1, 8)).astype(np.int32)
    one = np.ones_like(ids)
    batch = {"vision": np.zeros((1, res, res, 3), np.float32),
             "text_ids_s": ids, "text_mask_s": one, "text_ids_t": ids,
             "text_mask_t": one, "caption_ids": ids, "caption_mask": one}
    params = JaxLECCR(jcfg.model).init(
        {"params": jax.random.PRNGKey(0)},
        jax.tree.map(np.asarray, batch))["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    texts = ["a man rides his red bike", "ein mann fährt rad", "dog €",
             "the green field", "runs", ""]
    images = rs.randint(0, 256, (5, res, res, 3)).astype(np.uint8)
    captions = ["a red dog", "the field", "a man", "bike", "ein rad"]
    jax_emb = JaxEmbedder(jcfg, params, batch_size=4)
    port = PortEmbedder.from_config(cfg, params=params, device="cpu",
                                    batch_size=4)
    np.testing.assert_allclose(port.embed_texts(texts),
                               jax_emb.embed_texts(texts), rtol=0, atol=1e-4)
    want = jax_emb.build_image_index(images, captions)
    got = port.build_image_index(images, captions)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats)[:5],
                               rtol=0, atol=1e-4)

    path = tmp_path / "exported.pth"
    save_reference_checkpoint(export_reference_state_dict(port.model),
                              str(path))
    served = PortEmbedder.from_config(cfg, device="cpu", batch_size=4,
                                      checkpoint=str(path))
    assert state_equal(served.model.state_dict(), port.model.state_dict())
    hits = served.search_texts(texts[:3], served.build_image_index(
        images, captions), k=2)
    assert [len(h) for h in hits] == [2, 2, 2]
