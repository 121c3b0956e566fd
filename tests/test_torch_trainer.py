"""The port's trainer loop (`leccr_torch.train.trainer`) on CPU: against the
JAX package's Trainer, then on its own, mirroring tests/test_train.py.

Against JAX (every dropout at 0, lr 1e-3, no warmup, the EMA on at decay
0.5 and evaluated; 16 synthetic images × 2 captions at bs8, one epoch,
eval on val + test; the port starts from JAX's initial parameters):
  - the JSONL record's train_* averages within 1e-4 (they are printed to
    5 decimals), its eval metrics equal;
  - the final parameters and EMA within 1e-4 where the first step's
    gradient carries signal (above 1e-4), elsewhere within Adam's steps;
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
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.weights import load_jax_params, params_from_jax
from leccr_torch.train import trainer as port_trainer
from leccr_torch.train.checkpoints import CheckpointManager
from leccr_torch.train.step import ema_update_, make_train_step
from leccr_tpu.config import tiny_test_config

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
def fitted(tmp_path_factory):
    """One epoch of the JAX Trainer and of the port's from equal weights."""
    from leccr_tpu.train.trainer import Trainer as JaxTrainer

    out = tmp_path_factory.mktemp("fit")
    options = {**NO_DROPOUT, "train.ema_decay": DECAY}
    jax_tr = JaxTrainer(_cfg(tiny_test_config, out / "jax", **options),
                        devices=jax.devices()[:1])
    init = jax.tree.map(lambda x: np.array(x, copy=True), jax_tr.state.params)
    port_tr = port_trainer.Trainer(
        _cfg(port_tiny_config, out / "port", **options), device="cpu")
    load_jax_params(port_tr.state.model, init)
    port_tr.state.train_step.ema = port_tr.state.train_step.ema_of_params()
    # where the gradient carries signal: the first step's, on a copy
    probe = LECCRModel(port_tr.cfg.model, device="cpu")
    load_jax_params(probe, init)
    batch = next(iter(port_tr.train_loader.epoch(0)))
    make_train_step(port_tr.cfg, probe, 4)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    signal = {n: p.grad.abs() > 1e-4 for n, p in probe.named_parameters()}
    jax_tr.fit()
    port_tr.fit()
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


def test_final_params_and_ema_match_jax(fitted):
    jax_tr, port_tr, _, signal = fitted
    cfg = port_tr.cfg.model
    want = params_from_jax(jax.tree.map(np.asarray, jax_tr.state.params), cfg)
    _close_where_signal(_params(port_tr.state.model), want, signal, 1e-4)
    want_ema = params_from_jax(
        jax.tree.map(np.asarray, jax_tr.state.ema_params), cfg)
    names = [n for n, _ in port_tr.state.model.named_parameters()]
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


@pytest.mark.parametrize("args", [
    ["--task", "vtr_caption"], ["--task", "serve"], ["--task", "export"],
    ["--checkpoint", "/some/weights.pth"]])
def test_cli_unported_options_raise(tmp_path, args):
    from leccr_torch.run import main

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--output_dir", str(tmp_path), "--device", "cpu", *args])


@pytest.mark.parametrize("overrides,error", [
    ({"data.dataset": "video"}, NotImplementedError),
    ({"model.text.kind": "xlmr"}, NotImplementedError),
    ({"parallel.model": 2}, NotImplementedError)])
def test_trainer_unported_options_raise(tmp_path, overrides, error):
    with pytest.raises(error):
        port_trainer.Trainer(_cfg(port_tiny_config, tmp_path, **overrides),
                             device="cpu")


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
