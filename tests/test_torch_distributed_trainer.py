"""The port's data-parallel trainer over processes (gloo on the CPU):
two ranks run `Trainer.fit` (2 steps at bs8, 4 rows a rank, an eval of
val + test, a checkpoint) and a resume, laid out as in
tests/test_multiprocess.py, for `negatives` gather, ring and ring_fused,
GradCache at m = 2, and a video model with gather and ring_fused.

Against (every dropout at 0, RandAugment off: no two frameworks, and no
two batch layouts, draw the same bits):
  - each other: both ranks' losses and parameters bit for bit;
  - the port's one-process `TrainStep(num_blocks=2)` on the ranks'
    batches concatenated in rank order, from the same seeded weights:
    losses within 1e-5 of max(1, |x|); the first step's summed gradients
    within 1e-4 in PERF.md §2's floored measure; parameters within 1e-5
    where the
    first step's gradient carries signal (above 1e-4), elsewhere within
    Adam's steps of 2·lr each (f32 noise sets the direction of a
    zero-gradient coordinate's step, as in tests/test_torch_trainer.py);
  - the JAX Trainer on a 2-device data mesh (`devices=jax.devices()[:2]`)
    taking the same two steps from the same weights, for gather and for
    ring_fused under GradCache: losses within 1e-4 of max(1, |x|),
    parameters within 1e-4 where signal, else Adam's steps;
  - the eval metrics of the one-process Trainer on the final weights:
    equal.
The video model's ring_fused losses are within 5e-4 of max(1, |x|) of its
gather losses (tests/test_video_sharded.py:80's tolerance).  Each launch
of worker processes has a time limit: a hang fails the test.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from leccr_torch.config import load_config
from leccr_torch.config import tiny_test_config as port_tiny_config
from leccr_torch.data.pipeline import TrainLoader
from leccr_torch.data.synthetic import make_image_dataset, make_video_dataset
from leccr_torch.models.losses import LOSS_KEYS
from leccr_torch.models.weights import params_to_jax
from leccr_torch.train import trainer as port_trainer
from leccr_torch.train.step import make_train_step, step_generators

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3
WORLD = 2
STEPS = 2
WORKER_TIMEOUT_S = 400
BASE = {"model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
        "model.text.attention_dropout": 0.0, "data.randaugment": False,
        "data.num_workers": 1, "train.batch_size_train": 8,
        "train.batch_size_test": 4, "train.batch_size_test_text": 8,
        "train.schedular.epochs": 1, "train.schedular.num_warmup_steps": 0,
        "train.optimizer.lr": LR, "parallel.data": -1}
VIDEO = {"model.vision.kind": "temporal", "model.vision.frame_feat_dim": 32,
         "model.vision.num_layers": 1, "model.vision.num_heads": 4,
         "model.vision.max_frames": 6, "model.num_queries": 2}
MODES = {
    "gather": {},
    "ring": {"parallel.negatives": "ring"},
    "ring_fused": {"parallel.negatives": "ring_fused"},
    "grad_cache": {"parallel.negatives": "ring_fused",
                   "train.grad_cache_microbatches": 2},
    "video_gather": VIDEO,
    "video_ring_fused": {**VIDEO, "parallel.negatives": "ring_fused"},
}

WORKER = textwrap.dedent("""
    import json, sys, torch
    rank, world, port, jobs_path = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from leccr_torch.config import load_config
    from leccr_torch.parallel.mesh import DataMesh
    from leccr_torch.train.trainer import Trainer

    mesh = DataMesh.create(None, rank, world,
                           init_method=f"tcp://localhost:{port}",
                           device="cpu")
    for job in json.load(open(jobs_path)):
        cfg = load_config(job["config"])
        tr = Trainer(cfg, mesh=mesh)
        step, losses, grads = tr.state.train_step, [], {}
        run = step.run

        def recording(batch, step_no):
            values = run(batch, step_no)
            losses.append(values.tolist())
            if not grads:  # the first step's summed gradients
                grads.update({n: p.grad.clone() for n, p in
                              tr.state.model.named_parameters()})
            return values

        step.run = recording
        stats = tr.fit()
        params = {n: p.detach().clone()
                  for n, p in tr.state.model.named_parameters()}
        cfg = load_config(job["config"])
        cfg.train.resume = True
        again = Trainer(cfg, mesh=mesh)
        again.resume()
        resumed = all(torch.equal(p, params[n]) for n, p in
                      again.state.model.named_parameters())
        torch.save({"stats": stats, "losses": losses, "params": params,
                    "grads": grads, "resumed": resumed},
                   f"{job['out']}.rank{rank}")
    mesh.destroy()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(script: str, args, world: int, timeout: float,
                 cwd=ROOT) -> None:
    """Run `world` processes of `script` (rank, world, port, *args), each
    on one CPU thread; raise if any fails or the launch outlives
    `timeout`."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(world), str(port),
         *map(str, args)], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"


def _config(data, out: Path, options):
    cfg = port_tiny_config(**{**BASE, **options})
    cfg.data = data
    cfg.data.num_workers = 1
    cfg.output_dir = str(out)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mode's two-rank fit: {mode: (config path, [rank 0, rank 1]
    records)}."""
    tmp = tmp_path_factory.mktemp("ddp")
    images = make_image_dataset(str(tmp / "images"), n_train=8, n_eval=4,
                                caps_per_image=2, image_res=64, seed=0)
    videos = make_video_dataset(str(tmp / "videos"), n_train=8, n_eval=4,
                                feat_dim=32, frames_per_video=8)
    jobs = []
    for mode, options in MODES.items():
        data = videos if mode.startswith("video") else images
        cfg = _config(data, tmp / mode, options)
        path = tmp / f"{mode}.json"
        path.write_text(cfg.to_json())
        jobs.append({"config": str(path), "out": str(tmp / f"{mode}.out")})
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    launch_ranks(WORKER, [tmp / "jobs.json"], WORLD, WORKER_TIMEOUT_S)
    return {mode: (job["config"], [torch.load(f"{job['out']}.rank{r}",
                                              weights_only=False)
                                   for r in range(WORLD)])
            for mode, job in zip(MODES, jobs)}


def _rank_batches(cfg, trainer):
    """The two steps' batches of each rank, concatenated in rank order."""
    per_rank = [list(TrainLoader(
        trainer.train_ds, trainer.tokenizer, cfg.data,
        cfg.train.batch_size_train, num_workers=1,
        caption_tokenizer=trainer.caption_tokenizer, process_count=WORLD,
        process_index=r).epoch(0)) for r in range(WORLD)]
    return [{k: np.concatenate([rank[s][k] for rank in per_rank])
             for k in per_rank[0][s]} for s in range(STEPS)]


def _one_process(config_path, tmp_path):
    """(trainer, batches): a one-process port Trainer of the same config
    (the same seeded weights) and the ranks' concatenated batches."""
    cfg = load_config(config_path)
    cfg.output_dir = str(tmp_path / "one")
    trainer = port_trainer.Trainer(cfg, device="cpu")
    return trainer, _rank_batches(cfg, trainer)


def _first_grads(cfg, batch):
    """The one-process first step's gradients (a fresh seeded model)."""
    from leccr_torch.models.leccr import LECCRModel

    probe = LECCRModel(cfg.model, device="cpu", seed=cfg.train.seed)
    make_train_step(cfg, probe, STEPS, num_blocks=WORLD)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    return {n: p.grad for n, p in probe.named_parameters()}


def _signal(cfg, trainer, batch):
    """Where the first step's gradient exceeds 1e-4."""
    return {n: g.abs() > 1e-4 for n, g in _first_grads(cfg, batch).items()}


def _close_where_signal(got, want, signal, atol):
    for name, value in want.items():
        diff = (got[name] - value).abs()
        assert diff.where(signal[name], 0).max().item() <= atol, name
        assert diff.where(~signal[name], 0).max().item() <= (
            2 * LR * STEPS), name


def _losses_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= tol * np.maximum(1, np.abs(want))), (
        got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_ranks_agree_and_equal_one_process(runs, mode, tmp_path):
    config_path, (r0, r1) = runs[mode]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == STEPS
    for name, value in r0["params"].items():
        assert torch.equal(value, r1["params"][name]), name
    assert r0["stats"] == r1["stats"]
    assert r0["resumed"] and r1["resumed"]
    out = Path(load_config(config_path).output_dir)
    # rank 0 alone logs and writes checkpoints; rank 1 writes nothing there
    records = [json.loads(x) for x in (out / "log.txt").read_text().split(
        "\n") if x]
    assert [r.get("epoch") for r in records] == [0, None]
    assert (out / "checkpoints" / "best.json").exists()

    trainer, batches = _one_process(config_path, tmp_path)
    cfg = trainer.cfg
    step = make_train_step(cfg, trainer.state.model, STEPS, num_blocks=WORLD)
    want = [step({k: torch.from_numpy(v) for k, v in b.items()}, i)
            for i, b in enumerate(batches)]
    for got, w in zip(r0["losses"], want):
        _losses_close(got, [w[k] for k in LOSS_KEYS], 1e-5)
    # the ranks' summed gradients = the one process's, within 1e-4 of
    # max(the tensor's largest |g|, 1e-4 · the model's largest |g|), the
    # floored measure of PERF.md §2 (Adam's update hides a gradient's
    # scale, so the gradients are held here)
    first = _first_grads(cfg, batches[0])
    floor = 1e-4 * max(g.abs().max().item() for g in first.values())
    for name, g in first.items():
        err = (r0["grads"][name] - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), floor), name
    _close_where_signal(r0["params"],
                        dict(trainer.state.model.named_parameters()),
                        {n: g.abs() > 1e-4 for n, g in first.items()}, 1e-5)
    # the ranks' eval of the final weights = the one process's
    with torch.no_grad():
        for name, p in trainer.state.model.named_parameters():
            p.copy_(r0["params"][name])
    lang = next(iter(trainer.test_ds))
    metrics = trainer.evaluate(trainer.test_ds[lang])
    assert {f"{lang}_test_{k}": v for k, v in metrics.items()} == {
        k: v for k, v in r0["stats"].items() if k.startswith(f"{lang}_test_")}


@pytest.mark.parametrize("mode", ["gather", "grad_cache"])
def test_two_ranks_equal_the_jax_trainer_on_two_devices(runs, mode,
                                                        tmp_path):
    """gather, and ring_fused under GradCache (m = 2): the ring, its hand
    backward and GradCache's passes in one JAX compile."""
    from leccr_tpu.config import load_config as jax_load_config
    from leccr_tpu.parallel.mesh import shard_batch
    from leccr_tpu.train.trainer import Trainer as JaxTrainer

    config_path, (r0, _) = runs[mode]
    trainer, batches = _one_process(config_path, tmp_path)
    jcfg = jax_load_config(config_path)
    jcfg.output_dir = str(tmp_path / "jax")
    jax_tr = JaxTrainer(jcfg, devices=jax.devices()[:WORLD])
    state = jax_tr.state
    params = jax.device_put(
        params_to_jax(trainer.state.model.state_dict(), trainer.cfg.model),
        jax.tree.map(lambda x: x.sharding, state.params))
    opt_state = jax_tr.tx.init(params)
    ema, jax_losses = state.ema_params, []
    for i, batch in enumerate(batches):
        params, opt_state, ema, losses = jax_tr._train_step(
            params, opt_state, ema, shard_batch(jax_tr.mesh, batch), i)
        jax_losses.append([float(losses[k]) for k in LOSS_KEYS])
    for got, want in zip(r0["losses"], jax_losses):
        _losses_close(got, want, 1e-4)
    from leccr_torch.models.weights import params_from_jax

    want = params_from_jax(jax.tree.map(np.asarray, params),
                           trainer.cfg.model)
    _close_where_signal(r0["params"],
                        {n: want[n] for n in r0["params"]},
                        _signal(trainer.cfg, trainer, batches[0]), 1e-4)


def test_video_ring_matches_gather(runs):
    """ring_fused = gather negatives on the video model over two ranks."""
    ring = np.asarray(runs["video_ring_fused"][1][0]["losses"])
    gather = np.asarray(runs["video_gather"][1][0]["losses"])
    assert np.all(np.isfinite(ring))
    _losses_close(ring, gather, 5e-4)


def test_ranks_draw_different_dropout_masks():
    """(seed, step, rank): rank 0 draws what a one-process run draws, and
    two ranks never share masks, flash seeds or RandAugment draws."""
    gens = [step_generators(42, 3, "cpu", rank) for rank in range(3)]
    one = step_generators(42, 3, "cpu")
    bits = [torch.randint(0, 65536, (64,), generator=g.device)
            for g in gens]
    assert torch.equal(bits[0], torch.randint(0, 65536, (64,),
                                              generator=one.device))
    assert not torch.equal(bits[0], bits[1])
    assert not torch.equal(bits[1], bits[2])
    seeds = [g.flash_seed() for g in gens]
    assert len(set(seeds)) == 3
    draws = [torch.rand(8, generator=g.aug) for g in gens]
    assert not torch.equal(draws[0], draws[1])
