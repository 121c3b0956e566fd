"""Tensor parallelism over processes (gloo on the CPU): train steps at
data 1 × model 2 and data 2 × model 2, and `python -m leccr_torch.run
--devices 4` with `parallel.model: 2`.

The step checks: a tiny flagship (ViT width 128 at 2 heads, BERT width
64 at 4 heads, both towers on the flash path, `fused_attention`) takes two
steps of a bs8 batch, each data rank its rows.  Against
  - the port's one-process `TrainStep` on the same global batch, from the
    same seeded weights (at data 1 × model 2, with every dropout at 0 and
    with every dropout at 0.1: the masks are the one-process run's, so the
    same tolerances hold; and with dropout and remat, whose recompute
    runs the collectives again): losses within 1e-5 of max(1, |x|); the first
    step's gradients, gathered over the model ranks, within 1e-4 in
    PERF.md §2's floored measure; the gathered parameters within 1e-5
    where the first step's gradient carries signal, else within Adam's
    steps of 2·lr each;
  - at data 2 × model 2 the one-process step with dropout off, and with
    dropout on the data-parallel run at data 2 × model 1 (a data rank d
    draws d's streams, which no one-process run draws), at the same
    tolerances;
  - the JAX Trainer on a 2 × 2 virtual mesh (`make_mesh(ParallelConfig(
    data=2, model=2), jax.devices()[:4])`) taking the same two steps from
    the same weights, dropout off: losses within 1e-4 of max(1, |x|),
    parameters within 1e-4 where signal, else Adam's steps (the
    data-parallel comparison's tolerances, tests/
    test_torch_distributed_trainer.py).
In every run the model ranks' losses and replicated parameters are equal
bit for bit, before the data-group sum every replicated parameter's
gradient is equal across the model group, and the dense state and Adam
moments gathered and cut again are each rank's own bit for bit (the
checkpoint's round trip).  Each launch of worker
processes has a time limit: a hang fails the test.
"""

import copy
import json
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from leccr_torch.config import load_config
from leccr_torch.config import tiny_test_config as port_tiny_config
from leccr_torch.data.pipeline import TrainLoader
from leccr_torch.data.synthetic import make_image_dataset
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.losses import LOSS_KEYS
from leccr_torch.models.weights import params_from_jax, params_to_jax
from leccr_torch.train import trainer as port_trainer
from leccr_torch.train.step import make_train_step
from test_torch_distributed_trainer import launch_ranks

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3
STEPS = 2
SEED = 3
WORKER_TIMEOUT_S = 300
BASE = {"model.vision.width": 128, "model.vision.fused_attention": True,
        "model.text.fused_attention": True, "data.randaugment": False,
        "data.num_workers": 1, "train.batch_size_train": 8,
        "train.schedular.epochs": 1, "train.schedular.num_warmup_steps": 0,
        "train.optimizer.lr": LR, "train.grad_clip": 1.0,
        "parallel.data": -1}
DROPOUT_OFF = {"model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
               "model.text.attention_dropout": 0.0}
DROPOUT_ON = {"model.dropout": 0.1, "model.text.hidden_dropout": 0.1,
              "model.text.attention_dropout": 0.1}
# world 2: data 1 × model 2 (dropout off and on), and the data-parallel
# reference of the world-4 dropout run; world 4: data 2 × model 2
JOBS = {2: {"d1m2_off": (2, DROPOUT_OFF), "d1m2_on": (2, DROPOUT_ON),
            "d1m2_remat": (2, {**DROPOUT_ON, "model.remat": True}),
            "d2m1_on": (1, DROPOUT_ON)},
        4: {"d2m2_off": (2, DROPOUT_OFF), "d2m2_on": (2, DROPOUT_ON)}}

WORKER = textwrap.dedent("""
    import json, sys, torch
    import numpy as np
    rank, world, port, jobs_path = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from leccr_torch.config import load_config
    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.parallel.mesh import DataMesh
    from leccr_torch.parallel.tensor import (
        gather_optimizer_state, gather_state, gather_tensors, model_group,
        shard_optimizer_state, shard_tensors, sharded_params)
    from leccr_torch.train import step as step_module

    for job in json.load(open(jobs_path)):
        cfg = load_config(job["config"])
        mesh = DataMesh.create(cfg.parallel, rank, world,
                               init_method=f"tcp://localhost:{port}",
                               device="cpu")
        model = LECCRModel(cfg.model, device="cpu", seed=job["seed"])
        step = step_module.make_train_step(cfg, model, job["steps"],
                                           mesh=mesh)
        group = model_group(mesh)
        sharded = {id(p) for p in sharded_params(model)}

        def same_on_model_ranks(tensors):
            # names whose tensor differs between the model ranks
            if mesh.model_world == 1:
                return []
            return [n for n, t in tensors.items()
                    if not all(torch.equal(t, x)
                               for x in group.all_gather(t))]

        reduce, unequal = step_module.all_reduce_grads, []

        def checked(params, m):
            if not unequal:
                unequal.append(same_on_model_ranks(
                    {n: p.grad for n, p in model.named_parameters()
                     if id(p) not in sharded}))
            return reduce(params, m)

        step_module.all_reduce_grads = checked
        batches = np.load(job["batches"])
        losses, grads = [], {}
        for i in range(job["steps"]):
            rows = slice(mesh.data_rank * job["rows"],
                         (mesh.data_rank + 1) * job["rows"])
            batch = {k[len(f"{i}."):]: torch.from_numpy(v[rows])
                     for k, v in batches.items() if k.startswith(f"{i}.")}
            losses.append(step.run(batch, i).tolist())
            if not grads:  # the first step's gradients, gathered
                grads = gather_tensors(model, {
                    n: p.grad for n, p in model.named_parameters()})
        step_module.all_reduce_grads = reduce
        replicated = {n: p.detach() for n, p in model.named_parameters()
                      if id(p) not in sharded}
        # the dense state and Adam moments, gathered and cut again, are the
        # rank's own bit for bit (the checkpoint's round trip)
        dense = gather_state(model)
        local = shard_tensors(model, dense)
        opt = step.optimizer
        back = shard_optimizer_state(model, opt,
                                     gather_optimizer_state(model, opt))
        round_trip = all(torch.equal(local[n], t)
                         for n, t in model.state_dict().items()) and all(
            torch.equal(back["state"][i][k], v)
            for i, entry in opt.state_dict()["state"].items()
            for k, v in entry.items())
        record = {"losses": losses, "grads": grads, "params": dense,
                  "round_trip": round_trip,
                  "unequal_grads": unequal[0],
                  "unequal_params": same_on_model_ranks(replicated),
                  "data_rank": mesh.data_rank,
                  "model_rank": mesh.model_rank}
        torch.save(record, f"{job['out']}.rank{rank}")
    mesh.destroy()
""")


def _config(data, out: Path, model: int, options) -> object:
    cfg = port_tiny_config(**{**BASE, **options, "parallel.model": model})
    cfg.data = data
    cfg.data.num_workers = 1
    cfg.output_dir = str(out)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tmp dir, image data, the global batches [step] of numpy arrays)."""
    tmp = tmp_path_factory.mktemp("tp")
    images = make_image_dataset(str(tmp / "images"), n_train=8, n_eval=4,
                                caps_per_image=2, image_res=64, seed=0)
    cfg = _config(images, tmp / "one", 1, DROPOUT_OFF)
    trainer = port_trainer.Trainer(cfg, device="cpu")
    loader = TrainLoader(trainer.train_ds, trainer.tokenizer, cfg.data,
                         cfg.train.batch_size_train, num_workers=1,
                         caption_tokenizer=trainer.caption_tokenizer)
    batches = list(loader.epoch(0))
    # one epoch of STEPS steps: the JAX Trainer's schedule spans it
    assert len(batches) == STEPS
    np.savez(tmp / "batches.npz", **{f"{i}.{k}": v for i, b in
                                     enumerate(batches) for k, v in b.items()})
    return tmp, images, batches


@pytest.fixture(scope="module")
def runs(setup):
    """{job: (config, [records by global rank])} of both launches."""
    tmp, images, _ = setup
    out = {}
    for world, jobs in JOBS.items():
        specs = []
        for name, (model, options) in jobs.items():
            cfg = _config(images, tmp / name, model, options)
            path = tmp / f"{name}.json"
            path.write_text(cfg.to_json())
            rows = cfg.train.batch_size_train // (world // model)
            specs.append({"config": str(path), "out": str(tmp / name),
                          "batches": str(tmp / "batches.npz"),
                          "seed": SEED, "steps": STEPS, "rows": rows})
        (tmp / f"jobs{world}.json").write_text(json.dumps(specs))
        launch_ranks(WORKER, [tmp / f"jobs{world}.json"], world,
                     WORKER_TIMEOUT_S)
        for name, spec in zip(jobs, specs):
            out[name] = (load_config(spec["config"]),
                         [torch.load(f"{spec['out']}.rank{r}",
                                     weights_only=False)
                          for r in range(world)])
    return out


def _one_process(cfg, batches, num_blocks):
    """(losses [step][key], the first step's gradients, the final params)
    of the port's one-process step on the global batches."""
    cfg = load_config_copy(cfg, **{"parallel.model": 1})
    model = LECCRModel(cfg.model, device="cpu", seed=SEED)
    step = make_train_step(cfg, model, STEPS, num_blocks=num_blocks)
    losses, grads = [], None
    for i, b in enumerate(batches):
        values = step({k: torch.from_numpy(v) for k, v in b.items()}, i)
        losses.append([values[k] for k in LOSS_KEYS])
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return losses, grads, {n: p.detach() for n, p in
                           model.named_parameters()}


def load_config_copy(cfg, **overrides):
    """A copy of cfg with dotted-key overrides."""
    out = copy.deepcopy(cfg)
    for key, value in overrides.items():
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = getattr(node, part)
        setattr(node, parts[-1], value)
    return out


def _losses_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= tol * np.maximum(1, np.abs(want))), (
        got, want)


def _grads_close(got, want):
    """PERF.md §2's floored measure: within 1e-4 of max(the tensor's
    largest |g|, 1e-4 · the model's largest |g|)."""
    floor = 1e-4 * max(g.abs().max().item() for g in want.values())
    for name, g in want.items():
        err = (got[name] - g).abs().max().item()
        assert err <= 1e-4 * max(g.abs().max().item(), floor), (name, err)


def _params_close(got, want, grads, atol):
    for name, value in want.items():
        signal = grads[name].abs() > 1e-4
        diff = (got[name] - value).abs()
        assert diff.where(signal, 0).max().item() <= atol, name
        assert diff.where(~signal, 0).max().item() <= 2 * LR * STEPS, name


def _ranks_agree(records):
    for r in records:
        assert r["round_trip"]
        assert r["unequal_grads"] == [] and r["unequal_params"] == [], r[
            "unequal_grads"] + r["unequal_params"]
        assert r["losses"] == records[0]["losses"]
    for name, value in records[0]["params"].items():
        for r in records[1:]:
            assert torch.equal(r["params"][name], value), name


@pytest.mark.parametrize("job", ["d1m2_off", "d1m2_on", "d1m2_remat",
                                 "d2m2_off"])
def test_tensor_parallel_step_equals_one_process(runs, setup, job):
    cfg, records = runs[job]
    _ranks_agree(records)
    assert [(r["data_rank"], r["model_rank"]) for r in records] == [
        (d, m) for d in range(len(records) // 2) for m in range(2)]
    data = len(records) // 2
    losses, grads, params = _one_process(cfg, setup[2], data)
    for got, want in zip(records[0]["losses"], losses):
        _losses_close(got, want, 1e-5)
    _grads_close(records[0]["grads"], grads)
    _params_close(records[0]["params"], params, grads, 1e-5)


def test_tensor_parallel_dropout_equals_data_parallel(runs):
    """data 2 × model 2 with every dropout at 0.1 = data 2 × model 1: the
    same masks, the same step."""
    _, tp = runs["d2m2_on"]
    _, dp = runs["d2m1_on"]
    _ranks_agree(tp)
    for got, want in zip(tp[0]["losses"], dp[0]["losses"]):
        _losses_close(got, want, 1e-5)
    _grads_close(tp[0]["grads"], dp[0]["grads"])
    _params_close(tp[0]["params"], dp[0]["params"], dp[0]["grads"], 1e-5)
    # dropout is on: the losses differ from the dropout-off run's
    assert tp[0]["losses"] != runs["d2m2_off"][1][0]["losses"]


def test_data2_model2_equals_the_jax_trainer(runs, setup, tmp_path):
    from leccr_tpu.config import load_config as jax_load_config
    from leccr_tpu.parallel.mesh import shard_batch
    from leccr_tpu.train.trainer import Trainer as JaxTrainer

    cfg, records = runs["d2m2_off"]
    path = tmp_path / "config.json"
    cfg.output_dir = str(tmp_path / "jax")
    path.write_text(cfg.to_json())
    jax_tr = JaxTrainer(jax_load_config(str(path)), devices=jax.devices()[:4])
    assert dict(jax_tr.mesh.shape) == {"data": 2, "model": 2}
    state = jax_tr.state
    dense = LECCRModel(load_config_copy(cfg, **{"parallel.model": 1}).model,
                       device="cpu", seed=SEED)
    params = jax.device_put(params_to_jax(dense.state_dict(), cfg.model),
                            jax.tree.map(lambda x: x.sharding, state.params))
    opt_state = jax_tr.tx.init(params)
    ema, jax_losses = state.ema_params, []
    for i, batch in enumerate(setup[2]):
        params, opt_state, ema, losses = jax_tr._train_step(
            params, opt_state, ema, shard_batch(jax_tr.mesh, batch), i)
        jax_losses.append([float(losses[k]) for k in LOSS_KEYS])
    for got, want in zip(records[0]["losses"], jax_losses):
        _losses_close(got, want, 1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg.model)
    _, grads, _ = _one_process(cfg, setup[2], 2)
    _params_close(records[0]["params"],
                  {n: want[n] for n in records[0]["params"]}, grads, 1e-4)
