"""FSDP (`parallel.fsdp`) over processes, gloo on the CPU: two launches,
of 2 and of 4 worker processes, and one CLI run of 2, each with a time
limit (a hang fails the test), every floor at 1 (`parallel.fsdp_min_size`) so the tiny towers
shard as the production ones do at 65 536.

- data 2 with FSDP against data 2 without it, two steps of a bs8 batch,
  every dropout at 0.1, the clip off: the losses and the parameters
  gathered after the steps bit for bit (each gradient sum has two terms,
  so the reduce-scatter's order cannot differ from the all-reduce's), and
  each rank holds only its shard of every parameter the layout cuts and
  of its Adam moments (`numel`);
- data 2 × model 2 with FSDP and the clip at 1 against the JAX Trainer on
  a 2 × 2 virtual mesh with `fsdp=True` (tests/test_fsdp.py:87's
  tolerances: losses within rtol 2e-3, atol 1e-4; the parameters within
  1e-4 where the first step's gradient carries signal, else Adam's steps);
- the scale composition (`__graft_entry__.scale_dryrun_config`'s recipe:
  XLM-R with the Unigram tokenizer, remat, `ring_fused`, streamed losses,
  GradCache 2, FSDP) at data 2 × model 2: an epoch and an eval, finite,
  and the epoch's losses equal to the dense `gather` path without remat
  or streaming on the same mesh at rtol 2e-3, atol 2e-4
  (tests/test_scale_dryrun.py:55);
- the checkpoint: a data-2 FSDP run's files equal a data-2 run's without
  FSDP bit for bit (the dense format: parameters, Adam moments, EMA);
  resumed at data 4 with FSDP, the state gathered back is the file's bit
  for bit and training goes on; `--task export` of it equals the export of
  the run without FSDP;
- `python -m leccr_torch.run --device cpu --devices 2` with FSDP at data
  2: train, eval, a dense checkpoint whose weights give the logged
  metrics.

The 8-process form (data 2 × model 4, the JAX dry run's own shape) and
the CLI at `--devices 4` (data 2 × model 2: 4 ranks beside the launcher)
are marked slow, as tests/test_scale_dryrun.py is.
"""

import copy
import json
import math
import shutil
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
from leccr_torch.models.weights import (
    flax_paths,
    params_from_jax,
    params_to_jax,
)
from leccr_torch.parallel.fsdp import fsdp_layout
from leccr_torch.parallel.mesh import partition_spec
from leccr_torch.run import main
from leccr_torch.train import trainer as port_trainer
from test_torch_distributed_trainer import launch_ranks
from test_torch_tensor_parallel_ranks import _one_process, _params_close

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3
STEPS = 2
SEED = 3
WORKER_TIMEOUT_S = 300
BASE = {"model.vision.width": 128, "model.vision.fused_attention": True,
        "model.text.fused_attention": True, "data.randaugment": False,
        "data.num_workers": 1, "train.batch_size_train": 8,
        "train.schedular.epochs": 1, "train.schedular.num_warmup_steps": 0,
        "train.optimizer.lr": LR, "parallel.data": -1,
        "parallel.fsdp_min_size": 1}
DROPOUT_OFF = {"model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
               "model.text.attention_dropout": 0.0}
DROPOUT_ON = {"model.dropout": 0.1, "model.text.hidden_dropout": 0.1,
              "model.text.attention_dropout": 0.1}
FIT = {**DROPOUT_ON, "train.ema_decay": 0.9, "train.grad_clip": 0.0,
       "train.batch_size_test": 4, "train.batch_size_test_text": 8}

WORKER = textwrap.dedent("""
    import copy, json, sys, torch
    import numpy as np
    rank, world, port, jobs_path = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from leccr_torch.config import load_config
    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.parallel.fsdp import fsdp_params
    from leccr_torch.parallel.mesh import DataMesh
    from leccr_torch.parallel.tensor import (
        gather_optimizer_state, gather_state, gather_tensors)
    from leccr_torch.train.step import make_train_step
    from leccr_torch.train.trainer import Trainer

    def sizes(model, optimizer):
        # {name: (the rank's numel, [its Adam moments' numels])}
        names = {id(p): n for n, p in model.named_parameters()}
        out = {n: [p.numel(), []] for n, p in model.named_parameters()}
        for p, state in optimizer.state.items():
            out[names[id(p)]][1] = [v.numel() for k, v in state.items()
                                    if k != "step"]
        return out

    def dense_ema(model, ema):
        names = [n for n, _ in model.named_parameters()]
        return list(gather_tensors(model, dict(zip(names, ema))).values())

    for job in json.load(open(jobs_path)):
        cfg = load_config(job["config"])
        mesh = DataMesh.create(cfg.parallel, rank, world,
                               init_method=f"tcp://localhost:{port}",
                               device="cpu")
        record = {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank}
        if job["kind"] == "step":
            model = LECCRModel(cfg.model, device="cpu", seed=job["seed"])
            step = make_train_step(cfg, model, job["steps"], mesh=mesh)
            batches = np.load(job["batches"])
            losses = []
            for i in range(job["steps"]):
                rows = slice(mesh.data_rank * job["rows"],
                             (mesh.data_rank + 1) * job["rows"])
                batch = {k[len(f"{i}."):]: torch.from_numpy(v[rows])
                         for k, v in batches.items()
                         if k.startswith(f"{i}.")}
                losses.append(step.run(batch, i).tolist())
            record.update(losses=losses, params=gather_state(model),
                          sizes=sizes(model, step.optimizer),
                          sharded=len(fsdp_params(model)))
        else:
            trainer = Trainer(cfg, mesh=mesh)
            state = trainer.state
            if job["kind"] == "resume":
                trainer.resume()
                # copies: an unsharded tensor is the live one, which the
                # training below moves
                record.update(copy.deepcopy({
                    "restored": gather_state(state.model),
                    "optimizer": gather_optimizer_state(state.model,
                                                        state.optimizer),
                    "ema": dense_ema(state.model, state.ema)}))
            if job["kind"] == "epoch":
                record["stats"] = trainer.train_epoch(0)
                if job.get("evaluate"):
                    lang = next(iter(trainer.test_ds))
                    record["metrics"] = trainer.evaluate(
                        trainer.test_ds[lang])
            else:
                record["stats"] = trainer.fit()
            record["sharded"] = len(fsdp_params(state.model))
        torch.save(record, f"{job['out']}.rank{rank}")
    mesh.destroy()
""")


def _config(data, out: Path, options) -> object:
    cfg = port_tiny_config(**{**BASE, **options})
    if data is not None:
        cfg.data = copy.deepcopy(data)
        cfg.data.num_workers = 1
    cfg.output_dir = str(out)
    return cfg


def scale_config(out: Path, data: int, model: int, dense: bool = False):
    """`scale_dryrun_config`'s recipe (__graft_entry__.py:193-231) on the
    port at data × model processes, dropout off (the JAX dry run's
    comparison); `dense`: its baseline, the `gather` path without remat or
    streaming, FSDP and GradCache kept."""
    n = data * model
    cfg = port_tiny_config(**DROPOUT_OFF)
    cfg.output_dir = str(out)
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_size = 4 * n
    cfg.data.synthetic_eval_images = 4
    cfg.data.num_workers = 1
    cfg.train.batch_size_train = 2 * n
    cfg.train.schedular.epochs = 1
    t = cfg.model.text
    t.kind, t.pad_token_id, t.type_vocab_size = "xlmr", 1, 1
    t.fused_attention = cfg.model.vision.fused_attention = False
    cfg.model.remat = not dense
    cfg.model.weight_dstl_loss = 0.5
    cfg.model.weight_cv_loss = 0.01
    cfg.parallel.model = model
    cfg.parallel.data = data
    cfg.parallel.negatives = "gather" if dense else "ring_fused"
    cfg.parallel.stream_loss_block_rows = 0 if dense else 8
    cfg.parallel.fsdp = True
    cfg.parallel.fsdp_min_size = 1
    cfg.train.grad_cache_microbatches = 2
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tmp dir, image data, the global batches [step] of numpy arrays)."""
    tmp = tmp_path_factory.mktemp("fsdp")
    images = make_image_dataset(str(tmp / "images"), n_train=8, n_eval=4,
                                caps_per_image=2, image_res=64, seed=0)
    cfg = _config(images, tmp / "one", DROPOUT_OFF)
    trainer = port_trainer.Trainer(cfg, device="cpu")
    loader = TrainLoader(trainer.train_ds, trainer.tokenizer, cfg.data,
                         cfg.train.batch_size_train, num_workers=1,
                         caption_tokenizer=trainer.caption_tokenizer)
    batches = list(loader.epoch(0))
    assert len(batches) == STEPS  # the JAX Trainer's schedule spans them
    np.savez(tmp / "batches.npz", **{f"{i}.{k}": v for i, b in
                                     enumerate(batches) for k, v in b.items()})
    return tmp, images, batches


def _launch(tmp, world, jobs):
    """Run `jobs` ({name: (kind, config, extra spec)}) in one launch of
    `world` processes; {name: (config, [records by global rank])}."""
    specs = []
    for name, (kind, cfg, extra) in jobs.items():
        path = tmp / f"{name}.json"
        path.write_text(cfg.to_json())
        specs.append({"kind": kind, "config": str(path),
                      "out": str(tmp / name), "seed": SEED,
                      "steps": STEPS, "batches": str(tmp / "batches.npz"),
                      **extra})
    (tmp / f"jobs{world}.json").write_text(json.dumps(specs))
    launch_ranks(WORKER, [tmp / f"jobs{world}.json"], world,
                 WORKER_TIMEOUT_S)
    return {name: (load_config(spec["config"]),
                   [torch.load(f"{spec['out']}.rank{r}", weights_only=False)
                    for r in range(world)])
            for name, spec in zip(jobs, specs)}


@pytest.fixture(scope="module")
def runs(setup):
    tmp, images, _ = setup
    step2 = {"rows": 4}
    out = _launch(tmp, 2, {
        "d2_dense": ("step", _config(images, tmp / "d2_dense",
                                     {**DROPOUT_ON, "parallel.fsdp": False}),
                     step2),
        "d2_fsdp": ("step", _config(images, tmp / "d2_fsdp",
                                    {**DROPOUT_ON, "parallel.fsdp": True}),
                    step2),
        "fit_dense": ("fit", _config(images, tmp / "fit_dense",
                                     {**FIT, "parallel.fsdp": False}), {}),
        "fit_fsdp": ("fit", _config(images, tmp / "fit_fsdp",
                                    {**FIT, "parallel.fsdp": True}), {})})
    # the data-2 FSDP run resumed at data 4, with FSDP
    shutil.copytree(tmp / "fit_fsdp", tmp / "resume4",
                    ignore=shutil.ignore_patterns(".synthetic*"))
    resume = _config(images, tmp / "resume4",
                     {**FIT, "parallel.fsdp": True, "train.resume": True,
                      "train.schedular.epochs": 2})
    resume.train.batch_size_test = resume.train.batch_size_test_text = 8
    out.update(_launch(tmp, 4, {
        "d2m2_fsdp": ("step", _config(images, tmp / "d2m2_fsdp", {
            **DROPOUT_OFF, "parallel.fsdp": True, "parallel.model": 2,
            "train.grad_clip": 1.0}), step2),
        "scale": ("epoch", scale_config(tmp / "scale", 2, 2),
                  {"evaluate": True}),
        "scale_dense": ("epoch", scale_config(tmp / "scale_dense", 2, 2,
                                              dense=True), {}),
        "resume4": ("resume", resume, {})}))
    return out


def _ranks_agree(records):
    for r in records[1:]:
        assert r.get("losses") == records[0].get("losses")
        for name, value in records[0].get("params", {}).items():
            assert torch.equal(r["params"][name], value), name


def _shards(cfg, data, model_world):
    """{name: the number of ranks a parameter is cut over} by the port's
    layout (held to JAX's in tests/test_torch_fsdp.py)."""
    dense = LECCRModel(cfg.model, device="meta")
    paths = flax_paths(dense)
    layout = fsdp_layout(dense, data, cfg.parallel.fsdp_min_size,
                         model_world)
    return {n: ((data if layout[n] is not None else 1)
                * (model_world if partition_spec(paths[n], p.shape,
                                                 model_world) is not None
                   else 1))
            for n, p in dense.named_parameters()}


def _holds_only_shards(cfg, records, data, model_world):
    shards = _shards(cfg, data, model_world)
    dense = {n: t.numel() for n, t in records[0]["params"].items()}
    assert sum(s > 1 for s in shards.values()) > 10
    for r in records:
        for name, (numel, moments) in r["sizes"].items():
            want = dense[name] // shards[name]
            assert numel * shards[name] == dense[name], name
            assert moments == [want, want], name


def test_data2_fsdp_equals_data2_bit_for_bit(runs):
    _, dense = runs["d2_dense"]
    cfg, fsdp = runs["d2_fsdp"]
    _ranks_agree(dense)
    _ranks_agree(fsdp)
    assert fsdp[0]["sharded"] > 10 and dense[0]["sharded"] == 0
    assert fsdp[0]["losses"] == dense[0]["losses"]
    for name, value in dense[0]["params"].items():
        assert torch.equal(fsdp[0]["params"][name], value), name
    _holds_only_shards(cfg, fsdp, 2, 1)


def test_data2_model2_fsdp_equals_the_jax_trainer(runs, setup, tmp_path):
    from leccr_tpu.config import load_config as jax_load_config
    from leccr_tpu.parallel.mesh import shard_batch
    from leccr_tpu.train.trainer import Trainer as JaxTrainer

    cfg, records = runs["d2m2_fsdp"]
    _ranks_agree(records)
    _holds_only_shards(cfg, records, 2, 2)
    path = tmp_path / "config.json"
    cfg.output_dir = str(tmp_path / "jax")
    path.write_text(cfg.to_json())
    jax_tr = JaxTrainer(jax_load_config(str(path)), devices=jax.devices()[:4])
    assert dict(jax_tr.mesh.shape) == {"data": 2, "model": 2}
    state = jax_tr.state
    specs = [tuple(x.sharding.spec) for x in jax.tree.leaves(state.params)]
    assert sum("data" in s for s in specs) > 10
    dense = LECCRModel(cfg.model, device="cpu", seed=SEED)
    params = jax.device_put(params_to_jax(dense.state_dict(), cfg.model),
                            jax.tree.map(lambda x: x.sharding, state.params))
    opt_state = jax_tr.tx.init(params)
    ema, jax_losses = state.ema_params, []
    for i, batch in enumerate(setup[2]):
        params, opt_state, ema, losses = jax_tr._train_step(
            params, opt_state, ema, shard_batch(jax_tr.mesh, batch), i)
        jax_losses.append([float(losses[k]) for k in LOSS_KEYS])
    np.testing.assert_allclose(records[0]["losses"], jax_losses, rtol=2e-3,
                               atol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg.model)
    one = copy.deepcopy(cfg)
    one.parallel.model, one.parallel.fsdp = 1, False
    _, grads, _ = _one_process(one, setup[2], 2)
    _params_close(records[0]["params"],
                  {n: want[n] for n in records[0]["params"]}, grads, 1e-4)


def test_scale_composition_equals_the_dense_gather_path(runs):
    """scale_dryrun_config's recipe at data 2 × model 2 (XLM-R, remat,
    ring_fused, streaming, GradCache 2, FSDP): an epoch and an eval with
    finite losses and metrics, the epoch's losses the dense gather path's
    on the same mesh within rtol 2e-3, atol 2e-4."""
    _, scale = runs["scale"]
    _, dense = runs["scale_dense"]
    assert scale[0]["sharded"] > 10
    stats, metrics = scale[0]["stats"], scale[0]["metrics"]
    losses = {k: float(v) for k, v in stats.items() if k.startswith("loss")}
    assert losses and all(math.isfinite(v) for v in losses.values())
    assert losses["loss_itc_vs"] > 0.0
    assert all(math.isfinite(v) for v in metrics.values())
    assert metrics["sumr_sum"] > 0.0
    for r in scale[1:]:  # every rank logs the same epoch and metrics
        assert r["stats"] == stats and r["metrics"] == metrics
    for key, value in losses.items():
        np.testing.assert_allclose(value, float(dense[0]["stats"][key]),
                                   rtol=2e-3, atol=2e-4, err_msg=key)


def _checkpoint(out: Path):
    return torch.load(max((out / "checkpoints").glob("step_*.pt")),
                      weights_only=False)


def _same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_fsdp_checkpoint_is_the_dense_file_and_resumes(runs, setup,
                                                       tmp_path):
    tmp = setup[0]
    _, fit = runs["fit_fsdp"]
    assert fit[0]["sharded"] > 10
    ours, theirs = _checkpoint(tmp / "fit_fsdp"), _checkpoint(
        tmp / "fit_dense")
    for key in ("model", "optimizer", "ema"):
        assert ours[key] is not None
        _same(ours[key], theirs[key], key)
    # resumed at data 4 with FSDP: the file's state, gathered back bit for
    # bit; then a second epoch
    _, resumed = runs["resume4"]
    assert resumed[0]["sharded"] > 10
    for r in resumed:
        _same(r["restored"], ours["model"], "model")
        # the moments and step counts (the groups' lr is the new run's
        # schedule's, of 2 epochs)
        _same(r["optimizer"]["state"], ours["optimizer"]["state"],
              "optimizer")
        _same(r["ema"], ours["ema"], "ema")
        assert all(math.isfinite(float(v)) for k, v in r["stats"].items()
                   if "loss" in k)
    assert _checkpoint(tmp / "resume4")["meta"]["step"] == 2 * STEPS
    # --task export of it equals the export of the run without FSDP
    exports = []
    for run in ("fit_fsdp", "fit_dense"):
        path = tmp_path / f"{run}.pth"
        main(["--task", "export", "--output_dir", str(tmp / run),
              "--config", str(tmp / f"{run}.json"), "--export_path",
              str(path), "--device", "cpu"])
        exports.append(torch.load(path, weights_only=False))
    _same(exports[0], exports[1], "export")


@pytest.mark.slow
def test_scale_composition_at_model_4(tmp_path):
    """The JAX dry run's own shape: data 2 × model 4, 8 processes."""
    tmp = tmp_path
    out = _launch(tmp, 8, {
        "scale8": ("epoch", scale_config(tmp / "scale8", 2, 4),
                   {"evaluate": True}),
        "scale8_dense": ("epoch", scale_config(tmp / "scale8_dense", 2, 4,
                                               dense=True), {})})
    stats = out["scale8"][1][0]["stats"]
    assert math.isfinite(out["scale8"][1][0]["metrics"]["sumr_sum"])
    for key, value in stats.items():
        if key.startswith("loss"):
            np.testing.assert_allclose(
                float(value), float(out["scale8_dense"][1][0]["stats"][key]),
                rtol=2e-3, atol=2e-4, err_msg=key)


@pytest.mark.parametrize("devices", [
    2, pytest.param(4, marks=pytest.mark.slow)])
def test_cli_devices_fsdp_trains_evaluates_and_checkpoints(tmp_path,
                                                           devices):
    """`python -m leccr_torch.run --device cpu --devices N` with
    `parallel.fsdp` at data 2 × model N / 2 (configs/tiny_synth.yaml at
    ViT width 128, every dropout at 0, the floor at 1): one epoch, an eval
    and a checkpoint in the dense format, whose weights give the logged
    eval metrics in a one-process Trainer.  N = 4 launches 4 ranks beside
    the launcher: slow."""
    from test_torch_tensor_parallel_run import _metrics_of_weights, _run

    cfg = load_config(str(ROOT / "configs" / "tiny_synth.yaml"))
    cfg.parallel.data, cfg.parallel.model = -1, devices // 2
    cfg.parallel.fsdp, cfg.parallel.fsdp_min_size = True, 1
    cfg.model.vision.width = 128
    cfg.model.dropout = 0.0
    cfg.model.text.hidden_dropout = cfg.model.text.attention_dropout = 0.0
    cfg.data.synthetic_size = 8
    cfg.data.synthetic_captions_per_image = 2
    cfg.train.schedular.epochs = 1
    config = tmp_path / "config.json"
    cfg.save(str(config))
    out = tmp_path / "run"
    stdout = _run(["--task", "itr_caption", "--config", config,
                   "--output_dir", out, "--device", "cpu", "--devices",
                   str(devices)])
    assert ("2 ranks" if devices == 2 else "2 data × 2 model ranks") in stdout
    state = _checkpoint(out)
    dense = LECCRModel(cfg.model, device="cpu")
    dense.load_state_dict(state["model"])  # strict: the dense shapes
    records = [json.loads(x) for x in (out / "log.txt").read_text().split(
        "\n") if x]
    want = _metrics_of_weights(str(config), state["model"], tmp_path / "one")
    assert want == {k: v for k, v in records[0].items() if k in want}
