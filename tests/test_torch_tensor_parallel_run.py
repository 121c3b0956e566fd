"""`python -m leccr_torch.run --device cpu --devices 4` with
`parallel.model: 2` (data 2 × model 2 gloo processes): configs/
tiny_synth.yaml at ViT width 128 (2 heads), 8 images × 2 captions, bs8,
every dropout at 0.

The first run trains one epoch (2 steps), evaluates and writes a
checkpoint; the second loads it as an initial checkpoint (--checkpoint),
resumes it with --resume and trains a second epoch.  Each writes the dense checkpoint (parameters and Adam moments at
the one-process shapes), which a one-process model loads strictly and
`--task export` exports; each run's logged eval metrics equal the
one-process Trainer's on the checkpoint's weights.  Every child has a
time limit."""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from leccr_torch.config import load_config
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.weights import export_reference_state_dict
from leccr_torch.run import main
from leccr_torch.train import trainer as port_trainer

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300


def _run(args, cwd=ROOT):
    proc = subprocess.run(
        [sys.executable, "-m", "leccr_torch.run", *map(str, args)],
        cwd=str(cwd), capture_output=True, text=True, timeout=TIMEOUT_S,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _metrics_of_weights(cfg, state, out):
    """The one-process Trainer's test metrics on `state`'s weights."""
    cfg = load_config(cfg)
    cfg.parallel.model = 1
    cfg.output_dir = str(out)
    trainer = port_trainer.Trainer(cfg, device="cpu")
    trainer.state.model.load_state_dict(state)
    lang = next(iter(trainer.test_ds))
    metrics = trainer.evaluate(trainer.test_ds[lang])
    return {f"{lang}_test_{k}": v for k, v in metrics.items()}


def test_cli_data2_model2_trains_evaluates_checkpoints_and_resumes(tmp_path):
    cfg = load_config(str(ROOT / "configs" / "tiny_synth.yaml"))
    cfg.parallel.data, cfg.parallel.model = -1, 2
    cfg.model.vision.width = 128
    cfg.model.dropout = 0.0
    cfg.model.text.hidden_dropout = cfg.model.text.attention_dropout = 0.0
    cfg.data.synthetic_size = 8
    cfg.data.synthetic_captions_per_image = 2
    cfg.train.schedular.epochs = 1
    config = tmp_path / "config.json"
    cfg.save(str(config))
    out = tmp_path / "run"
    args = ["--task", "itr_caption", "--config", config, "--output_dir", out,
            "--device", "cpu", "--devices", "4"]
    stdout = _run(args)
    assert "batch size 8, device cpu, 2 data × 2 model ranks" in stdout
    assert stdout.count("### Total Params") == 1  # rank 0 prints
    first = out / "checkpoints" / "step_00000002.pt"
    # an initial checkpoint loads into the sharded model too (the resume
    # then restores the same weights and the optimizer)
    stdout = _run(args + ["--resume", "--epoch", "2", "--checkpoint", first])
    assert f"### loaded initial checkpoint from {first}" in stdout
    assert "### resumed from step 2, epoch 1" in stdout
    records = [json.loads(x) for x in (out / "log.txt").read_text().split(
        "\n") if x]
    epochs = [r for r in records if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]

    dense = LECCRModel(cfg.model, device="cpu")
    shapes = {n: t.shape for n, t in dense.state_dict().items()}
    for epoch, step in ((0, 2), (1, 4)):
        ckpt = out / "checkpoints" / f"step_{step:08d}.pt"
        if not ckpt.exists():  # rotation keeps the newest two
            continue
        state = torch.load(ckpt, weights_only=False)
        assert {n: t.shape for n, t in state["model"].items()} == shapes
        params = dict(dense.named_parameters())
        names = [n for g in dense_groups(cfg, dense) for n in g]
        for idx, entry in state["optimizer"]["state"].items():
            for value in entry.values():
                if isinstance(value, torch.Tensor) and value.dim() > 0:
                    assert value.shape == params[names[idx]].shape
        dense.load_state_dict(state["model"])  # strict
        want = _metrics_of_weights(str(config), state["model"],
                                   tmp_path / f"one{epoch}")
        assert want == {k: v for k, v in epochs[epoch].items()
                        if k in want}
    # the checkpoint exports as a one-process one does
    main(["--task", "export", "--checkpoint", str(ckpt), "--config",
          str(config), "--export_path", str(tmp_path / "ref.pth"),
          "--device", "cpu"])
    exported = torch.load(tmp_path / "ref.pth", weights_only=False)
    want = export_reference_state_dict(dense)
    assert set(exported) == set(want)
    for name, value in want.items():
        assert torch.equal(exported[name], value), name


def dense_groups(cfg, model):
    """The optimizer's parameter names per group, in its state_dict's
    index order (a one-process model's)."""
    from leccr_torch.train.step import make_train_step

    cfg = copy.deepcopy(cfg)
    cfg.parallel.model = 1
    step = make_train_step(cfg, model, 1)
    names = {id(p): n for n, p in model.named_parameters()}
    return [[names[id(p)] for p in g["params"]]
            for g in step.optimizer.param_groups]
