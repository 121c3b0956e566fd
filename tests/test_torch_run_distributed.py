"""`python -m leccr_torch.run`'s data-parallel options on the CPU:
--devices N spawns N gloo processes of the task (each a --multihost rank
of torchrun's environment), --multihost needs that environment, and
--devices above the host's GPUs raises.  Every child has a time limit."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from leccr_torch import run
from leccr_torch.config import load_config

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300


def test_cli_two_gloo_processes_train_one_step(tmp_path):
    """configs/tiny_synth.yaml at 4 images x 2 captions, bs8: one step an
    epoch, over two processes of 4 rows; eval, checkpoint, log once."""
    cfg = load_config(str(ROOT / "configs" / "tiny_synth.yaml"))
    cfg.parallel.data = -1
    cfg.data.synthetic_size = 4
    cfg.data.synthetic_captions_per_image = 2
    cfg.train.schedular.epochs = 1
    cfg.save(str(tmp_path / "config.json"))
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "leccr_torch.run", "--task", "itr_caption",
         "--config", str(tmp_path / "config.json"), "--output_dir",
         str(out), "--device", "cpu", "--devices", "2"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=TIMEOUT_S,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "batch size 8, device cpu, 2 ranks" in proc.stdout
    assert proc.stdout.count("### Total Params") == 1  # rank 0 prints
    records = [json.loads(x) for x in (out / "log.txt").read_text().split(
        "\n") if x]
    assert [r.get("epoch") for r in records] == [0, None]
    assert "de_test_sumr_sum" in records[0]
    assert list((out / "checkpoints").glob("step_00000001.pt"))
    assert (out / ".synthetic.rank1").is_dir()  # no shared writes


def test_cli_more_devices_than_the_host_has_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--devices 3 asks for 3 GPUs; "
                                         "this host has 2"):
        run.main(["--config", str(ROOT / "configs" / "tiny_synth.yaml"),
                  "--output_dir", str(tmp_path), "--devices", "3"])


def test_cli_devices_and_serving_layouts(monkeypatch):
    """--devices 0 is every local GPU (one CPU process with --device cpu);
    a serving index shards over the first N devices."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = run.parse_args(["--devices", "0"])
    assert run.local_devices(args) == 4
    assert run.serving_devices(args, 2) == ["cuda:0", "cuda:1"]
    args = run.parse_args(["--devices", "0", "--device", "cpu"])
    assert run.local_devices(args) == 1
    assert run.serving_devices(args, 1) is None
    args = run.parse_args(["--devices", "3", "--device", "cpu"])
    assert run.local_devices(args) == 3
    assert run.serving_devices(args, 3) == ["cpu"] * 3


def test_cli_multihost_needs_torchrun_environment(tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        run.main(["--config", str(ROOT / "configs" / "tiny_synth.yaml"),
                  "--output_dir", str(tmp_path), "--device", "cpu",
                  "--multihost"])
    with pytest.raises(ValueError, match="training tasks"):
        run.main(["--task", "serve", "--output_dir", str(tmp_path),
                  "--device", "cpu", "--multihost"])
