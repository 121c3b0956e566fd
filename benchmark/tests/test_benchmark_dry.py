"""The harness's CPU dry mode: a whole run of each cell at
configs/tiny_synth.yaml's widths with the cell's own limits, `correct`
false under each fault the cell can have, and the command line's refusal
to run a cell without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.drivers import load_kind
from benchmark.run import ROOT, run_cell


def _run(cell, tiny, seed=2 ** 31 + 99, root=ROOT, trace=False):
    cfg, meta = tiny
    return run_cell(cell, seed, 0.3, trace, device="cpu", cfg_override=cfg,
                    meta_override=meta, watchdog=False, root=root)


@pytest.mark.parametrize("cell", ["flagship.train", "scale_vitl14.train",
                                  "flagship.eval"])
def test_a_sound_run_is_correct(cell, tiny):
    result = _run(cell, tiny)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    result = _run("flagship.train", tiny)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(tiny):
    with load_kind("train").half_batch():
        result = _run("flagship.train", tiny)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"]


def test_weight_decay_dropped_is_caught(tiny):
    with load_kind("train").decay_dropped():
        result = _run("flagship.train", tiny)
    assert not result["correct"]
    assert result["checks"]["optimizer_mismatches"]["value"] >= 1


def test_a_schedule_off_the_configuration_is_caught(tiny, monkeypatch):
    from leccr_torch.train import step

    original = step.linear_warmup_decay

    def doubled(*args, **kwargs):
        at = original(*args, **kwargs)
        return lambda k: 2.0 * at(k)
    monkeypatch.setattr(step, "linear_warmup_decay", doubled)
    result = _run("flagship.train", tiny)
    assert not result["correct"]
    assert result["checks"]["optimizer_mismatches"]["value"] >= 1


def test_a_step_after_the_window_that_goes_wrong_is_caught(tiny,
                                                           monkeypatch):
    """The window's call changes path once set-up is over: its steps are
    held to the reference too, through the step taken after the window."""
    from leccr_torch.train import step

    original = step.TrainStep.run

    def late_fault(self, batch, step_no):
        if step_no >= 4:
            batch = dict(batch, text_ids_t=batch["text_ids_s"],
                         text_mask_t=batch["text_mask_s"])
        return original(self, batch, step_no)
    monkeypatch.setattr(step.TrainStep, "run", late_fault)
    result = _run("flagship.train", tiny)
    assert not result["correct"]
    assert "after the window" in result["checks"]["loss_gap"]["of"]


def test_an_altered_answer_is_caught(tiny):
    with load_kind("eval").altered_answer():
        result = _run("flagship.eval", tiny)
    assert not result["correct"]
    assert (result["checks"]["text_feat_gap"]["value"]
            > result["checks"]["text_feat_gap"]["limit"])


def test_an_altered_rank_is_caught(tiny, monkeypatch):
    from leccr_torch.eval import retrieval

    original = retrieval.retrieval_ranks

    def off_by_one(*args, **kwargs):
        i2t, t2i = original(*args, **kwargs)
        return i2t, t2i + (t2i == t2i.min())
    monkeypatch.setattr(retrieval, "retrieval_ranks", off_by_one)
    result = _run("flagship.eval", tiny)
    assert not result["correct"]
    assert result["checks"]["rank_mismatches"]["value"] >= 1


def test_the_command_line_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown here")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "flagship.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_command_line_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "flagship.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "flagship.train", "--seed", "4242", "--seconds", "3", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_the_main_thread_takes_a_cpu_of_its_own():
    """Threads made before the window keep off the last CPU, which the
    main thread takes alone once the window opens."""
    code = (
        "import os, threading\n"
        "from benchmark.run import Host\n"
        "cpus = sorted(os.sched_getaffinity(0))\n"
        "host = Host()\n"
        "seen = []\n"
        "t = threading.Thread(target=lambda: seen.append(\n"
        "    sorted(os.sched_getaffinity(0))))\n"
        "t.start(); t.join()\n"
        "host.open()\n"
        "print(cpus, seen[0], sorted(os.sched_getaffinity(0)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    cpus, helpers, main = json.loads("[" + proc.stdout.replace("] [", "], [")
                                     + "]")
    if len(cpus) < 3:
        pytest.skip("fewer than 3 CPUs: nothing to pin")
    assert helpers == cpus[:-1] and main == cpus[-1:]
