"""`leccr_torch.run`'s serving tasks on the tiny synthetic config, on the
CPU: build_index (f32, int8, IVF), update_index (remove, add_new,
ivf_recall) in this process, and `python -m leccr_torch.run --task serve`
in a child process answering /healthz, /search and /stats until SIGINT.
The saves load in the JAX package too.  A child process has a killer
timer, and every read and request a timeout."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from leccr_torch.run import main
from leccr_torch.serve import load_index
from leccr_torch.serve_ann import load_ivf

ROOT = Path(__file__).resolve().parent.parent
CONFIG = str(ROOT / "configs" / "tiny_synth.yaml")
WAIT = 30


def _cli(tmp_path, task, *args):
    main(["--task", task, "--config", CONFIG, "--output_dir",
          str(tmp_path / "run"), "--serve_bs", "4", "--device", "cpu",
          *args])


@pytest.mark.parametrize("kind", ["f32", "int8", "ivf"])
def test_build_index(tmp_path, capsys, kind):
    d = tmp_path / "index"
    flags = {"f32": [], "int8": ["--int8"],
             "ivf": ["--ivf", "--ivf_clusters", "3", "--ivf_recall", "0.9"]}
    _cli(tmp_path, "build_index", "--index", str(d), *flags[kind])
    out = capsys.readouterr().out
    if kind == "ivf":
        assert "### calibrated nprobe=" in out
        assert "### built IVF index: 8 items, C=3" in out
        ivf = load_ivf(str(d), "cpu")
        assert ivf.default_nprobe in (1, 2, 3) and ivf.n_valid == 8
        return
    assert "### built index: 8 items" + (" (int8)" if kind == "int8"
                                         else "") in out
    index = load_index(str(d), "cpu")
    assert index.n_valid == 8 and index.quantized == (kind == "int8")
    assert index.slots.shape[:2] == (8, 4)
    # the JAX package serves the same save
    from leccr_tpu.serve import load_index as jax_load_index

    back = jax_load_index(str(d))
    assert back.ids == index.ids
    np.testing.assert_array_equal(np.asarray(back.feats),
                                  index.feats.numpy())


@pytest.mark.parametrize("kind", ["int8", "ivf"])
def test_update_index_removes_and_adds(tmp_path, capsys, kind):
    """Drop two items, then --add_new embeds only those two back; the
    int8 rows that stayed keep their bytes, the IVF bank every row once."""
    d = tmp_path / "index"
    build = ["--int8"] if kind == "int8" else ["--ivf", "--ivf_clusters",
                                               "3"]
    _cli(tmp_path, "build_index", "--index", str(d), *build)
    before = (load_index if kind == "int8" else load_ivf)(str(d), "cpu")
    ids = before.ids
    _cli(tmp_path, "update_index", "--index", str(d), "--remove_ids",
         ",".join(ids[:2]))
    extra = ["--ivf_recall", "0.9"] if kind == "ivf" else []
    _cli(tmp_path, "update_index", "--index", str(d), "--add_new", *extra)
    out = capsys.readouterr().out
    assert "### updated index: 8 -> 6 items (+0 -2)" in out
    assert "### updated index: 6 -> 8 items (+2 -0)" in out
    if kind == "int8":
        after = load_index(str(d), "cpu")
        assert sorted(after.ids) == sorted(ids) and after.quantized
        assert after.ids[:6] == ids[2:]
        for name in ("feats", "slots", "scale", "slot_scale"):
            assert torch.equal(getattr(after, name)[:6],
                               getattr(before, name)[2:])
        return
    assert out.count("### recalibrated nprobe=") == 1
    after = load_ivf(str(d), "cpu")
    assert sorted(after.ids) == sorted(ids)
    placed = after.rows[after.valid]
    assert int(after.valid.sum()) == 8
    assert torch.equal(placed.sort().values, torch.arange(8,
                                                          dtype=torch.int32))


def test_update_index_rejects_bad_requests(tmp_path):
    d = tmp_path / "index"
    _cli(tmp_path, "build_index", "--index", str(d))
    with pytest.raises(SystemExit, match="needs --remove_ids"):
        _cli(tmp_path, "update_index", "--index", str(d))
    with pytest.raises(SystemExit, match="IVF indexes only"):
        _cli(tmp_path, "update_index", "--index", str(d), "--ivf_recall",
             "0.9")
    with pytest.raises(SystemExit, match="requires --index"):
        _cli(tmp_path, "build_index")
    with pytest.raises(ValueError, match="unknown ids"):
        _cli(tmp_path, "update_index", "--index", str(d), "--remove_ids",
             "nope")


def _request(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("kind", ["int8", "ivf", "sharded"])
def test_serve_answers_over_http_until_sigint(tmp_path, kind):
    """"sharded": the f32 save served with --devices 2, the index
    row-sharded over two (CPU) devices."""
    d = tmp_path / "index"
    build = {"int8": ["--int8"], "ivf": ["--ivf", "--ivf_clusters", "3"],
             "sharded": []}[kind]
    _cli(tmp_path, "build_index", "--index", str(d), *build)
    proc = subprocess.Popen(
        [sys.executable, "-m", "leccr_torch.run", "--task", "serve",
         "--config", CONFIG, "--output_dir", str(tmp_path / "run"),
         "--index", str(d), "--port", "0", "--serve_bs", "4", "--device",
         "cpu", *(["--devices", "2"] if kind == "sharded" else [])],
        cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    killer = threading.Timer(120, proc.kill)
    killer.start()
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout]
                     + [lines.put(None)], daemon=True).start()
    seen = []
    try:
        while not seen or not seen[-1].startswith("### serving on "):
            line = lines.get(timeout=60)
            assert line is not None, "server never came up:\n" + "".join(
                seen)
            seen.append(line)
        base = seen[-1].split()[3]
        assert any(line.startswith({
            "ivf": "### IVF index:", "int8": "### index: 8 items (int8)",
            "sharded": "### index: 8 items, sharded over 2 devices"}[kind])
            for line in seen)
        assert _request(base + "/healthz") == {"ok": True, "index_size": 8}
        body = {"queries": ["a red dog", "field"], "k": 3}
        if kind == "ivf":
            body["nprobe"] = 3
        hits = _request(base + "/search", body)["results"]
        assert [len(r) for r in hits] == [3, 3]
        for row in hits:
            scores = [s for _, s in row]
            assert scores == sorted(scores, reverse=True)
        if kind == "ivf":  # no slot bank: a client error, not a hang
            with pytest.raises(urllib.error.HTTPError) as ei:
                _request(base + "/search", {"queries": ["a"],
                                            "fusion": "minmax"})
            assert ei.value.code == 400
        stats = _request(base + "/stats")
        assert stats["dispatches"] >= 2 and stats["requests"] >= 2
        assert stats["errors"] == (1 if kind == "ivf" else 0)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT) == 0
        assert time.monotonic() - t0 < WAIT
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
