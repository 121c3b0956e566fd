"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
import shutil

import pytest
import yaml

from benchmark.run import ROOT, cell_files, cell_metrics, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return load_manifest()


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == TOP_KEYS
    assert manifest["command"] == ["python3", "-m", "benchmark.run"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_text_fields(manifest):
    names = ([c["name"] for c in manifest["configs"]]
             + [w["name"] for w in manifest["workloads"]]
             + [m["name"] for m in manifest["end_to_end"]]
             + [m["name"] for m in manifest["per_layer"]])
    for name in names:
        assert NAME.match(name), name
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in manifest["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in manifest["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert len(set(names)) == len(names)


def test_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_must(manifest):
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in cell_metrics(manifest, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell_metrics(manifest, w["name"], True), w["name"]


def test_per_layer_cells_report_the_metric_they_move(manifest):
    for m in manifest["per_layer"]:
        for cell in m["workloads"]:
            moved = {e["name"] for e in cell_metrics(manifest, cell, False)}
            assert m["moves"] in moved, (m["name"], cell)


def test_layers_agree_letter_for_letter(manifest):
    layers = {m["layer"] for m in manifest["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def test_named_files_exist_and_configs_state_their_cuts(manifest):
    for w in manifest["workloads"]:
        files = cell_files(manifest, w["name"])
        kind = ROOT / "benchmark" / "kinds" / f"{files['mix']['kind']}.py"
        assert kind.exists(), kind
        assert set(files["limits"]["limits"])
    for c in manifest["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(ROOT / "benchmark")
        meta = yaml.safe_load(path.read_text())
        assert set(meta["reduced"]) == set(c["reduced"])
        assert meta["source"] == c["source"]
    for m in manifest["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


def test_a_full_check_fits_the_driver_budget(manifest):
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (manifest["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_a_cell_is_added_by_new_files_alone(tmp_path, tiny):
    """A new cell with its own mix, limits and per-layer metric, in a copy
    of the benchmark: new files and manifest entries, no edited file."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = load_manifest()
    (root / "benchmark" / "traffic" / "eval_small.json").write_text(
        json.dumps({"kind": "eval", "images": 6, "captions_per_image": 2,
                    "caption_tokens": [3, 10], "text_tokens": [2, 6]}))
    (root / "benchmark" / "limits" / "flagship.eval_small.json").write_text(
        json.dumps({"limits": {"image_feat_gap": 1e-3, "text_feat_gap": 1e-3,
                               "rank_mismatches": 0,
                               "metric_mismatches": 0}}))
    (root / "benchmark" / "metrics" / "texts_per_eval.py").write_text(
        "def read(run):\n    return float(len(run.driver.split['text_ids']))\n")
    manifest["workloads"].append({"name": "flagship.eval_small",
                                  "config": "flagship",
                                  "traffic": "eval_small", "chips": 1,
                                  "why": "a throwaway cell"})
    for m in manifest["end_to_end"]:
        if m["name"] == "eval_s":
            m["workloads"].append("flagship.eval_small")
    manifest["per_layer"].append({
        "name": "texts_per_eval", "unit": "texts", "better": "higher",
        "source": "program_counter", "layer": "model forward",
        "moves": "eval_s", "workloads": ["flagship.eval_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    from benchmark.run import run_cell

    cfg, meta = tiny
    result = run_cell("flagship.eval_small", 5, 0.2, False, device="cpu",
                      root=root, cfg_override=cfg, meta_override=meta,
                      watchdog=False)
    assert result["correct"] and set(result["metrics"]) == {"eval_s",
                                                            "setup_s"}
    assert list(result)[-1] == "checks"
    from benchmark.run import Run, read_metric

    class Driver:
        split = {"text_ids": [0] * 12}
        arch = cfg = trace = None

    assert read_metric("texts_per_eval", Run(Driver()), root) == 12.0



# A kind the harness has never seen, as its own file: embed texts in turns
# and hold the features to the reference's.
NEW_KIND = '''
import time

import torch

from benchmark import drivers, generator
from benchmark.reference.model import Model
from benchmark.weights import stream_seed

TEST_SIZE = {"texts": 4}
FAULTS = ()


def inputs(mix, cfg, seed, device):
    host = __import__("numpy").random.default_rng(stream_seed(seed, 9))
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 10))
    lens = generator.lengths(host, mix["text_tokens"], mix["texts"])
    ids, mask = generator.tokens(g, lens, mix["width"],
                                 cfg.model.text.vocab_size, device)
    return [{"ids": ids, "mask": mask}]


class Driver(drivers.Driver):
    program_state = ("model",)

    def setup(self):
        self.model = self._model()
        self.texts = inputs(self.mix, self.cfg, self.seed, self.device)[0]
        self.model.embed_texts(self.texts["ids"], self.texts["mask"])

    def window(self, seconds, traced):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.out = self.model.embed_texts(self.texts["ids"],
                                              self.texts["mask"])
            n += 1
        self.attempted = n
        return {"texts_per_s": n * len(self.out) / (time.perf_counter() - t0)}

    def check(self):
        want = Model(self._weights(), self.arch).embed_texts(
            self.texts["ids"], self.texts["mask"])
        gap = float(torch.linalg.vector_norm(self.out - want, dim=1).max())
        return {"text_feat_gap": (gap, "worst text row")}
'''


def test_a_new_kind_is_added_by_new_files_alone(tmp_path, tiny):
    """A kind of traffic the harness does not have (its input maker and
    driver in benchmark/kinds/<kind>.py), a mix, a cell, limits and an
    end-to-end metric, in a copy of the benchmark: new files and manifest
    entries, no edited file."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    (root / "benchmark" / "kinds" / "texts.py").write_text(NEW_KIND)
    (root / "benchmark" / "traffic" / "texts_small.json").write_text(
        json.dumps({"kind": "texts", "texts": 5, "width": 16,
                    "text_tokens": [3, 12]}))
    (root / "benchmark" / "limits" / "flagship.texts.json").write_text(
        json.dumps({"limits": {"text_feat_gap": 1e-4}}))
    manifest = load_manifest()
    manifest["workloads"].append({"name": "flagship.texts",
                                  "config": "flagship",
                                  "traffic": "texts_small", "chips": 1,
                                  "why": "a throwaway cell of a new kind"})
    manifest["end_to_end"].append({
        "name": "texts_per_s", "unit": "texts/s", "better": "higher",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["flagship.texts"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    from benchmark.run import run_cell

    cfg, meta = tiny
    result = run_cell("flagship.texts", 5, 0.2, False, device="cpu",
                      root=root, cfg_override=cfg, meta_override=meta,
                      watchdog=False)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"texts_per_s", "setup_s"}
    assert result["attempted"] >= 1
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())
