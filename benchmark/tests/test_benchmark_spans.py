"""The readers of the program's spans (`benchmark/metrics/_spans.py` and
the 15 metrics on it) against a span store filled as a `--trace 1` run
fills it: a slice of 3 steps that records the device alone, then one step
that records the host (train), or two evals in the same order (eval).

The device's clock is a stand-in here: each span's markers read a counter
that the test moves inside the span, so every phase has a known device
time, and the host step differs from the measured ones."""

import sys
import types
import warnings

import pytest

from benchmark.run import Run, load_manifest, read_metric
from leccr_torch.utils import tracing

TRAIN = {"forward_ms.train": "train.forward", "loss_ms.train": "train.loss",
         "backward_ms.train": "train.backward",
         "optimizer_ms.train": "train.optimizer"}
TRAIN_HOST = {"forward_host_ms.train": "train.forward",
              "loss_host_ms.train": "train.loss",
              "backward_host_ms.train": "train.backward",
              "optimizer_host_ms.train": "train.optimizer"}
EVAL = {"vision_ms.eval": "model.vision", "caption_ms.eval": "model.caption",
        "interaction_ms.eval": "model.interact", "text_ms.eval": "model.text",
        "rank_ms.eval": "eval.rank"}
# device ms of each span of a measured step, and the host step's
STEP_MS = {"train.forward": 40.0, "train.loss": 3.0, "train.backward": 90.0,
           "train.optimizer": 20.0, "model.vision": 10.0,
           "model.caption": 5.0, "model.interact": 2.0, "model.text": 8.0}
HOST_STEP_FACTOR = 7.0


class Clock:
    now = 0.0


class Event:
    def __init__(self):
        self.t = None

    def record(self, stream=None):
        self.t = Clock.now

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def store(monkeypatch):
    """The program's store, with stand-in device markers and sync mode."""
    monkeypatch.setattr(tracing, "_cuda_timing", lambda: True)
    monkeypatch.setattr(tracing, "_take_events", lambda: (Event(), Event()))
    monkeypatch.setattr(tracing, "_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(tracing, "_set_sync_debug_mode", lambda mode: None)
    tracing.reset()
    yield tracing
    tracing.reset()


def _work(name: str, scale: float = 1.0, syncs: int = 0):
    Clock.now += STEP_MS[name] * scale
    for _ in range(syncs):
        warnings.warn("called a synchronizing CUDA operation")


def _step(scale: float, syncs: int, microbatches: int = 1):
    """One step's spans in the program's tree; `microbatches` forwards
    and backwards, as GradCache takes them."""
    with tracing.span("train.step"):
        for _ in range(microbatches):
            with tracing.span("train.forward"):
                for tower in ("model.vision", "model.caption",
                              "model.interact", "model.text"):
                    with tracing.span(tower):
                        _work(tower, scale)
                _work("train.forward", scale)
        with tracing.span("train.loss"):
            _work("train.loss", scale)
        for _ in range(microbatches):
            with tracing.span("train.backward"):
                _work("train.backward", scale)
        with tracing.span("train.optimizer"):
            _work("train.optimizer", scale, syncs)


def _eval(scale: float, rank_syncs: int):
    for _ in range(3):
        with tracing.span("model.text"):
            _work("model.text", scale)
    for _ in range(2):
        for tower in ("model.vision", "model.caption", "model.interact"):
            with tracing.span(tower):
                _work(tower, scale)
    with tracing.span("eval.rank"):
        Clock.now += 4.0 * scale
        _work("model.text", 0.0, rank_syncs)


def _run(trace_steps: int = 3):
    driver = types.SimpleNamespace(mix={"trace_steps": trace_steps},
                                   arch=None, cfg=None, trace={})
    return Run(driver)


def _train_slices(microbatches: int = 1):
    with tracing.record():
        for _ in range(3):
            _step(1.0, syncs=1, microbatches=microbatches)
        _step(HOST_STEP_FACTOR, syncs=5, microbatches=microbatches)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_readers_read_the_device_slice_alone(store, microbatches):
    _train_slices(microbatches)
    run = _run()
    inner = {"train.forward": sum(STEP_MS[t] for t in (
        "model.vision", "model.caption", "model.interact", "model.text"))}
    for metric, span in TRAIN.items():
        want = (STEP_MS[span] + inner.get(span, 0.0)) * (
            1 if span in ("train.loss", "train.optimizer") else microbatches)
        assert read_metric(metric, run) == pytest.approx(want), metric
    roots = [s for s in tracing.spans() if s.parent is None][:3]
    for metric, span in TRAIN_HOST.items():
        want = sum(s.host_ms for s in tracing.spans()
                   if s.name == span and s.root in {r.id for r in roots}) / 3
        assert read_metric(metric, run) == pytest.approx(want), metric
    assert read_metric("host_syncs.train", run) == 1.0


def test_eval_readers_read_the_first_eval_alone(store):
    with tracing.record():
        _eval(1.0, rank_syncs=2)
        _eval(HOST_STEP_FACTOR, rank_syncs=9)
    run = _run()
    want = {"model.text": 3 * STEP_MS["model.text"],
            "model.vision": 2 * STEP_MS["model.vision"],
            "model.caption": 2 * STEP_MS["model.caption"],
            "model.interact": 2 * STEP_MS["model.interact"],
            "eval.rank": 4.0}
    for metric, span in EVAL.items():
        assert read_metric(metric, run) == pytest.approx(want[span]), metric
    assert read_metric("host_syncs.eval", run) == 2.0


ALL = list(TRAIN) + list(TRAIN_HOST) + ["host_syncs.train"] + list(EVAL) + [
    "host_syncs.eval"]


def test_readers_give_none_where_spans_were_dropped(store, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 30)
    _train_slices()
    with tracing.record():
        _eval(1.0, rank_syncs=2)
    assert tracing.counters()["dropped"] > 0
    for metric in ALL:
        assert read_metric(metric, _run()) is None, metric


def test_readers_give_none_without_device_time_or_units(monkeypatch):
    tracing.reset()
    with tracing.record():  # CPU: no device markers
        for _ in range(4):
            _step(1.0, syncs=0)
        _eval(1.0, rank_syncs=0)
    for metric in ALL:
        assert read_metric(metric, _run()) is None, metric
    tracing.reset()
    for metric in ALL:  # an empty store: nothing traced
        assert read_metric(metric, _run()) is None, metric
    # a program without the span store (the readers' parent checkout)
    monkeypatch.setitem(sys.modules, "leccr_torch.utils.tracing", None)
    for metric in ALL:
        assert read_metric(metric, _run()) is None, metric


def test_too_few_steps_read_none(store):
    with tracing.record():
        _step(1.0, syncs=0)
        _step(1.0, syncs=0)
    for metric in list(TRAIN) + list(TRAIN_HOST) + ["host_syncs.train"]:
        assert read_metric(metric, _run()) is None, metric


def test_the_manifest_holds_the_span_metrics():
    per_layer = {m["name"]: m for m in load_manifest()["per_layer"]}
    train_cells = ["flagship.train", "scale_vitl14.train"]
    for name in list(TRAIN) + list(TRAIN_HOST):
        m = per_layer[name]
        assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
            "ms", "program_span", "train_pairs_per_s", train_cells), name
        assert m["layer"] == "model step (models.leccr, towers, train.optim)"
    for name in EVAL:
        m = per_layer[name]
        assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
            "ms", "program_span", "eval_s", ["flagship.eval"]), name
        assert m["layer"] == ("model forward (LECCRModel.embed_images, "
                              "embed_texts)")
    for name, cells in (("host_syncs.train", train_cells),
                        ("host_syncs.eval", ["flagship.eval"])):
        m = per_layer[name]
        assert (m["unit"], m["source"], m["workloads"]) == (
            "syncs", "program_counter", cells), name
        assert m["layer"] == "step driver (train.step.TrainStep.run)"
