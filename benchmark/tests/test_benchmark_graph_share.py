"""The readers of `graph_share.train` and `reserved_bytes.train` against a
span store filled as a `--trace 1` run fills it (a slice of 3 steps that
records the device alone, then one that records the host), with steps
whose phases replay CUDA graphs (a `train.graph` span inside each phase's
span) and steps that run eagerly.  The device's clock is the stand-in of
test_benchmark_spans, and so is the allocator's reserved memory."""

import sys

import pytest

from benchmark.run import load_manifest, read_metric
from benchmark.tests.test_benchmark_spans import _run, store  # noqa: F401
from leccr_torch.utils import tracing

PHASES = ("train.forward", "train.loss", "train.backward", "train.optimizer")


def _step(replayed=PHASES):
    """One step's spans: each phase, with a replay inside where named."""
    with tracing.span("train.step"):
        for phase in PHASES:
            with tracing.span(phase):
                if phase in replayed:
                    with tracing.span("train.graph"):
                        pass


@pytest.mark.parametrize("measured,want", [
    ([PHASES] * 3, 100.0),
    ([PHASES, (), PHASES], 200.0 / 3),
    ([(), (), ()], 0.0),
    ([PHASES[:3], PHASES, PHASES[1:]], 100.0 / 3),
])
def test_graph_share_reads_the_device_slice_alone(store, measured, want):
    with tracing.record():
        for replayed in measured:
            _step(replayed)
        _step(())  # the slice that records the host
    assert read_metric("graph_share.train", _run()) == pytest.approx(want)


def test_graph_share_needs_whole_steps_and_a_store(store, monkeypatch):
    with tracing.record():
        _step()
        _step()
    assert read_metric("graph_share.train", _run()) is None  # 2 of 3 steps
    tracing.reset()
    with tracing.record():
        for _ in range(4):
            _step()
    assert read_metric("graph_share.train", _run()) == 100.0
    # a program without the counter, as the parent checkout's
    from leccr_torch.train import step

    monkeypatch.delattr(step.TrainStep, "graph_replays")
    assert read_metric("graph_share.train", _run()) is None
    monkeypatch.setitem(sys.modules, "leccr_torch.utils.tracing", None)
    assert read_metric("graph_share.train", _run()) is None


def test_the_manifest_holds_graph_share():
    m = {m["name"]: m for m in load_manifest()["per_layer"]}[
        "graph_share.train"]
    assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
        "%", "program_span", "train_pairs_per_s",
        ["flagship.train", "scale_vitl14.train"])
    assert m["layer"] == "step driver (train.step.TrainStep.run)"


@pytest.mark.parametrize("reserved,want", [
    ([30, 30, 30, 99], 30), ([10, 24, 20, 5], 24), ([7, 8, 9, 9], 9)])
def test_reserved_bytes_is_the_device_slice_most(store, monkeypatch,
                                                 reserved, want):
    held = iter(reserved)
    monkeypatch.setattr(tracing, "_reserved_bytes", lambda: next(held))
    with tracing.record():
        for _ in range(4):
            _step()
    assert [s.reserved_bytes for s in tracing.spans()
            if s.name == "train.step"] == reserved
    assert all(s.reserved_bytes is None for s in tracing.spans()
               if s.parent is not None)
    assert read_metric("reserved_bytes.train", _run()) == want


def test_reserved_bytes_needs_the_reading(store, monkeypatch):
    monkeypatch.setattr(tracing, "_reserved_bytes", lambda: 5)
    with tracing.record():
        for _ in range(2):
            _step()
    assert read_metric("reserved_bytes.train", _run()) is None  # 2 of 3
    with tracing.record():
        _step()
    assert read_metric("reserved_bytes.train", _run()) == 5
    # spans without the reading, as the parent checkout's
    for s in tracing.spans():
        s.reserved_bytes = None
    assert read_metric("reserved_bytes.train", _run()) is None


def test_the_manifest_holds_reserved_bytes():
    m = {m["name"]: m for m in load_manifest()["per_layer"]}[
        "reserved_bytes.train"]
    assert (m["unit"], m["source"], m["moves"], m["workloads"]) == (
        "bytes", "program_counter", "train_pairs_per_s",
        ["flagship.train", "scale_vitl14.train"])
    assert m["layer"] == "step driver (train.step.TrainStep.run)"
