"""The port's spans and counters (`leccr_torch.utils.tracing`) on CPU.

Off, a span is one shared no-op context and records nothing.  Under
`tracing.record()` a tiny train step gives its span tree (one root a call,
GradCache's microbatches under the same names), and the losses and
gradients are the same bits as with recording off.  Under a profiler,
with no `record()`, the spans record by themselves and lie in the
profiler's timeline as user annotations inside their own host stamps.  A
full store counts its drops; the sync counter counts a synchronising call
inside a root span and restores the mode and warning filters it changed.
"""

import time
import warnings

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from leccr_torch.config import tiny_test_config
from leccr_torch.eval.retrieval import retrieval_ranks
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.train.step import make_train_step
from leccr_torch.utils import tracing

B, L = 8, 16
TOWERS = ["model.vision", "model.caption", "model.interact", "model.text"]
PLAIN = TOWERS + ["train.forward", "train.loss", "train.backward",
                  "train.optimizer", "train.step"]
GRAD_CACHE = ((TOWERS + ["train.forward"]) * 2
              + ["train.loss", "train.backward"]
              + (TOWERS + ["train.forward", "train.backward"]) * 2
              + ["train.optimizer", "train.step"])
PARENTS = {"model.vision": "train.forward", "model.caption": "train.forward",
           "model.interact": "train.forward", "model.text": "train.forward",
           "train.forward": "train.step", "train.loss": "train.step",
           "train.backward": "train.step", "train.optimizer": "train.step",
           "train.step": None}


@pytest.fixture(autouse=True)
def empty_store():
    tracing.reset()
    yield
    tracing.reset()


def _batch(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    res = cfg.model.vision.image_res
    mask = torch.ones(B, L, dtype=torch.long)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    batch = {"vision": torch.randint(0, 256, (B, res, res, 3), generator=g,
                                     dtype=torch.uint8),
             "flip": torch.rand(B, generator=g) < 0.5,
             "idx": torch.tensor([0, 1, 2, 0, 3, 1, 4, 5])}
    for key in ("text_ids_s", "text_ids_t", "caption_ids"):
        batch[key] = torch.randint(5, 512, (B, L), generator=g) * mask
    for key in ("text_mask_s", "text_mask_t", "caption_mask"):
        batch[key] = mask.clone()
    return batch


def _step(microbatches: int = 1):
    cfg = tiny_test_config(**{"train.grad_cache_microbatches": microbatches})
    model = LECCRModel(cfg.model, device="cpu", seed=0)
    return make_train_step(cfg, model, total_steps=10), cfg


def _tree(spans):
    by_id = {s.id: s for s in spans}
    return [(s.name, by_id[s.parent].name if s.parent else None)
            for s in spans]


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("an event was made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert tracing.span("a") is tracing.span("b")
    step, cfg = _step()
    step.run(_batch(cfg), 0)
    assert tracing.spans() == []
    assert tracing.counters() == {"host_syncs": 0, "spans": 0, "dropped": 0}


def test_a_step_gives_the_span_tree():
    step, cfg = _step()
    with tracing.record():
        step.run(_batch(cfg), 0)
        step.run(_batch(cfg, 1), 1)
    spans = tracing.spans()
    assert [s.name for s in spans] == PLAIN * 2
    assert _tree(spans) == [(n, PARENTS[n]) for n in PLAIN] * 2
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["train.step"] * 2
    for k, root in enumerate(roots):
        unit = spans[k * len(PLAIN):(k + 1) * len(PLAIN)]
        assert {s.root for s in unit} == {root.id}
    for s in spans:
        assert s.host_ms > 0 and s.device_ms is None and s.syncs == 0
    phases = [s for s in spans[:len(PLAIN)] if s.parent == roots[0].id]
    assert sum(s.host_ms for s in phases) <= roots[0].host_ms


def test_a_grad_cache_step_gives_the_same_names():
    step, cfg = _step(microbatches=2)
    with tracing.record():
        step.run(_batch(cfg), 0)
    spans = tracing.spans()
    assert [s.name for s in spans] == GRAD_CACHE
    assert _tree(spans) == [(n, PARENTS[n]) for n in GRAD_CACHE]


def test_an_eval_gives_one_root_a_tower_call():
    cfg = tiny_test_config()
    model = LECCRModel(cfg.model, device="cpu", seed=0)
    batch = _batch(cfg)
    with tracing.record():
        txt = model.embed_texts(batch["text_ids_s"], batch["text_mask_s"])
        img = model.embed_images({
            "vision": batch["vision"].float() / 255.0,
            "caption_ids": batch["caption_ids"],
            "caption_mask": batch["caption_mask"]})["feat"]
        retrieval_ranks(img, txt, np.arange(B), np.arange(B)[:, None])
    spans = tracing.spans()
    assert [s.name for s in spans] == ["model.text", "model.vision",
                                       "model.caption", "model.interact",
                                       "eval.rank"]
    assert all(s.parent is None and s.root == s.id for s in spans)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_recording_changes_no_bit(microbatches):
    out = []
    for on in (False, True):
        step, cfg = _step(microbatches)
        if on:
            with tracing.record():
                losses = step.run(_batch(cfg), 0)
        else:
            losses = step.run(_batch(cfg), 0)
        out.append((losses, {n: (p.grad.clone(), p.detach().clone())
                             for n, p in step.model.named_parameters()}))
    (off_losses, off), (on_losses, on) = out
    assert tracing.counters()["spans"] > 0
    assert torch.equal(off_losses, on_losses)
    assert off.keys() == on.keys()
    for name in off:
        assert torch.equal(off[name][0], on[name][0]), name
        assert torch.equal(off[name][1], on[name][1]), name


def test_the_profiler_turns_spans_on_and_shares_their_clock():
    """The profiler's user annotation of each span lies inside the span's
    host stamps and, after the first span, within 50 us of them at both
    ends.  The closeness is read in the best of three profiled steps: a
    worker preempted between a stamp and the profiler's own clock read
    moves one reading, not the clocks."""
    step, cfg = _step()
    step.run(_batch(cfg), 0)
    worst = []
    for k in range(3):
        tracing.reset()
        assert autograd_profiler._is_profiler_enabled is False
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert autograd_profiler._is_profiler_enabled is True
            assert isinstance(tracing.span("x"), tracing.Span)
            step.run(_batch(cfg), k + 1)
        assert autograd_profiler._is_profiler_enabled is False
        assert not isinstance(tracing.span("x"), tracing.Span)
        spans = tracing.spans()
        assert [s.name for s in spans] == PLAIN
        ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.name() in PARENTS}
        assert set(ranges) == set(PLAIN)
        gaps = []
        for s in sorted(spans, key=lambda s: s.t0_ns):
            start, end = ranges[s.name]
            assert s.t0_ns <= start <= end <= s.t1_ns, s
            gaps.append(max(start - s.t0_ns, s.t1_ns - end))
        worst.append(max(gaps[1:]))
    assert min(worst) <= 50_000, worst


def test_a_full_store_counts_its_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    with tracing.record():
        for k in range(5):
            with tracing.span(f"s{k}"):
                pass
    assert tracing.counters() == {"host_syncs": 0, "spans": 3, "dropped": 2}
    assert tracing.spans() is None
    tracing.reset()
    assert tracing.spans() == []
    assert tracing.counters()["dropped"] == 0


def _synchronizing_call():
    """What CUDA's sync debug mode does at a synchronising call in "warn"
    mode: a UserWarning with its message."""
    warnings.warn("called a synchronizing CUDA operation")


def test_the_sync_counter_counts_and_restores(monkeypatch):
    modes = []
    monkeypatch.setattr(tracing, "_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(tracing, "_set_sync_debug_mode", modes.append)
    filters, shown = list(warnings.filters), warnings.showwarning
    with pytest.warns(UserWarning, match="synchronizing"):
        _synchronizing_call()  # outside any span: shown, not counted
    with tracing.record():
        with tracing.span("outer") as outer:
            with tracing.span("inner") as inner:
                _synchronizing_call()
            _synchronizing_call()
            with pytest.warns(UserWarning, match="another"):
                warnings.warn("another warning")
        assert modes == [1, 0]
        with tracing.span("later") as later:
            time.sleep(0)
    assert modes == [1, 0, 1, 0]
    assert (outer.syncs, inner.syncs, later.syncs) == (2, 1, 0)
    assert tracing.counters()["host_syncs"] == 2
    assert warnings.filters == filters and warnings.showwarning is shown
