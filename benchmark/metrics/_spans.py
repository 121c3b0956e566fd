"""Helpers the readers of the program's own spans share
(`leccr_torch.utils.tracing`, which records while a profiler records).

Each reader takes the units of the first traced slice, the one that
records the device alone: the first `trace_steps` `train.step` roots of a
train cell, or every span up to and including the first `eval.rank` of an
eval cell.  The harness runs that slice before the one that records the
host.  A reader returns None where the program has no span store, where
the store dropped spans, where a unit is missing and where a span has no
device time (no CUDA)."""

from __future__ import annotations

from typing import List, Optional


def _spans() -> Optional[list]:
    try:
        from leccr_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans()


def _timed(spans: list) -> Optional[list]:
    return None if any(s.device_ms is None for s in spans) else spans


def train_steps(run) -> Optional[List[list]]:
    """The spans of each of the first traced slice's steps, by step."""
    spans = _spans()
    if spans is None:
        return None
    n = run.driver.mix["trace_steps"]
    roots = [s for s in spans
             if s.parent is None and s.name == "train.step"][:n]
    if len(roots) < n:
        return None
    units = {r.id: [] for r in roots}
    for s in spans:
        if s.root in units:
            units[s.root].append(s)
    if _timed([s for u in units.values() for s in u]) is None:
        return None
    return list(units.values())


def train_phase_ms(run, name: str, clock: str) -> Optional[float]:
    """Σ ms of the spans called `name` a step, on the device's clock
    ("device": start marker to end marker on the stream) or the host's
    ("host"), the mean over the slice's steps."""
    steps = train_steps(run)
    if steps is None:
        return None
    attr = "device_ms" if clock == "device" else "host_ms"
    return sum(getattr(s, attr) for u in steps for s in u
               if s.name == name) / len(steps)


def train_host_syncs(run) -> Optional[float]:
    """Host synchronisations inside `train.step` a step."""
    steps = train_steps(run)
    if steps is None:
        return None
    return sum(s.syncs for u in steps for s in u
               if s.parent is None) / len(steps)


def first_eval(run) -> Optional[list]:
    """The spans of the first traced eval: every span up to and including
    the first `eval.rank`."""
    spans = _spans()
    if spans is None:
        return None
    end = next((i for i, s in enumerate(spans) if s.name == "eval.rank"),
               None)
    return None if end is None else _timed(spans[:end + 1])


def eval_ms(run, name: str) -> Optional[float]:
    """Σ device ms of the spans called `name` in the first traced eval."""
    spans = first_eval(run)
    if spans is None:
        return None
    return sum(s.device_ms for s in spans if s.name == name)


def eval_host_syncs(run) -> Optional[float]:
    """Host synchronisations inside the first traced eval's root spans."""
    spans = first_eval(run)
    if spans is None:
        return None
    return float(sum(s.syncs for s in spans if s.parent is None))
