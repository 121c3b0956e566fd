"""Spans and counters inside the program, on the profiler's clock.

    with tracing.span("train.forward"):
        ...

`span(name)` marks one phase of the work.  It records only while a
`torch.profiler` session is recording or inside a `record()` block, and
never inside a `suspended()` block (a CUDA graph's capture, where a marker
on the stream would be captured rather than timed); at any other time it
returns one shared no-op context after reading three flags, and costs
well under a microsecond (no allocation, no torch call, no clock read).

A recorded span keeps its name, its own id, its parent's id (the span open
around it on the same thread) and its root's id (the outermost span: one
train step, one tower call of an eval); host start and end from
`time.time_ns()`, the epoch clock that the profiler's timestamps follow;
and, where CUDA is initialized, a pair of `torch.cuda.Event` markers on the
current stream, from a reused pool, resolved to milliseconds only when
read.  It also enters `torch.profiler.record_function(name)`, so the span
lies in the profiler's timeline beside the device's kernels and inside
its own host stamps.

A root span also keeps `reserved_bytes`, the device memory that CUDA's
caching allocator holds (`torch.cuda.memory_reserved`, a CUDA graph's
pool included) when it closes; None for an inner span and without CUDA.

Counter `host_syncs`: device-to-host synchronisations made while a root
span is open (implicit ones included: `.item()`, `.cpu()`, `nonzero`, a
blocking copy).  CUDA's sync debug mode is set to "warn" for the duration
of the root, its warnings are counted rather than shown, and the previous
mode and warning filters come back at the root's exit.

Reading: `spans()` gives the closed spans in order of closing (children
before their parent), `counters()` the counts, `reset()` empties the
store.  The store holds at most `MAX_SPANS`; past that it counts what it
drops, and `spans()` returns None, since a partial record would read as a
whole one.  There is no file exporter: the profiler's own trace export
carries the spans.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 65536
# the warning of CUDA's sync debug mode (c10/cuda/CUDAFunctions.cpp)
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_OFF = contextlib.nullcontext()
_explicit = 0  # depth of open record() blocks
_suspended = 0  # depth of open suspended() blocks
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()


class _Store:
    def __init__(self):
        self.spans: List["Span"] = []
        self.dropped = 0
        self.syncs = 0
        self.open_roots = 0
        self.pool: List[torch.cuda.Event] = []
        self.restore = None  # how to undo the sync counting, while on


_store = _Store()


def span(name: str):
    """A context manager that records the phase `name` while recording is
    on (see the module's docstring), and a shared no-op context else."""
    if (_explicit or _profiler._is_profiler_enabled) and not _suspended:
        return Span(name)
    return _OFF


@contextlib.contextmanager
def record() -> Iterator[None]:
    """Record spans inside the block, with or without a profiler."""
    global _explicit
    with _lock:
        _explicit += 1
    try:
        yield
    finally:
        with _lock:
            _explicit -= 1


@contextlib.contextmanager
def suspended() -> Iterator[None]:
    """Record no span inside the block, on any thread."""
    global _suspended
    with _lock:
        _suspended += 1
    try:
        yield
    finally:
        with _lock:
            _suspended -= 1


class Span:
    """One recorded span; see the module's docstring."""

    __slots__ = ("name", "id", "parent", "root", "t0_ns", "t1_ns", "syncs",
                 "reserved_bytes", "_events", "_device_ms", "_fn", "_syncs0")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_ids)
        self.t0_ns = self.t1_ns = 0
        self.syncs = 0
        self.reserved_bytes: Optional[int] = None
        self._events = None
        self._device_ms: Optional[float] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        if not stack:
            _open_root()
        stack.append(self)
        self._syncs0 = _store.syncs
        self._fn = _profiler.record_function(self.name)
        self.t0_ns = time.time_ns()
        self._fn.__enter__()
        if _cuda_timing():
            self._events = _take_events()
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
        self._fn.__exit__(*exc)
        self.t1_ns = time.time_ns()
        self._fn = None
        stack = _stack()
        stack.pop()
        self.syncs = _store.syncs - self._syncs0
        if not stack:
            _close_root()
            if self._events is not None:
                self.reserved_bytes = _reserved_bytes()
        with _lock:
            if len(_store.spans) < MAX_SPANS:
                _store.spans.append(self)
                return
            _store.dropped += 1
        self._release(resolve=False)

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Stream time from the start marker to the end marker, including
        any stretch the device waited on the host inside the span; None
        without CUDA."""
        if self._device_ms is None and self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
        return self._device_ms

    def _release(self, resolve: bool = True) -> None:
        """Give the markers back to the pool, resolved first if `resolve`
        (a marker recorded again later simply moves)."""
        if self._events is None:
            return
        if resolve:
            self.device_ms
        with _lock:
            _store.pool.extend(self._events)
        self._events = None

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"root={self.root}, host_ms={self.host_ms:.3f}, "
                f"device_ms={self.device_ms}, syncs={self.syncs})")


def spans() -> Optional[List[Span]]:
    """The closed spans in order of closing; None once any was dropped."""
    with _lock:
        return None if _store.dropped else list(_store.spans)


def counters() -> Dict[str, int]:
    """{"host_syncs": syncs counted inside root spans, "spans": spans held,
    "dropped": spans the full store did not keep}."""
    with _lock:
        return {"host_syncs": _store.syncs, "spans": len(_store.spans),
                "dropped": _store.dropped}


def reset() -> None:
    """Empty the store and zero the counters (resolving every held span's
    markers first, so a span read later keeps its times)."""
    with _lock:
        held, _store.spans = _store.spans, []
        _store.dropped = _store.syncs = 0
    for s in held:
        s._release()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda_timing() -> bool:
    return torch.cuda.is_initialized()


def _reserved_bytes() -> int:
    return torch.cuda.memory_reserved()


def _take_events():
    pool = _store.pool
    with _lock:
        if len(pool) >= 2:
            return pool.pop(), pool.pop()
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _sync_debug_mode() -> Optional[int]:
    """CUDA's sync debug mode; None where CUDA is not initialized."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.get_sync_debug_mode()


def _set_sync_debug_mode(mode: int) -> None:
    torch.cuda.set_sync_debug_mode(mode)


def _open_root() -> None:
    """At the first open root: count CUDA's sync warnings."""
    with _lock:
        _store.open_roots += 1
        if _store.open_roots > 1:
            return
    mode = _sync_debug_mode()
    if mode is None:
        return
    caught = warnings.catch_warnings()
    caught.__enter__()
    warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
    shown = warnings.showwarning

    def count(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE in str(message):
            with _lock:
                _store.syncs += 1
            if mode == 0:
                return
        shown(message, category, filename, lineno, file, line)

    warnings.showwarning = count
    _set_sync_debug_mode(max(mode, 1))
    _store.restore = (mode, caught)


def _close_root() -> None:
    """At the last open root's exit: the previous mode and filters."""
    with _lock:
        _store.open_roots -= 1
        if _store.open_roots or _store.restore is None:
            return
        (mode, caught), _store.restore = _store.restore, None
    _set_sync_debug_mode(mode)
    caught.__exit__(None, None, None)
