"""The traced slices of a `--trace 1` run: torch.profiler over a few
steady units of the window (steps or evals), each reduced to one timeline.

A `Slice` records the device's operations (kernels, copies, sets) and,
with `host=True`, the host's as well.  Recording every host operation
slows a host-bound step by a third, so the measuring slice records the
device alone, and a second, shorter one with the host names the idle
stretches.  `summary()` gives the seconds in which some operation ran on
the device (the union of their intervals), the slice's wall seconds
(synchronized at both ends), the device seconds of each kernel family
(`roofline.kernel_family`), the ten device operations that took the most
time and, with the host recorded, the ten longest stretches with nothing
on the device, each named by the innermost host operation running at its
middle ("between host ops" where none was).  Nothing is written to disk.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from benchmark.roofline import kernel_family


class Slice:
    def __init__(self, host: bool = False):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CUDA]
        if host:
            activities.append(ProfilerActivity.CPU)
        self._prof = profile(activities=activities)
        self.t0 = self.t1 = 0.0

    def __enter__(self) -> "Slice":
        torch.cuda.synchronize()
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)

    def summary(self) -> dict:
        device: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        for e in self._prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((start, end, e.name()))
            elif end > start:
                host.append((start, end, e.name()))
        busy_ns, merged = _union([(s, e) for s, e, _ in device])
        by_op: Dict[str, float] = {}
        families: Dict[str, float] = {}
        for s, e, name in device:
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
            fam = kernel_family(name)
            if fam is not None:
                families[fam] = families.get(fam, 0.0) + (e - s) / 1e9
        lead = min((s for s, _, _ in host), default=None)
        gaps = []
        if merged and lead is not None and merged[0][0] > lead:
            gaps.append((lead, merged[0][0]))
        gaps += [(a[1], b[0]) for a, b in zip(merged, merged[1:])
                 if b[0] > a[1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = [[_host_at(host, (a + b) // 2), (b - a) / 1e9]
                for a, b in gaps[:10]]
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_ns / 1e9, "window_s": self.t1 - self.t0,
                "families": families,
                "breakdown": {"device_ops": [[n[:120], s] for n, s in top],
                              "idle_gaps": idle}}


def _union(intervals):
    """(total length, merged intervals) of [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _host_at(host, t: int) -> str:
    """The innermost host operation running at time t (the latest-starting
    one that covers it)."""
    best = None
    for s, e, name in host:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, name)
    return "between host ops" if best is None else best[1][:120]
