"""Helpers the per-layer metric readers share: the traced slice's kernel
rooflines, checked against the program's launch counters."""

from __future__ import annotations

import sys

from benchmark import roofline


def mismatch(what: str, counted: dict, expected: dict) -> None:
    print(f"{what}: the launch counters read {counted}, the traffic's shapes "
          f"give {expected}; the roofline is left out", file=sys.stderr)


def train_flash_roofline(run, regime: str):
    """Σ bound / device ms of the profiled steps' launches of one regime
    ("single": kernels 2/3, "chunked": 4/5), in %; None without a
    reading or where the counters disagree with the shapes."""
    trace = run.trace
    if trace is None:
        return None
    rows = []
    for w in trace["widths"]:
        rows += roofline.train_launches(run.arch, w["batch"], w["text"],
                                        w["caption"])
    prefix = "single" if regime == "single" else "chunk"
    counted = {k: v for k, v in trace["launches"].items()
               if k.startswith(prefix)}
    expected = {k: v for k, v in roofline.launch_counts(rows).items()
                if k.startswith(prefix)}
    if counted != expected:
        mismatch(f"{regime} flash", counted, expected)
        return None
    bounds = [n * roofline.flash_launch(direction, b, h, length, dh, masked,
                                        reg)[0]
              for (reg, direction, b, h, length, dh, masked), n in rows
              if reg == regime]
    families = (("single_fwd", "single_bwd") if regime == "single"
                else ("chunked",))
    return roofline.share(bounds, 1e3 * roofline.family_ms(
        trace["families"], *families))


def idle_share(run):
    trace = run.trace
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
