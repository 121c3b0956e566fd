"""Helpers of the readers of a train cell whose text tower has MoE layers
(kind "train_moe"): each traced step's routed slots, as the program's
`train.step` span noted them."""

from __future__ import annotations

from typing import List, Optional

from benchmark.metrics._spans import train_phase_ms, train_steps


def routed_slots(run) -> Optional[List[dict]]:
    """[{call: [slots of the held experts in each MoE layer]}] of the first
    traced slice's steps; None where the program notes none."""
    steps = train_steps(run)
    if steps is None:
        return None
    out = []
    for unit in steps:
        root = next(s for s in unit if s.parent is None)
        reading = getattr(root, "reading", None)
        slots = {c: reading(f"routed_slots.{c}") if reading else None
                 for c in ("text", "caption")}
        if any(v is None for v in slots.values()):
            return None
        out.append(slots)
    return out


def forward_span_ms(run, name: str) -> Optional[float]:
    """`_spans.train_phase_ms` on the device's clock of a span that only an
    eager forward records (a CUDA graph's replay runs no Python inside
    it); None where a traced step has none."""
    steps = train_steps(run)
    if steps is None or not all(any(s.name == name for s in unit)
                                for unit in steps):
        return None
    return train_phase_ms(run, name, "device")
