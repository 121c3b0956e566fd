"""Numerical-safety checks: what `train.debug_nans` turns on (the port of
`leccr_tpu/utils/debug.py`).

- `nan_checks(True)` is autograd's anomaly mode
  (`torch.autograd.set_detect_anomaly`) for the span of a step's forward
  and backward: a backward op that makes a NaN raises, with the trace of
  the forward op that recorded it.  It reports the BACKWARD op that
  produced the NaN, where `jax_debug_nans` stops at the forward op, and a
  NaN made in the forward alone passes it; so
- `assert_all_finite(tensors, name)` checks the losses and the gradients
  after each step (one host sync each).
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Mapping, Union

import torch


def nan_checks(enabled: bool = True):
    """A context manager: anomaly mode inside it when `enabled`."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.autograd.set_detect_anomaly(True)


def assert_all_finite(
        tensors: Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]],
        name: str = "tensors") -> None:
    """Raise FloatingPointError naming the first (up to 8) floating-point
    tensors of `tensors` (a mapping, or an iterable indexed by position)
    that hold a NaN or an infinity."""
    items = (tensors.items() if isinstance(tensors, Mapping)
             else enumerate(tensors))
    floats = [(key, t) for key, t in items
              if t is not None and t.is_floating_point()]
    if not floats:
        return
    finite = torch.stack([torch.isfinite(t).all() for _, t in floats])
    bad = [key for (key, _), ok in zip(floats, finite.tolist()) if not ok]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:8]}")
