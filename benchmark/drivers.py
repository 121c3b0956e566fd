"""What every kind of traffic shares, and how a kind is found.

A mix's data file (`benchmark/traffic/<mix>.json`) names its "kind"; the
kind is a file of its own, `benchmark/kinds/<kind>.py`, loaded by name.  It
holds the kind's input maker (`inputs(mix, cfg, seed, device)`), its
driver (`Driver`: set the program up from the configuration and the seed,
drive the measured window through the program's own entry points, hold
what it produced against the reference in `benchmark/reference/`), the
faults that calibration plants (`FAULTS`) and the sizes its CPU tests cut
a mix to (`TEST_SIZE`).  A mix of an existing kind is a data file alone; a
new kind is a new file, with no file edited.

Each driver keeps its program state until `release()`, so that the peak
memory read after the window is the program's alone; `check()` runs the
reference after that, on the same device, and returns the compared
numbers.
"""

from __future__ import annotations

import gc
import importlib.util
from pathlib import Path
from typing import Dict, Optional

import torch

from benchmark.reference.model import Arch
from benchmark.weights import initial_weights

ROOT = Path(__file__).resolve().parent.parent


def load_kind(kind: str, root: Path = ROOT):
    """The module `benchmark/kinds/<kind>.py` under `root`."""
    path = root / "benchmark" / "kinds" / f"{kind}.py"
    if not path.exists():
        raise FileNotFoundError(f"no traffic kind {kind!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "benchmark_kind_" + kind.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Driver:
    """The base of every kind's driver: the model from the seed's weights,
    the watchdog's beat, the release of the program's state.  A kind
    names its state in `program_state` and defines `setup()`,
    `window(seconds, traced) -> {metric: value}`, `check() -> {number:
    (value, where)}` and `readings(control) -> {"program": ...,
    "control": ...}` (calibration); `after_window()` runs once the
    window's peak memory has been read, before `release()`."""

    program_state: tuple = ()

    def __init__(self, meta: dict, cfg, mix: dict, seed: int, device,
                 watchdog=None):
        self.meta, self.cfg, self.mix = meta, cfg, mix
        self.seed, self.device = seed, torch.device(device)
        self.arch = Arch.of(meta["config"]["model"])
        self.wd = watchdog
        self.trace: Optional[dict] = None
        self.attempted = self.failed = 0

    def beat(self):
        if self.wd is not None:
            self.wd.beat()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _model(self):
        from leccr_torch.models.leccr import LECCRModel

        model = LECCRModel(self.cfg.model, device=self.device, seed=0)
        self.shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        weights = self._weights()
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name])
        del weights
        return model

    def _weights(self) -> Dict[str, torch.Tensor]:
        return initial_weights(self.shapes, self.cfg.model.temp, self.seed,
                               self.device)

    def after_window(self) -> None:
        pass

    def release(self) -> None:
        for name in self.program_state:
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def traced(measured, named, **extra) -> dict:
    """The measuring slice's summary, with the idle stretches of the slice
    that recorded the host."""
    out = measured.summary()
    out["breakdown"]["idle_gaps"] = named.summary()["breakdown"]["idle_gaps"]
    return {**out, **extra}


def counters() -> Dict[str, int]:
    """The program's launch counters of kernels 1-5."""
    from leccr_torch.ops.flash_attention import flash_tower_attention
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention

    return {"single_fwd": flash_tower_attention.fwd_launches,
            "single_bwd": flash_tower_attention.bwd_launches,
            "chunk_fwd": flash_tower_attention.chunk_fwd_launches,
            "chunk_bwd": flash_tower_attention.chunk_bwd_launches,
            "fca": fused_cross_attention.launches}


def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def values(numbers: dict) -> dict:
    """{number: value} of check()'s {number: (value, where)}."""
    return {k: v[0] for k, v in numbers.items()}
