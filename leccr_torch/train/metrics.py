"""Step metrics: windowed smoothing + periodic progress lines + JSONL logs
(the port of `leccr_tpu/train/metrics.py`).

Capability parity with reference utils/__init__.py:14-229 (SmoothedValue /
MetricLogger): windowed median/avg meters, global averages, an ETA-bearing
progress line every `print_freq` steps, and step/data timing.  Peak device
memory is torch.cuda.max_memory_allocated on the card."""

from __future__ import annotations

import collections
import datetime
import json
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

import torch


class SmoothedValue:
    """Track a series with a sliding window and a global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def median(self) -> float:
        vals = sorted(self.window)
        return vals[len(vals) // 2] if vals else 0.0

    @property
    def avg(self) -> float:
        return sum(self.window) / max(len(self.window), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.print = print_fn

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def update(self, **kwargs: float) -> None:
        for key, value in kwargs.items():
            self.meters[key].update(float(value))

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def global_avg(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(
        self,
        iterable: Iterable,
        print_freq: int,
        header: str = "",
        total: Optional[int] = None,
    ) -> Iterator:
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = 0
        step_t = SmoothedValue(fmt="{avg:.4f}")
        data_t = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = start
        for i, obj in enumerate(iterable):
            data_t.update(time.time() - end)
            yield obj
            step_t.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = str(datetime.timedelta(
                        seconds=int(step_t.avg * (total - i))))
                else:
                    eta = "?"
                mem = device_memory_mb()
                mem_s = f"  max mem: {mem:.0f}MB" if mem else ""
                self.print(
                    f"{header}  [{i}{f'/{total}' if total else ''}]  "
                    f"eta: {eta}  {self}  time: {step_t}  data: {data_t}"
                    f"{mem_s}")
        elapsed = str(datetime.timedelta(seconds=int(time.time() - start)))
        self.print(f"{header} Total time: {elapsed}")


def device_memory_mb() -> float:
    """Peak memory allocated on the current CUDA device, in MB; 0.0 where
    there is no CUDA device (a CPU run)."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1e6


class JSONLLogger:
    """Append JSON lines to <output_dir>/log.txt (reference
    image_Retrieval_caption.py:472-473)."""

    def __init__(self, output_dir: str, enabled: bool = True):
        self.path = Path(output_dir) / "log.txt"
        self.enabled = enabled
        if enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: Dict) -> None:
        if self.enabled:
            with self.path.open("a") as f:
                f.write(json.dumps(record, default=float) + "\n")
