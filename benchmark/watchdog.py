"""A stall watchdog for one benchmark run.

A hung device call never returns to Python, so no signal handler would
run.  One daemon thread does: each phase of the run sets a deadline, each
unit of progress (a step, an eval) moves it on (a clock read and a store,
no thread started), and once the deadline passes the thread prints a
failing result line, names the phase on standard error and ends the
process with exit code 3.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


class Watchdog:
    def __init__(self, device: dict):
        self.device = device
        self._phase, self._timeout = "start", float("inf")
        self._deadline = float("inf")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="benchmark-watchdog")
        self._thread.start()

    def phase(self, name: str, timeout_s: float) -> None:
        """Enter phase `name`; a stretch of `timeout_s` without progress
        ends the run."""
        self._phase, self._timeout = name, timeout_s
        self._deadline = time.monotonic() + timeout_s

    def beat(self) -> None:
        """Progress in the current phase: its deadline starts again."""
        self._deadline = time.monotonic() + self._timeout

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def _watch(self) -> None:
        while not self._stop.wait(min(1.0, max(
                0.0, self._deadline - time.monotonic()))):
            if time.monotonic() >= self._deadline:
                self._expire()

    def _expire(self) -> None:
        print(f"stalled: phase {self._phase} made no progress for "
              f"{self._timeout:.0f} s", file=sys.stderr, flush=True)
        print(json.dumps({"correct": False, "attempted": 0, "failed": 0,
                          "metrics": {}, "device": self.device,
                          "error": f"stalled in {self._phase}"}), flush=True)
        os._exit(3)
