"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration (`benchmark/configs/<config>.yaml`), its
traffic mix (`benchmark/traffic/<mix>.json`), the mix's kind
(`benchmark/kinds/<kind>.py`: its input maker and driver), its comparison
limits (`benchmark/limits/<cell>.json`) and its per-layer metrics
(`benchmark/metrics/<metric>.py`) are all found by name from
`BENCHMARK.json`.  The run sets the program up from the seed (weights,
inputs, a warm-up of every shape the mix uses), measures for `--seconds`,
reads the peak device memory, frees the program's state, holds what the
timed path produced against the plain reference, and prints one JSON line
last on standard output; the compared numbers beside their limits are the
last lines on standard error and the line's last key.  The host is kept
steady: the main thread, which dispatches the program's work, takes one
CPU to itself for the window, every other thread the rest.  `--trace 1` runs
the same window with a profiled slice and reports the per-layer metrics
instead of the end-to-end ones.

It exits non-zero, printing no result, without a CUDA device or with
fewer than the cell asks for, and when jax, jaxlib, flax or leccr_tpu are
in `sys.modules` once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "leccr_tpu")
# no progress for this long ends the run (a step, an eval, a first build)
STALL_S = {"setup": 900.0, "window": 180.0, "check": 300.0}


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(manifest: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry and the files it names: its configuration (the
    YAML's whole content), its mix, its limits."""
    import yaml

    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return {
        "cell": cell,
        "meta": yaml.safe_load((root / config["file"]).read_text()),
        "mix": json.loads((root / "benchmark" / "traffic"
                           / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((root / "benchmark" / "limits"
                              / f"{workload}.json").read_text()),
    }


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list:
    """The metric entries the cell reports in a run of this kind."""
    if not trace:
        return [m for m in manifest["end_to_end"]
                if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in cell_metrics(manifest, workload, False)}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in reported]


def read_metric(name: str, run, root: Path = ROOT):
    """A per-layer metric's value from its reader
    (`benchmark/metrics/<name>.py`'s `read(run)`), or None."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


class Host:
    """The host's side of a steady run.  At the start, before any thread
    is made, every thread of the process is confined to all allowed CPUs
    but the last; at the window's start the main thread (which dispatches
    the program's work) moves to that last CPU alone."""

    def __init__(self):
        cpus = sorted(os.sched_getaffinity(0))
        self.main = cpus[-1] if len(cpus) >= 3 else None
        if self.main is not None:
            os.sched_setaffinity(0, cpus[:-1])
        self.threads = max(1, min(4, len(cpus) - 1))

    def open(self) -> None:
        if self.main is not None:
            os.sched_setaffinity(0, {self.main})


class Run:
    """What one run measured, as the metric readers see it: the driver
    (its inputs and counts), its traced slice, the configuration."""

    def __init__(self, driver):
        self.driver = driver
        self.arch, self.cfg = driver.arch, driver.cfg
        self.trace = driver.trace


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, cfg_override=None,
             meta_override=None, watchdog: bool = True,
             host: Optional["Host"] = None) -> dict:
    """One run; returns the result line as a dict (its "checks" last).
    `device="cpu"`, `cfg_override` / `meta_override` (a LECCRConfig and
    the configuration file's content at a test size) are for the CPU
    tests: a cell's timed run on the CLI always takes the card."""
    import torch

    from benchmark.drivers import load_kind
    from benchmark.watchdog import Watchdog
    from leccr_torch.config import LECCRConfig

    manifest = load_manifest(root)
    files = cell_files(manifest, workload, root)
    chips = files["cell"]["chips"]
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < chips):
        raise RuntimeError(f"{workload} needs {chips} CUDA device(s)")
    meta = meta_override or files["meta"]
    cfg = cfg_override or LECCRConfig.from_dict(meta["config"])
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"), "count": chips}
    wd = Watchdog(info) if watchdog else None

    def phase(name):
        if wd is not None:
            wd.phase(name, STALL_S[name])

    phase("setup")
    kind = load_kind(files["mix"]["kind"], root)
    driver = kind.Driver(meta, cfg, files["mix"], seed, dev, wd)
    driver.setup()
    driver.sync()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    phase("window")
    if host is not None:
        host.open()
    e2e = driver.window(seconds, trace)
    device_line = device_info(dev, chips)
    driver.after_window()
    driver.release()
    phase("check")
    checks = driver.check()
    if wd is not None:
        wd.stop()
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise RuntimeError(f"the run loaded {found}")

    metrics = {}
    run = Run(driver)
    for m in cell_metrics(manifest, workload, trace):
        if trace:
            value = read_metric(m["name"], run, root)
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = files["limits"]["limits"]
    compared = {name: {"value": value, "limit": limits[name], "of": where}
                for name, (value, where) in checks.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": driver.attempted,
              "failed": driver.failed, "metrics": metrics,
              "device": device_line}
    if trace and driver.trace is not None:
        result["device"]["busy_s"] = driver.trace["busy_s"]
        result["device"]["window_s"] = driver.trace["window_s"]
        result["breakdown"] = driver.trace["breakdown"]
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # transformers, should anything load it, must not load flax (and JAX)
    os.environ.setdefault("USE_FLAX", "0")
    host = Host()
    try:
        import torch

        torch.set_num_threads(host.threads)
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), host=host)
    except (RuntimeError, ImportError, FileNotFoundError) as err:
        print(f"benchmark: {err}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}; "
              f"{c['of']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
