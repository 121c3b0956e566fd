"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `leccr_torch/csrc/<name>.cu` exposes a plain C interface.  At first use
it is compiled for Hopper (`sm_90a`) into a shared library under
`leccr_torch/_build/`, named by a hash of its source and of the headers
under `csrc/` that it includes (`#include "..."`, followed through the
headers) so that an edited source is never served from a stale library,
and an edit to a header rebuilds only the libraries that include it.  The
library is loaded with `ctypes`.  Nothing is compiled or loaded when this
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
from concurrent.futures import ThreadPoolExecutor
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
# per-library build record: seconds spent in nvcc (0.0 when the library was
# already on disk) and nvcc's output, including ptxas' register/smem report
build_info: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor /usr/local/cuda/bin): the CUDA "
        "kernels of leccr_torch are built from source at first use")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(path: Path) -> list:
    """The headers under csrc/ that `path` includes, directly or through
    another such header, sorted."""
    found, todo = set(), [path]
    while todo:
        for header in _LOCAL_INCLUDE.findall(todo.pop().read_text()):
            dep = CSRC / header
            if dep.exists() and dep not in found:
                found.add(dep)
                todo.append(dep)
    return sorted(found)


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is on disk:
    (name, output, tmp, process, start time) or None."""
    out = library_path(name)
    if out.exists():
        build_info.setdefault(name, (0.0, ""))
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, out, tmp, proc, time.perf_counter()


def _finish(job) -> None:
    name, out, tmp, proc, t0 = job
    try:
        log, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial
    build_info[name] = (seconds, log)


def build(*names: str) -> None:
    """Compile each csrc/<name>.cu into the build directory unless the
    library for that exact source is already there; the nvcc processes run
    side by side, each waited for on its own thread, so that its recorded
    seconds end when it does."""
    jobs = [job for job in map(_start, names) if job is not None]
    try:
        if jobs:
            with ThreadPoolExecutor(len(jobs)) as pool:
                list(pool.map(_finish, jobs))
    finally:
        for job in jobs:  # leave no compiler running if one failed
            if job[3].poll() is None:
                job[3].kill()
                job[3].communicate()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
