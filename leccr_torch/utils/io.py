"""Storage IO that is transparently HDFS-or-local (the port's own copy of
`leccr_tpu/utils/io.py`).

Capability parity with reference utils/hdfs_io.py:23-128 and
utils/torch_io.py:15-31: paths beginning with `hdfs://` are accessed by
shelling out to the `hdfs` CLI (the reference does exactly this), everything
else is the local filesystem.  `sync_dir_to_remote` covers the reference's
checkpoint-upload flow (utils/checkpointer.py:20-46) for the checkpoint
directory."""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import IO, Iterator, List

_HDFS = "hdfs://"


def _hdfs_cmd(*args: str, check: bool = False) -> subprocess.CompletedProcess:
    proc = subprocess.run(["hdfs", "dfs", *args], capture_output=True)
    if check and proc.returncode != 0:
        # a silently-failed -get/-put would surface much later as a missing
        # or empty file (e.g. real -get refuses existing targets)
        raise IOError(
            f"hdfs dfs {' '.join(args)} failed rc={proc.returncode}: "
            f"{proc.stderr.decode(errors='replace').strip()[-500:]}")
    return proc


def exists(path: str) -> bool:
    if path.startswith(_HDFS):
        return _hdfs_cmd("-test", "-e", path).returncode == 0
    return os.path.exists(path)


def makedirs(path: str) -> None:
    if path.startswith(_HDFS):
        _hdfs_cmd("-mkdir", "-p", path, check=True)
    else:
        Path(path).mkdir(parents=True, exist_ok=True)


def listdir(path: str) -> List[str]:
    if path.startswith(_HDFS):
        out = _hdfs_cmd("-ls", path, check=True)
        files = []
        for line in out.stdout.decode().splitlines():
            parts = line.split()
            if parts and parts[-1].startswith(_HDFS):
                files.append(parts[-1])
        return files
    return [os.path.join(path, p) for p in os.listdir(path)]


def copy(src: str, dst: str) -> None:
    s_h, d_h = src.startswith(_HDFS), dst.startswith(_HDFS)
    if s_h and not d_h:
        _hdfs_cmd("-get", src, dst, check=True)
    elif d_h and not s_h:
        _hdfs_cmd("-put", "-f", src, dst, check=True)
    elif s_h and d_h:
        _hdfs_cmd("-cp", src, dst, check=True)
    else:
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst)


@contextlib.contextmanager
def open_file(path: str, mode: str = "r") -> Iterator[IO]:
    """hopen equivalent: streaming read ('r'/'rb') via `hdfs dfs -text`,
    write ('w'/'wb') via `-put -f -` (reference hdfs_io.py:23-81)."""
    if not path.startswith(_HDFS):
        with open(path, mode) as f:
            yield f
        return
    binary = "b" in mode
    if mode.startswith("r"):
        proc = subprocess.Popen(["hdfs", "dfs", "-text", path],
                                stdout=subprocess.PIPE)
        try:
            yield proc.stdout if binary else _TextWrap(proc.stdout)
        finally:
            proc.stdout.close()
            proc.wait()
    elif mode.startswith(("w", "a")):
        flag = "-appendToFile" if mode.startswith("a") else "-put"
        args = ["hdfs", "dfs", flag] + (
            ["-f"] if flag == "-put" else []) + ["-", path]
        proc = subprocess.Popen(args, stdin=subprocess.PIPE)
        try:
            yield proc.stdin if binary else _TextWrap(proc.stdin, write=True)
        finally:
            proc.stdin.close()
            proc.wait()
    else:
        raise ValueError(f"unsupported mode {mode}")


class _TextWrap:
    def __init__(self, stream, write: bool = False):
        self._s = stream
        self._w = write

    def read(self, *a):
        return self._s.read(*a).decode()

    def write(self, text: str):
        return self._s.write(text.encode())

    def __iter__(self):
        for line in self._s:
            yield line.decode()


def sync_dir_to_remote(local_dir: str, remote_dir: str,
                       state: dict | None = None) -> int:
    """Mirror the CONTENTS of local_dir into remote_dir (rank-0 callers).
    Returns the number of files uploaded.

    Child-by-child: `hdfs dfs -put -f <dir> <existing-remote-dir>` NESTS
    the source under its basename on real HDFS, so a second epoch's sync
    of `checkpoints/` would create `checkpoints/checkpoints/…`.  Files are
    put directly (`-put -f` overwrites without nesting); directories
    recurse, so `remote_dir/<name>` always equals `local_dir/<name>` —
    the layout `run.py`'s resume staging downloads back.

    ``state`` (optional, mutable) maps remote path -> (size, mtime_ns) of
    the last uploaded copy; pass the SAME dict across calls and unchanged
    files are skipped, so the per-epoch sync cost is proportional to new
    data instead of O(total checkpoint size) — the reference's Checkpointer
    likewise uploads each epoch file once (utils/checkpointer.py:20-46).
    A checkpoint file is never rewritten in place (train.checkpoints
    writes a new file and renames it), so size+mtime is a sound change
    signal here."""
    makedirs(remote_dir)
    base = remote_dir.rstrip("/")
    uploaded = 0
    for name in sorted(os.listdir(local_dir)):
        src = os.path.join(local_dir, name)
        if os.path.isdir(src):
            uploaded += sync_dir_to_remote(src, f"{base}/{name}", state)
        else:
            dst = f"{base}/{name}"
            st = os.stat(src)
            sig = (st.st_size, st.st_mtime_ns)
            if state is not None and state.get(dst) == sig:
                continue
            copy(src, dst)
            uploaded += 1
            if state is not None:
                state[dst] = sig
    return uploaded


def stage_remote_dir(remote_dir: str, local_dir: str) -> None:
    """Download the CONTENTS of remote_dir into local_dir (resume staging).

    Per-child `-get` with a non-existent local target, so each child lands
    at `local_dir/<name>` exactly — `-get <remote-dir> <existing-dir>`
    would nest the whole tree under the remote basename and resume would
    never find `local_dir/checkpoints`.  Existing local children are
    replaced (the remote copy is the source of truth on resume)."""
    Path(local_dir).mkdir(parents=True, exist_ok=True)
    for child in listdir(remote_dir):
        name = child.rstrip("/").rsplit("/", 1)[-1]
        target = os.path.join(local_dir, name)
        if os.path.isdir(target):
            shutil.rmtree(target)
        elif os.path.exists(target):
            os.remove(target)
        copy(child, target)
