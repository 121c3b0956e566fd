"""Checkpoint/resume in a torch format (the port of
`leccr_tpu/train/checkpoints.py`, which saves with orbax).

One `torch.save` file a step, `checkpoints/step_<step>.pt`, holding

    {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
     "meta": {"step", "epoch", "steps_per_epoch"}, "ema": [tensors] (opt.)}

(the optimizer's state: torch.optim.AdamW's, or the port's AdamW's
mu/nu/step).  The LR schedule is a pure function of the optimizer's step
count, so `meta.step` stands for the scheduler's state.

- A file is written under a temporary name and `os.replace`d into place:
  a save cut off midway leaves no file that `latest_step` would pick.
- Rotation keeps the newest `keep` step files.  The best checkpoint lives
  in `checkpoints/best/`, which rotation never touches: a hard link to the
  step file where the filesystem allows one (a flagship checkpoint with
  f32 Adam moments is ~3.3 GB), else a copy.  `best.json` and
  `config.json` sit in `checkpoints/`, as the JAX package writes them.
- A save copies the state to host memory in the caller's thread (so the
  caller may train on at once) and writes on a background thread; `wait()`
  joins it and raises what the write raised.  Saves are serialized.
- `restore` reads files with and without "ema" and "steps_per_epoch".
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _to_host(tree: Any) -> Any:
    """A copy of `tree` (dicts, lists, tuples, tensors, scalars) with every
    tensor copied to host memory: the caller may mutate the originals."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _step_files(directory: Path) -> Dict[int, Path]:
    if not directory.is_dir():
        return {}
    return {int(m.group(1)): directory / m.group(0)
            for m in map(_STEP_FILE.match, os.listdir(directory)) if m}


def newest_step_file(directory: Path) -> Optional[Path]:
    """The newest step file in `directory` or, failing that, in its
    `checkpoints/` (an output dir); None if neither holds one."""
    for d in (directory, directory / "checkpoints"):
        files = _step_files(d)
        if files:
            return files[max(files)]
    return None


def _write(state: Dict[str, Any], path: Path) -> None:
    tmp = path.with_name(f".{path.name}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, output_dir: str, keep: int = 2):
        self.dir = Path(output_dir).resolve() / "checkpoints"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = max(1, keep)
        self.best_dir = self.dir / "best"
        self.best_dir.mkdir(exist_ok=True)
        self.best_path = self.dir / "best.json"
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(
        self,
        step: int,
        model_state: Dict[str, torch.Tensor],
        optimizer_state: Dict[str, Any],
        epoch: int,
        config_json: str = "",
        metrics: Optional[Dict[str, float]] = None,
        is_best: bool = False,
        steps_per_epoch: int = 0,
        ema: Optional[List[torch.Tensor]] = None,
    ) -> None:
        """Save step `step` (model and optimizer state_dicts, the EMA
        tensors if any); with is_best also as the best checkpoint."""
        self.wait()
        state = {"model": model_state, "optimizer": optimizer_state,
                 # steps_per_epoch lets resume detect dataset / batch-size
                 # drift directly
                 "meta": {"step": step, "epoch": epoch,
                          "steps_per_epoch": steps_per_epoch}}
        if ema is not None:
            state["ema"] = list(ema)
        state = _to_host(state)
        if config_json:
            (self.dir / "config.json").write_text(config_json)
        best_record = ({"step": step, "epoch": epoch,
                        "metrics": metrics or {}} if is_best else None)
        self._thread = threading.Thread(
            target=self._write_step, args=(state, step, best_record),
            daemon=True)
        self._thread.start()

    def _write_step(self, state, step: int, best_record) -> None:
        try:
            path = self.dir / f"step_{step:08d}.pt"
            _write(state, path)
            if best_record is not None:
                self._set_best(path)
                self.best_path.write_text(json.dumps(best_record))
            files = _step_files(self.dir)
            for old in sorted(files)[:-self.keep]:
                files[old].unlink()
        except BaseException as exc:  # raised by wait()
            self._error = exc

    def _set_best(self, path: Path) -> None:
        target = self.best_dir / path.name
        tmp = self.best_dir / f".{path.name}.tmp"
        if tmp.exists():
            tmp.unlink()
        try:
            os.link(path, tmp)
        except OSError:  # no hard links here (another filesystem)
            shutil.copyfile(path, tmp)
        os.replace(tmp, target)
        for other in _step_files(self.best_dir).values():
            if other != target:
                other.unlink()

    def wait(self) -> None:
        """Join the pending write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def latest_step(self) -> Optional[int]:
        self.wait()
        return max(_step_files(self.dir), default=None)

    @staticmethod
    def read(path: Path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                                  Optional[List[torch.Tensor]],
                                  Dict[str, int]]:
        """(model_state, optimizer_state, ema_or_None, meta) of one step
        file, on the CPU."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        meta = dict(state["meta"])
        meta.setdefault("steps_per_epoch", 0)
        return state["model"], state["optimizer"], state.get("ema"), meta

    def restore(self, step: Optional[int] = None):
        """(model_state, optimizer_state, ema_or_None, meta) of step `step`
        (default: the newest), all on the CPU."""
        self.wait()
        files = _step_files(self.dir)
        step = step if step is not None else max(files, default=None)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return self.read(files[step])

    def restore_best(self):
        """The best-metric checkpoint (never evicted by rotation), as
        restore returns it."""
        self.wait()
        files = _step_files(self.best_dir)
        if not files:
            raise FileNotFoundError(f"no best checkpoint in {self.best_dir}")
        return self.read(files[max(files)])

    def best_info(self) -> Optional[Dict]:
        self.wait()
        if self.best_path.exists():
            return json.loads(self.best_path.read_text())
        return None
