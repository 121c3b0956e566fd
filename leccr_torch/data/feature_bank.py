"""Random-access float32 feature bank (BigFile format): the port's own copy
of `leccr_tpu/data/feature_bank.py` (the port imports nothing of the JAX
package).

Capability parity with reference utils/bigfile.py:5-62: a directory holding
`shape.txt` (rows dims), `id.txt` (space/newline separated names) and
`feature.bin` (row-major float32).  The reference seek()s per row from Python;
here the file is np.memmap'd once and rows are fetched with a single fancy-
index gather — orders of magnitude faster for the per-item frame loops in the
video datasets (retrieval_dataset_video.py:146-151).

A writer is included for tests/synthetic benches, and `read_video` pads
variable-length frame sequences into a fixed [max_frames, D] + mask layout
(one shape for every batch, as the JAX package; the reference pads
per-batch to the batch max, retrieval_dataset_video.py:21-37).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np


class FeatureBank:
    def __init__(self, datadir: str):
        datadir = str(datadir)
        shape_txt = Path(datadir, "shape.txt").read_text().split()
        self.num_rows, self.ndims = int(shape_txt[0]), int(shape_txt[1])
        names = Path(datadir, "id.txt").read_bytes().strip().split()
        self.names = [n.decode("ISO-8859-1") for n in names]
        assert len(self.names) == self.num_rows, (
            f"id.txt has {len(self.names)} names, shape.txt says "
            f"{self.num_rows}")
        self.name2index = {n: i for i, n in enumerate(self.names)}
        self._mat = np.memmap(
            Path(datadir, "feature.bin"), dtype=np.float32, mode="r",
            shape=(self.num_rows, self.ndims))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_rows, self.ndims)

    def read_rows(self, names: Sequence[str]) -> np.ndarray:
        idx = np.fromiter((self.name2index[n] for n in names), np.int64,
                          len(names))
        return np.asarray(self._mat[idx])

    def read_one(self, name: str) -> np.ndarray:
        return np.asarray(self._mat[self.name2index[name]])

    def iter_rows(self, block_rows: int = 4096):
        """Sequential (name, row) stream over the whole bank — the
        reference's StreamFile (utils/bigfile.py:66-105), which walks
        feature.bin front to back for bank-building/export jobs.  Here
        it rides the same memmap in block-sized slices, so the OS
        readahead streams the file once instead of the reference's
        per-row array.fromfile() calls; each yielded row is a copy (safe
        to hold past the next iteration)."""
        for start in range(0, self.num_rows, block_rows):
            block = np.array(self._mat[start: start + block_rows])
            for off in range(block.shape[0]):
                yield self.names[start + off], block[off]

    def read_video(
        self, frame_names: Sequence[str], max_frames: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (frames [max_frames, D] float32, valid_mask [max_frames] bool).

        Longer sequences are uniformly subsampled to max_frames (one
        shape for every batch, where the reference pads to the batch's
        longest)."""
        feats = self.read_rows(frame_names)
        t = feats.shape[0]
        if t > max_frames:
            pick = np.linspace(0, t - 1, max_frames).round().astype(np.int64)
            feats = feats[pick]
            t = max_frames
        out = np.zeros((max_frames, self.ndims), np.float32)
        out[:t] = feats
        mask = np.zeros((max_frames,), bool)
        mask[:t] = True
        return out, mask


def write_feature_bank(
    datadir: str, names: Sequence[str], matrix: np.ndarray
) -> None:
    """Write a BigFile-format directory (tests / synthetic data)."""
    path = Path(datadir)
    path.mkdir(parents=True, exist_ok=True)
    matrix = np.ascontiguousarray(matrix, np.float32)
    (path / "shape.txt").write_text(f"{matrix.shape[0]} {matrix.shape[1]}")
    (path / "id.txt").write_text("\n".join(names))
    matrix.tofile(path / "feature.bin")


def read_video2frames(path: str) -> Dict[str, List[str]]:
    """`video2frames.txt` is a python-literal dict video_id -> [frame ids]
    (reference dataset/__init__.py:148-149 eval()s the file; we parse it with
    ast.literal_eval — same format, no code execution)."""
    import ast

    return ast.literal_eval(Path(path).read_text())
