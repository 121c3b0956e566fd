"""ctypes binding of the native C++ tokenizers (the port's own copy of the
JAX package's `data/native_tokenizer.py`).

The sources are `leccr_torch/native/` (`wordpiece.cpp`, `unigram.cpp`,
`unicode_tables.h`, `Makefile`), copies of the repository's `native/`.  At
first use `build_native()` runs `make` on them into the gitignored
`leccr_torch/_build/native/`, under a name that hashes the sources (an
edited source is never served from a stale library), in a temporary
directory renamed into place (two processes that build at once each load a
whole library).  Nothing is built or loaded when this module is imported.

`NativeWordPieceTokenizer` and `NativeUnigramTokenizer` give the same ids
as `data.tokenizers.WordPieceTokenizer` / `UnigramTokenizer`
(tests/test_torch_native_tokenizer.py); they raise RuntimeError when the
library cannot be built, and the loaders then use the Python ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PACKAGE = Path(__file__).resolve().parents[1]
_NATIVE_DIR = _PACKAGE / "native"
_BUILD_DIR = _PACKAGE / "_build" / "native"
_SOURCES = ("wordpiece.cpp", "unigram.cpp", "unicode_tables.h", "Makefile")
_LIB_NAME = "libleccr_native.so"  # what the Makefile writes

_ABI_VERSION = 3  # must match wp_abi_version() in native/wordpiece.cpp

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_NATIVE_DIR / name).read_bytes())
    return _BUILD_DIR / f"libleccr_native-{digest.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> Optional[Path]:
    """Compile the shared library (`make -C leccr_torch/native`); returns
    its path, or None when there is no toolchain or the build fails."""
    path = library_path()
    if path.exists() and not force:
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR), f"BUILD={tmp}"],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        os.replace(Path(tmp) / _LIB_NAME, path)
    return path


def _abi_ok(lib) -> bool:
    try:
        return int(lib.wp_abi_version()) == _ABI_VERSION
    except AttributeError:
        return False  # a library without the version symbol


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    if not _abi_ok(lib):
        return None
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_encode_batch.restype = ctypes.c_int
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.uni_create.restype = ctypes.c_void_p
    lib.uni_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_int]
    lib.uni_destroy.argtypes = [ctypes.c_void_p]
    lib.uni_encode_batch.restype = ctypes.c_int
    lib.uni_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def _encode(fn, handle, texts: Sequence[str], max_length: int,
            pad_to: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    width = pad_to or max_length
    n = len(texts)
    ids = np.zeros((n, width), np.int32)
    mask = np.zeros((n, width), np.int32)
    arr = (ctypes.c_char_p * n)(*[t.encode("utf-8") for t in texts])
    rc = fn(handle, arr, n, max_length, width,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: {rc}")
    return ids, mask


class NativeWordPieceTokenizer:
    """Batch encoder backed by the C++ library, with the Python
    WordPieceTokenizer's `encode(texts, max_length, pad_to)` contract.

    Uncased mode runs fully native: the library lowercases per character
    over the full Unicode range (Final_Sigma and U+0130 included) and
    strips accents by NFD, from generated tables; `strip_accents` defaults
    to `lowercase`, as in HF."""

    def __init__(self, vocab_file: str, lowercase: bool = False,
                 strip_accents: Optional[bool] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native tokenizer library unavailable")
        self._lib = lib
        self.lowercase = lowercase
        self.strip_accents = (lowercase if strip_accents is None
                              else strip_accents)
        flags = (1 if self.lowercase else 0) | (2 if self.strip_accents else 0)
        self._handle = lib.wp_create(str(vocab_file).encode(), flags)
        if not self._handle:
            raise RuntimeError(f"failed to load vocab {vocab_file}")

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.wp_destroy(self._handle)
            self._handle = None

    def encode(self, texts: Sequence[str], max_length: int,
               pad_to: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        return _encode(self._lib.wp_encode_batch, self._handle, texts,
                       max_length, pad_to)


class NativeUnigramTokenizer:
    """Batch encoder for the Unigram (XLM-R) tokenizer, backed by the C++
    library (`native/unigram.cpp`).

    A `data.tokenizers.UnigramTokenizer` (TSV or sentencepiece `.model`)
    supplies the resolved piece, score and id tables; the C++ side runs
    the Viterbi segmentation, threaded over the batch.  lowercase=True is
    refused with RuntimeError: Python's str.lower() applies the contextual
    Final_Sigma rule, which the native per-character lowering does not."""

    def __init__(self, py_tok):
        if py_tok.lowercase:
            raise RuntimeError(
                "native unigram tokenizer requires lowercase=False")
        lib = _load()
        if lib is None:
            raise RuntimeError("native tokenizer library unavailable")
        self._lib = lib
        pieces = list(py_tok.pieces.items())
        n = len(pieces)
        arr = (ctypes.c_char_p * n)(*[p.encode("utf-8") for p, _ in pieces])
        ids = (ctypes.c_int32 * n)(*[i for _, i in pieces])
        scores = (ctypes.c_double * n)(
            *[py_tok.scores.get(p, 0.0) for p, _ in pieces])
        byte_ids = (ctypes.c_int32 * 256)(
            *[py_tok.byte_ids.get(b, -1) for b in range(256)])
        self._handle = lib.uni_create(
            arr, ids, scores, n, byte_ids, py_tok.cls_id, py_tok.pad_id,
            py_tok.sep_id, py_tok.unk_id, py_tok.unk_penalty, 0)
        if not self._handle:
            raise RuntimeError("uni_create failed")
        self.cls_id = py_tok.cls_id
        self.pad_id = py_tok.pad_id
        self.sep_id = py_tok.sep_id

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.uni_destroy(self._handle)
            self._handle = None

    def encode(self, texts: Sequence[str], max_length: int,
               pad_to: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        return _encode(self._lib.uni_encode_batch, self._handle, texts,
                       max_length, pad_to)


def native_counterpart(tokenizer):
    """The native encoder of a Python WordPiece or Unigram tokenizer, or
    None where there is none (the CLIP BPE, a lowercasing Unigram) or the
    library does not build."""
    from leccr_torch.data.tokenizers import (
        UnigramTokenizer,
        WordPieceTokenizer,
    )

    try:
        if isinstance(tokenizer, WordPieceTokenizer):
            return NativeWordPieceTokenizer(
                tokenizer.vocab_file, lowercase=tokenizer.lowercase,
                strip_accents=tokenizer.strip_accents)
        if isinstance(tokenizer, UnigramTokenizer):
            return NativeUnigramTokenizer(tokenizer)
    except RuntimeError:
        return None
    return None
