"""Offline BERT WordPiece tokenizer (the port's own copy).

Same behaviour as the JAX package's `WordPieceTokenizer`: a pure-Python,
dependency-free tokenizer over a local vocab file, padding every batch to a
fixed width.  The Unigram, CLIP-BPE and native C++ tokenizers come with the
slices that need them.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# BERT WordPiece
# --------------------------------------------------------------------------

def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (
            123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT-style tokenizer: basic tokenization + greedy WordPiece.

    The same as the JAX package's WordPieceTokenizer, which matches HF
    BertTokenizer given the same vocab (tests/test_tokenizers.py); this
    copy is held against it in tests/test_torch_serve.py.
    `lowercase=False` for bert-base-multilingual-cased."""

    def __init__(self, vocab_file: str, lowercase: bool = False,
                 strip_accents: bool | None = None):
        self.vocab_file = str(vocab_file)
        self.vocab: Dict[str, int] = {}
        for i, line in enumerate(
                Path(vocab_file).read_text(encoding="utf-8").splitlines()):
            self.vocab[line.strip("\n")] = i
        self.lowercase = lowercase
        # HF semantics: strip_accents defaults to the lowercase flag
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.unk = "[UNK]"
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.max_chars_per_word = 100

    # --- basic tokenizer ---------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _basic_tokens(self, text: str) -> List[str]:
        text = self._split_cjk(self._clean(text))
        tokens = []
        for tok in text.strip().split():
            if self.lowercase:
                # per-character, matching HF end-to-end: the base
                # PreTrainedTokenizer.tokenize lowercases char-by-char via
                # re.sub BEFORE BasicTokenizer, so Final_Sigma never fires
                tok = "".join(c.lower() for c in tok)
            if self.strip_accents:
                tok = "".join(
                    c for c in unicodedata.normalize("NFD", tok)
                    if unicodedata.category(c) != "Mn")
            # split on punctuation
            buf: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    tokens.extend(["".join(buf)] if buf else [])
                    tokens.append(ch)
                    buf = []
                else:
                    buf.append(ch)
            if buf:
                tokens.append("".join(buf))
        return tokens

    # --- wordpiece ----------------------------------------------------
    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_chars_per_word:
            return [self.unk]
        pieces: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self._basic_tokens(text):
            out.extend(self._wordpiece(tok))
        return out

    def encode(
        self,
        texts: Sequence[str],
        max_length: int,
        pad_to: int | None = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """[CLS] tokens [SEP] with truncation to max_length and padding to a
        fixed width -> (ids [B, W], mask [B, W]) int32."""
        width = pad_to or max_length
        ids = np.full((len(texts), width), self.pad_id, np.int32)
        mask = np.zeros((len(texts), width), np.int32)
        for row, text in enumerate(texts):
            toks = self.tokenize(text)[: max_length - 2]
            seq = [self.cls_id] + [
                self.vocab.get(t, self.vocab[self.unk]) for t in toks
            ] + [self.sep_id]
            ids[row, : len(seq)] = seq
            mask[row, : len(seq)] = 1
        return ids, mask


def write_tiny_wordpiece_vocab(path: str, words: Iterable[str]) -> None:
    """Build a small WordPiece vocab covering `words` (tests/synthetic)."""
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    seen = set(tokens)
    for w in words:
        for tok in (w, *(f"##{c}" for c in w), *w):
            if tok not in seen:
                seen.add(tok)
                tokens.append(tok)
    Path(path).write_text("\n".join(tokens), encoding="utf-8")
