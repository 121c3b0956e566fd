"""Offline tokenizers (the port's own copy of the JAX package's
`data/tokenizers.py`): BERT WordPiece, CLIP byte-BPE and the
SentencePiece-unigram tokenizer of XLM-R, with a reader and writer for
sentencepiece `.model` files.

Pure Python with no dependency beyond numpy: vocabularies are local files,
and every batch is padded to a fixed width.  The JAX package splits CLIP's
words with the third-party `regex` module (for `\\p{L}` / `\\p{N}`); the
port scans them itself over `unicodedata` categories, with the same
result (`_clip_words`).
"""

from __future__ import annotations

import functools
import gzip
import html
import re
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


# --------------------------------------------------------------------------
# CLIP byte-BPE (reference clip/simple_tokenizer.py:62-132, clip/clip.py:197)
# --------------------------------------------------------------------------

@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# the pattern's literal alternatives, in its order
_CLIP_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re",
                  "'ve", "'m", "'ll", "'d")


def _fold(ch: str) -> str:
    """Simple case folding, as far as CLIP's literals need it: the long s
    (U+017F) folds to "s", every other character to its lowercase."""
    return "s" if ch == "\u017f" else ch.lower()


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _is_skipped(ch: str) -> bool:
    """What no alternative of the pattern matches: `regex`'s \\s
    (str.isspace() but for the separators U+001C-U+001F), and U+0345
    (combining ypogegrammeni: not a letter, but under IGNORECASE its case
    variant, iota, is one, so the negated class refuses it too)."""
    return (ch.isspace() and not "\x1c" <= ch <= "\x1f") or ch == "\u0345"


def _clip_words(text: str) -> List[str]:
    r"""The words of CLIP's split pattern (reference
    clip/simple_tokenizer.py:78), which the JAX package runs through
    `regex` with IGNORECASE:

        <\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d
        |[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+

    At each position the alternatives are tried in that order (the
    literals case-insensitively); a letter run, one number, or a run of
    what is neither whitespace, letter nor number; whitespace (and U+0345)
    is skipped.
    Letters are the categories L*, numbers N*, from `unicodedata`: CJK
    punctuation is not a letter, and non-ASCII digits are numbers."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        for lit in _CLIP_LITERALS if text[i] in "<'" else ():
            end = i + len(lit)
            if end <= n and all(_fold(c) == x
                                for c, x in zip(text[i:end], lit)):
                words.append(text[i:end])
                i = end
                break
        else:
            ch = text[i]
            if _is_letter(ch):
                end = i + 1
                while end < n and _is_letter(text[end]):
                    end += 1
            elif _is_number(ch):
                end = i + 1
            elif _is_skipped(ch):
                i += 1
                continue
            else:
                end = i + 1
                while end < n and not (_is_skipped(text[end])
                                       or _is_letter(text[end])
                                       or _is_number(text[end])):
                    end += 1
            words.append(text[i:end])
            i = end
    return words


class ClipBPETokenizer:
    """CLIP's lowercasing byte-BPE over a gzip'd merges file.

    Token layout per text: <|startoftext|> bpe… <|endoftext|>, padded with 0
    to context_length=77 and truncated (reference clip/clip.py:197-237)."""

    def __init__(self, merges_file: str, context_length: int = 77):
        self.byte_encoder = _bytes_to_unicode()
        opener = gzip.open if merges_file.endswith(".gz") else open
        with opener(merges_file, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.context_length = context_length
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @staticmethod
    def _clean(text: str) -> str:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text)
        return text.strip().lower()

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _clip_words(self._clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(tok).split(" "))
        return ids

    def encode(self, texts: Sequence[str],
               context_length: int | None = None) -> np.ndarray:
        n = context_length or self.context_length
        out = np.zeros((len(texts), n), np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot] + self.tokenize(text) + [self.eot]
            if len(ids) > n:  # truncate, keep EOT last (clip/clip.py:230-233)
                ids = ids[: n - 1] + [self.eot]
            out[row, : len(ids)] = ids
        return out


# --------------------------------------------------------------------------
# Unigram (SentencePiece-style) tokenizer — XLM-R support
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# SentencePiece ModelProto wire-format reader (no protobuf/sentencepiece dep)
# --------------------------------------------------------------------------

_SP_TYPE_NORMAL, _SP_TYPE_UNKNOWN, _SP_TYPE_CONTROL = 1, 2, 3
_SP_TYPE_USER, _SP_TYPE_UNUSED, _SP_TYPE_BYTE = 4, 5, 6


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire == 1:  # fixed64
        pos += 8
    elif wire == 2:  # length-delimited
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire == 5:  # fixed32
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire}")
    return pos


def parse_sentencepiece_model(path: str) -> List[Tuple[str, float, int]]:
    """Parse a sentencepiece ``.model`` file (serialized ModelProto) into
    ``[(piece, score, type), ...]`` in id order, with a hand-rolled protobuf
    wire-format reader — the environment has neither ``sentencepiece`` nor
    ``protobuf``, and only the ``pieces`` field (ModelProto field 1;
    SentencePiece sub-fields: piece=1 string, score=2 float, type=3 enum,
    default NORMAL) is needed for inference.  Unknown fields are skipped by
    wire type, so real model files (which carry trainer/normalizer specs)
    parse fine."""
    buf = Path(path).read_bytes()
    pieces: List[Tuple[str, float, int]] = []
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            ln, pos = _read_varint(buf, pos)
            sub, end = buf, pos + ln
            piece, score, ptype = "", 0.0, _SP_TYPE_NORMAL
            while pos < end:
                stag, pos = _read_varint(sub, pos)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    sln, pos = _read_varint(sub, pos)
                    piece = sub[pos:pos + sln].decode("utf-8")
                    pos += sln
                elif sfield == 2 and swire == 5:
                    score = float(
                        np.frombuffer(sub[pos:pos + 4], "<f4")[0])
                    pos += 4
                elif sfield == 3 and swire == 0:
                    ptype, pos = _read_varint(sub, pos)
                else:
                    pos = _skip_field(sub, pos, swire)
            pieces.append((piece, score, ptype))
        else:
            pos = _skip_field(buf, pos, wire)
    return pieces


def write_sentencepiece_model(
        path: str, pieces: Sequence[Tuple[str, float, int]]) -> None:
    """Serialize ``[(piece, score, type), ...]`` as a ModelProto ``pieces``
    list — the inverse of :func:`parse_sentencepiece_model`, used to build
    tiny ``.model`` files for tests/synthetic data without the sentencepiece
    library."""
    def varint(v: int) -> bytes:
        out = b""
        while True:
            b, v = v & 0x7F, v >> 7
            out += bytes([b | (0x80 if v else 0)])
            if not v:
                return out

    blob = b""
    for piece, score, ptype in pieces:
        raw = piece.encode("utf-8")
        msg = b"\x0a" + varint(len(raw)) + raw  # field 1: piece
        msg += b"\x15" + np.float32(score).tobytes()  # field 2: score
        if ptype != _SP_TYPE_NORMAL:
            msg += b"\x18" + varint(ptype)  # field 3: type
        blob += b"\x0a" + varint(len(msg)) + msg
    Path(path).write_bytes(blob)


class UnigramTokenizer:
    """SentencePiece-unigram tokenizer for the XLM-R text-tower option
    (TextConfig.kind == 'xlmr'); the reference's YAML names xlm-roberta but
    its live code never loads it (SURVEY.md §5 config lies).

    Loads either a real sentencepiece ``.model`` file (parsed directly from
    the protobuf wire format — see :func:`parse_sentencepiece_model`) or a
    TSV vocab (``piece\\tlog_prob`` per line, line number = token id).

    For ``.model`` loads, ids follow the HF ``XLMRobertaTokenizer``
    convention: ``<s>``/``<pad>``/``</s>``/``<unk>`` are 0..3 and every
    sentencepiece id is shifted by +1 (the fairseq offset), so encodings are
    drop-in compatible with HF XLM-R embeddings.  TSV loads use line numbers
    verbatim (ids 0..3 are expected to be <s>, <pad>, </s>, <unk>).

    Whitespace is the ▁ (U+2581) marker prefixed to each word; segmentation
    is Viterbi max-sum of piece log-probs.  Characters outside the vocab use
    byte-fallback (``<0xXX>`` BYTE pieces, sentencepiece semantics) when the
    model defines them, else a per-character <unk>.  Exposes the same
    encode() contract as WordPieceTokenizer (cls/sep/pad aliases map to
    <s>/</s>/<pad>)."""

    WS = "▁"

    def __init__(self, vocab_file: str, lowercase: bool = False):
        self.vocab_file = str(vocab_file)
        self.lowercase = lowercase
        self.pieces: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.byte_ids: Dict[int, int] = {}  # byte value -> token id
        if self.vocab_file.endswith(".model"):
            self._load_model(self.vocab_file)
        else:
            self._load_tsv(self.vocab_file)
        self.vocab = self.pieces  # WordPiece-compatible alias
        self.cls_id = self.pieces.get("<s>", 0)
        self.pad_id = self.pieces.get("<pad>", 1)
        self.sep_id = self.pieces.get("</s>", 2)
        self.unk_id = self.pieces.get("<unk>", 3)
        self.max_piece_len = max((len(p) for p in self.pieces), default=1)
        self.unk_penalty = min(self.scores.values(), default=0.0) - 10.0

    def _load_tsv(self, path: str) -> None:
        for i, line in enumerate(
                Path(path).read_text(encoding="utf-8").splitlines()):
            if not line:
                continue
            parts = line.split("\t")
            piece = parts[0]
            score = float(parts[1]) if len(parts) > 1 else 0.0
            self.pieces[piece] = i
            self.scores[piece] = score

    def _load_model(self, path: str) -> None:
        """HF XLM-R id layout: fairseq specials at 0..3, sentencepiece id i
        -> i + 1 for every real piece (the sp model's own <unk>/<s>/</s> at
        0..2 are shadowed by the fairseq ids)."""
        raw = parse_sentencepiece_model(path)
        self.pieces = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
        self.scores = {}
        for sp_id, (piece, score, ptype) in enumerate(raw):
            if ptype in (_SP_TYPE_CONTROL, _SP_TYPE_UNKNOWN,
                         _SP_TYPE_UNUSED):
                continue
            tok_id = sp_id + 1  # fairseq offset
            if ptype == _SP_TYPE_BYTE:  # "<0xXX>" byte-fallback piece
                self.byte_ids[int(piece[1:-1], 16)] = tok_id
                continue  # byte pieces never match text directly
            self.pieces[piece] = tok_id
            self.scores[piece] = score

    def _unk_fallback(self, ch: str) -> List[int]:
        """Byte-fallback (sentencepiece --byte_fallback): unseen characters
        emit their UTF-8 bytes as <0xXX> pieces; plain <unk> otherwise."""
        if self.byte_ids:
            return [self.byte_ids.get(b, self.unk_id)
                    for b in ch.encode("utf-8")]
        return [self.unk_id]

    def _viterbi(self, text: str) -> List[int]:
        n = len(text)
        best = [float("-inf")] * (n + 1)
        # (start, ids) — ids is >1 token only for byte-fallback chars
        back: List[Tuple[int, Tuple[int, ...]]] = [(-1, ())] * (n + 1)
        best[0] = 0.0
        for end in range(1, n + 1):
            lo = max(0, end - self.max_piece_len)
            for start in range(lo, end):
                if best[start] == float("-inf"):
                    continue
                piece = text[start:end]
                if piece in self.pieces:
                    cand = best[start] + self.scores[piece]
                    if cand > best[end]:
                        best[end] = cand
                        back[end] = (start, (self.pieces[piece],))
            if best[end] == float("-inf"):  # unk fallback: single char
                best[end] = best[end - 1] + self.unk_penalty
                back[end] = (end - 1, tuple(self._unk_fallback(text[end - 1])))
        chunks: List[Tuple[int, ...]] = []
        pos = n
        while pos > 0:
            start, pids = back[pos]
            chunks.append(pids)
            pos = start
        return [pid for pids in reversed(chunks) for pid in pids]

    def tokenize(self, text: str) -> List[int]:
        if self.lowercase:
            text = text.lower()
        words = text.split()
        ids: List[int] = []
        for word in words:
            ids.extend(self._viterbi(self.WS + word))
        return ids

    def encode(self, texts: Sequence[str], max_length: int,
               pad_to: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """<s> pieces </s>, truncated/padded like the WordPiece encoder."""
        width = pad_to or max_length
        ids = np.full((len(texts), width), self.pad_id, np.int32)
        mask = np.zeros((len(texts), width), np.int32)
        for row, text in enumerate(texts):
            toks = self.tokenize(text)[: max_length - 2]
            seq = [self.cls_id] + toks + [self.sep_id]
            ids[row, : len(seq)] = seq
            mask[row, : len(seq)] = 1
        return ids, mask


def write_tiny_unigram_vocab(path: str, words: Iterable[str]) -> None:
    """Build a small unigram TSV vocab covering `words` (tests/synthetic):
    specials, whole words (high score), then characters (low score)."""
    ws = UnigramTokenizer.WS
    lines = [("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    seen = {p for p, _ in lines}
    for w in words:
        piece = ws + w
        if piece not in seen:
            seen.add(piece)
            lines.append((piece, -2.0))
    chars = {c for w in words for c in w} | {ws}
    for c in sorted(chars):
        if c not in seen:
            seen.add(c)
            lines.append((c, -8.0))
    Path(path).write_text(
        "\n".join(f"{p}\t{s}" for p, s in lines), encoding="utf-8")


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


def make_tokenizers(cfg):
    """(text tokenizer, caption tokenizer) of a LECCRConfig, as the JAX
    trainer and Embedder choose them: the Unigram tokenizer over
    `data.text_vocab` for `text.kind: xlmr`, else WordPiece; CLIP's BPE
    over `data.clip_bpe_vocab` for `caption_encoder_name: clip`, else the
    text tokenizer."""
    if cfg.model.text.kind == "xlmr":
        text = UnigramTokenizer(cfg.data.text_vocab,
                                lowercase=cfg.data.lowercase)
    else:
        text = WordPieceTokenizer(cfg.data.text_vocab,
                                  lowercase=cfg.data.lowercase)
    if cfg.model.caption_encoder_name == "clip":
        return text, ClipBPETokenizer(cfg.data.clip_bpe_vocab)
    return text, text
