"""The port's tokenizers (leccr_torch.data.tokenizers) against the JAX
package's on the same vocabularies and texts: CLIP's BPE (gzip'd and plain
merges, the 77-token layout), the Unigram tokenizer (.model with control,
unknown, unused and byte pieces; TSV), the sentencepiece reader and writer,
and CLIP's word split, which the port scans over unicodedata where the
JAX package uses the `regex` module."""

import gzip

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from leccr_tpu.data import tokenizers as jtok
from leccr_torch.data import tokenizers as ttok

WS = ttok.UnigramTokenizer.WS

# CJK (and its punctuation), accents, emoji, non-ASCII digits, mixed
# scripts, contractions, the specials, words longer than any piece
CORPUS = [
    "the dog runs over there",
    "Der Hund läuft über die Straße",
    "pes běží přes ulici, café — «quotes» … ¿3½?",
    "一只狗在跑。这里！",
    "犬が走っています（速い）１２３",
    "１２３ ４５ ٣٤٥ ๓๔",
    "मिश्रित scripts مع عربي",
    "ＡＢＣ ﬁﬂ ŉ Ⅻ ⅻ ²³",
    "emoji 🐕🐕 run 🏃🏽‍♀️ fast!!",
    "it's they're we've I'm you'll he'd IT'S 'ſ",
    "<|startoftext|>a<|endoftext|> <|STARTOFTEXT|>",
    "supercalifragilisticexpialidocious hellohellohellohello",
    "tabs\tand\nnewlines  and   spaces nbsp em",
    "aͅb ǅungla Σίσυφος",
    "",
]
WORDS = ("the dog runs over there a man rides his red bike hello world he "
         "der hund läuft über die straße 狗 跑 cafe").split()


@pytest.fixture(scope="module")
def clip_merges(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clip")
    merges = ["#version: 0.2", "t h", "th e</w>", "a</w>", "d o", "do g</w>",
              "r u", "ru n</w>", "o v", "ov er</w>", "e r", "er </w>",
              "h e", "l l", "he ll", "hell o</w>", "s t", "st r"]
    gz = tmp / "merges.txt.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    plain = tmp / "merges.txt"
    plain.write_text("\n".join(merges) + "\n", encoding="utf-8")
    return {"gz": str(gz), "plain": str(plain)}


def _sp_pieces():
    """A sentencepiece model's pieces: unknown, control, unused, normal and
    the 256 byte pieces."""
    return ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
             ("<unused>", 0.0, 5)]
            + [(WS + w, -2.0 - 0.1 * i, 1) for i, w in enumerate(WORDS)]
            + [(WS, -6.0, 1), ("lo", -4.0, 1), ("hel", -4.5, 1),
               ("s", -5.0, 1), ("er", -4.2, 1), ("e", -5.5, 1)]
            + [(f"<0x{b:02X}>", -10.0, 6) for b in range(256)])


@pytest.fixture(scope="module")
def unigram_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("uni")
    model = tmp / "uni.model"
    jtok.write_sentencepiece_model(str(model), _sp_pieces())
    tsv = tmp / "uni.tsv"
    jtok.write_tiny_unigram_vocab(str(tsv), WORDS)
    return {"model": str(model), "tsv": str(tsv)}


# ---------------------------------------------------------------- CLIP


@pytest.mark.parametrize("text", CORPUS)
def test_clip_words_equal_regex_split(text):
    pattern = jtok._clip_pattern()
    assert ttok._clip_words(text) == pattern.findall(text)
    cleaned = jtok.ClipBPETokenizer._clean(text)
    assert ttok._clip_words(cleaned) == pattern.findall(cleaned)


@settings(max_examples=300, deadline=None, database=None)
@given(st.text(alphabet=st.characters(blacklist_categories=("Cs", "Cn")),
               max_size=40))
def test_clip_words_equal_regex_split_on_random_text(text):
    """Code points assigned in Python's Unicode database; where `regex`
    knows a newer Unicode, it may class a code point that Python's leaves
    unassigned (Cn)."""
    assert ttok._clip_words(text) == jtok._clip_pattern().findall(text)


@pytest.mark.parametrize("kind", ["gz", "plain"])
def test_clip_bpe_ids_equal_jax(clip_merges, kind):
    mine = ttok.ClipBPETokenizer(clip_merges[kind])
    ref = jtok.ClipBPETokenizer(clip_merges[kind])
    assert mine.encoder == ref.encoder and mine.bpe_ranks == ref.bpe_ranks
    for text in CORPUS:
        assert mine.tokenize(text) == ref.tokenize(text), text
    got = mine.encode(CORPUS)
    np.testing.assert_array_equal(got, ref.encode(CORPUS))
    assert got.shape == (len(CORPUS), 77) and got.dtype == np.int32


def test_clip_bpe_layout_and_truncation_at_77(clip_merges):
    mine = ttok.ClipBPETokenizer(clip_merges["gz"])
    ref = jtok.ClipBPETokenizer(clip_merges["gz"])
    texts = ["dog " * 100, "the dog", ""]
    got = mine.encode(texts)
    np.testing.assert_array_equal(got, ref.encode(texts))
    assert (got[:, 0] == mine.sot).all()
    assert got[0, -1] == mine.eot and (got[0] != 0).all()  # truncated
    row = got[1][got[1] != 0]
    assert row[-1] == mine.eot and (got[1, len(row):] == 0).all()
    assert list(got[2, :2]) == [mine.sot, mine.eot]


# ------------------------------------------------------------- unigram


def test_sentencepiece_writer_equals_jax(tmp_path):
    a, b = tmp_path / "a.model", tmp_path / "b.model"
    ttok.write_sentencepiece_model(str(a), _sp_pieces())
    jtok.write_sentencepiece_model(str(b), _sp_pieces())
    assert a.read_bytes() == b.read_bytes()
    assert ttok.parse_sentencepiece_model(str(a)) == \
        jtok.parse_sentencepiece_model(str(a))


def test_sentencepiece_parser_skips_unknown_fields(tmp_path):
    model = tmp_path / "extra.model"
    ttok.write_sentencepiece_model(str(model), _sp_pieces()[:8])
    blob = model.read_bytes()
    # field 2 (length-delimited), 4 (varint), 5 (fixed32), 6 (fixed64),
    # and a SentencePiece with an unknown sub-field 7 (varint)
    extra = (b"\x12\x03abc" + b"\x20\xac\x02" + b"\x2d\x01\x02\x03\x04"
             + b"\x31" + bytes(range(8)))
    sub = b"\x0a\x01z" + b"\x15" + np.float32(-1.5).tobytes() + b"\x38\x05"
    model.write_bytes(extra + blob + b"\x0a" + bytes([len(sub)]) + sub
                      + b"\x12\x02xy")
    got = ttok.parse_sentencepiece_model(str(model))
    assert got == jtok.parse_sentencepiece_model(str(model))
    assert [p for p, _, _ in got] == [p for p, _, _ in _sp_pieces()[:8]] + [
        "z"]
    assert got[-1] == ("z", -1.5, 1)


@pytest.mark.parametrize("kind", ["model", "tsv"])
def test_unigram_ids_equal_jax(unigram_files, kind):
    mine = ttok.UnigramTokenizer(unigram_files[kind])
    ref = jtok.UnigramTokenizer(unigram_files[kind])
    assert (mine.pieces, mine.scores, mine.byte_ids) == (
        ref.pieces, ref.scores, ref.byte_ids)
    assert (mine.cls_id, mine.pad_id, mine.sep_id, mine.unk_id) == (
        ref.cls_id, ref.pad_id, ref.sep_id, ref.unk_id)
    for text in CORPUS:
        assert mine.tokenize(text) == ref.tokenize(text), text
    for max_length, pad_to in ((16, None), (8, 12), (64, None)):
        got = mine.encode(CORPUS, max_length, pad_to)
        want = ref.encode(CORPUS, max_length, pad_to)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_unigram_model_layout(unigram_files):
    """The HF XLM-R layout on .model loads: <s> <pad> </s> <unk> at 0..3,
    every sentencepiece id + 1; characters no piece covers become their
    UTF-8 bytes' pieces."""
    tok = ttok.UnigramTokenizer(unigram_files["model"])
    assert (tok.cls_id, tok.pad_id, tok.sep_id, tok.unk_id) == (0, 1, 2, 3)
    assert tok.pieces[WS + WORDS[0]] == 4 + 1  # sp id 4 (after 4 specials)
    assert "<unused>" not in tok.pieces
    ids = tok.tokenize("the €")
    assert ids[0] == tok.pieces[WS + "the"]
    assert ids[-3:] == [tok.byte_ids[b] for b in "€".encode("utf-8")]
    lowered = ttok.UnigramTokenizer(unigram_files["model"], lowercase=True)
    assert lowered.tokenize("THE Dog") == jtok.UnigramTokenizer(
        unigram_files["model"], lowercase=True).tokenize("THE Dog")


def test_tiny_unigram_vocab_equals_jax(tmp_path):
    a, b = tmp_path / "a.tsv", tmp_path / "b.tsv"
    ttok.write_tiny_unigram_vocab(str(a), WORDS)
    jtok.write_tiny_unigram_vocab(str(b), WORDS)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("kind,caption", [
    ("mbert", "mbert"), ("xlmr", "mbert"), ("xlmr", "clip")])
def test_make_tokenizers_follows_the_config(tmp_path, unigram_files,
                                            clip_merges, kind, caption):
    from leccr_torch.config import tiny_test_config

    cfg = tiny_test_config()
    vocab = tmp_path / "vocab.txt"
    ttok.write_tiny_wordpiece_vocab(str(vocab), WORDS)
    cfg.model.text.kind = kind
    cfg.model.caption_encoder_name = caption
    cfg.data.text_vocab = (unigram_files["tsv"] if kind == "xlmr"
                           else str(vocab))
    cfg.data.clip_bpe_vocab = clip_merges["gz"]
    text, cap = ttok.make_tokenizers(cfg)
    assert isinstance(text, ttok.UnigramTokenizer if kind == "xlmr"
                      else ttok.WordPieceTokenizer)
    if caption == "clip":
        assert isinstance(cap, ttok.ClipBPETokenizer)
    else:
        assert cap is text
