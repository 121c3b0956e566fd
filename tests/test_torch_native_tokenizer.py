"""The port's native C++ tokenizers (leccr_torch.data.native_tokenizer,
built from leccr_torch/native/) against the port's Python tokenizers and
the JAX package's native ones, on the same vocabularies and texts."""

import filecmp
import subprocess
from pathlib import Path

import numpy as np
import pytest

import leccr_tpu.data.native_tokenizer as jnative
from leccr_torch.config import tiny_test_config
from leccr_torch.data import native_tokenizer as tnative
from leccr_torch.data import tokenizers as ttok
from leccr_torch.data.pipeline import TrainLoader
from leccr_torch.data.text import normalize_caption
from leccr_torch.train.trainer import build_datasets

ROOT = Path(__file__).resolve().parent.parent
WS = ttok.UnigramTokenizer.WS
WORDS = ("a man rides his red bike near the bridge two dogs running across "
         "green field cat he hello world 猫 犬 Straße über").split()
TEXTS = [
    "a man rides his red bike",
    "two dogs, running!  across the green field",
    "unknownwordhere and the 猫 sat with the 犬",
    "ÜBER die Straße, Σίσυφος ΣΑΣ İstanbul",
    "hello\u00a0world\u2009he\u3000a man\u0085rides\u200b",
    "ħ849 ψcompletely-unseen ©∂字 🐕",
    "",
    "a " * 80,
]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's binding over its own library built from native/
    into a temporary directory (the JAX package's tests rebuild
    native/build/ in place, perhaps at this very moment)."""
    build = tmp_path_factory.mktemp("jax_native")
    subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={build}"],
                   check=True, capture_output=True)
    lib = build / "libleccr_native.so"
    saved = (jnative.build_native, jnative._lib)
    jnative.build_native = lambda force=False: lib
    jnative._lib = None
    yield jnative
    jnative.build_native, jnative._lib = saved


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab")
    wp = tmp / "vocab.txt"
    ttok.write_tiny_wordpiece_vocab(str(wp), WORDS + ["über", "strasse"])
    tsv = tmp / "uni.tsv"
    ttok.write_tiny_unigram_vocab(str(tsv), WORDS)
    model = tmp / "uni.model"
    ttok.write_sentencepiece_model(str(model), (
        [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
        + [(WS + w, -2.0 - 0.25 * (i % 3), 1) for i, w in enumerate(WORDS)]
        + [(WS, -6.0, 1), ("he", -4.0, 1), ("ll", -4.0, 1), ("o", -5.0, 1)]
        + [(f"<0x{b:02X}>", -10.0, 6) for b in range(256)]))
    return {"wordpiece": str(wp), "tsv": str(tsv), "model": str(model)}


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_sources_are_the_repository_native_copies():
    for name in tnative._SOURCES:
        assert filecmp.cmp(ROOT / "native" / name,
                           tnative._NATIVE_DIR / name, shallow=False), name


def test_build_is_named_by_the_sources():
    path = tnative.build_native(force=True)
    assert path == tnative.library_path() and path.exists()
    assert path.parent == ROOT / "leccr_torch" / "_build" / "native"


@pytest.mark.parametrize("lowercase", [False, True])
def test_native_wordpiece_equals_python_and_jax(files, jax_native, lowercase):
    py = ttok.WordPieceTokenizer(files["wordpiece"], lowercase=lowercase)
    nat = tnative.NativeWordPieceTokenizer(files["wordpiece"],
                                           lowercase=lowercase)
    ref = jax_native.NativeWordPieceTokenizer(files["wordpiece"],
                                              lowercase=lowercase)
    for max_length, pad_to in ((16, None), (64, 80)):
        got = nat.encode(TEXTS, max_length, pad_to)
        _equal(got, py.encode(TEXTS, max_length, pad_to))
        _equal(got, ref.encode(TEXTS, max_length, pad_to))


@pytest.mark.parametrize("kind", ["tsv", "model"])
def test_native_unigram_equals_python_and_jax(files, jax_native, kind):
    from leccr_tpu.data.tokenizers import UnigramTokenizer

    py = ttok.UnigramTokenizer(files[kind])
    nat = tnative.NativeUnigramTokenizer(py)
    ref = jax_native.NativeUnigramTokenizer(UnigramTokenizer(files[kind]))
    for max_length in (10, 48):
        got = nat.encode(TEXTS, max_length)
        _equal(got, py.encode(TEXTS, max_length))
        _equal(got, ref.encode(TEXTS, max_length))
    big = nat.encode(TEXTS * 200, 48)  # threaded over the batch
    _equal((big[0][:len(TEXTS)], big[1][:len(TEXTS)]), py.encode(TEXTS, 48))


def test_native_counterpart_and_its_refusals(files, monkeypatch):
    wp = ttok.WordPieceTokenizer(files["wordpiece"])
    uni = ttok.UnigramTokenizer(files["tsv"])
    assert isinstance(tnative.native_counterpart(wp),
                      tnative.NativeWordPieceTokenizer)
    assert isinstance(tnative.native_counterpart(uni),
                      tnative.NativeUnigramTokenizer)
    # a lowercasing unigram (str.lower's Final_Sigma) stays in Python
    assert tnative.native_counterpart(
        ttok.UnigramTokenizer(files["tsv"], lowercase=True)) is None
    # no library (no toolchain, a failed build): the Python tokenizer
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build_native", lambda force=False: None)
    assert tnative.native_counterpart(wp) is None
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.NativeWordPieceTokenizer(files["wordpiece"])


@pytest.mark.parametrize("native", [True, False])
def test_train_loader_says_which_tokenizer_it_used(tmp_path, monkeypatch,
                                                   native):
    """The xlmr loader tokenizes natively where the library builds, else
    in Python: the same tokens either way, and `native` says which."""
    if not native:
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "build_native", lambda force=False: None)
    cfg = tiny_test_config(**{"data.dataset": "synthetic",
                              "data.synthetic_size": 8,
                              "model.text.kind": "xlmr"})
    cfg.output_dir = str(tmp_path)
    train, _, _ = build_datasets(cfg)
    tok = ttok.UnigramTokenizer(cfg.data.text_vocab)
    loader = TrainLoader(train, tok, cfg.data, batch_size=4, num_workers=1)
    assert loader.native is native
    assert isinstance(loader._encoder, tnative.NativeUnigramTokenizer) \
        is native
    texts = [train.caption_maps[0][c] for c in train.cap_ids]
    want = tok.encode([normalize_caption(t, cfg.data.max_words)
                       for t in texts], cfg.data.max_tokens)
    assert loader.text_tokens[0] == [
        row[: int(m.sum())].tolist() for row, m in zip(*want)]
