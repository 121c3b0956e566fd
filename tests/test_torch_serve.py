"""The port's Embedder against the JAX package's on the tiny config at the
same params: index feats and slots (atol 1e-4), and search_texts /
search_images results (scores atol 1e-4; ids wherever the scores are
distinct, since the two top-k orders of nearly equal scores may differ).
On an index with a duplicated row (exact ties), at torch CPU thread counts
1, 4 and 8: the tied rows score bit for bit alike and come lowest index
first, as `jax.lax.top_k` returns them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch.config import tiny_test_config as torch_tiny_config
from leccr_torch.data.tokenizers import (
    WordPieceTokenizer,
    write_tiny_wordpiece_vocab,
)
from leccr_torch.serve import Embedder as TorchEmbedder
from leccr_tpu.config import tiny_test_config
from leccr_tpu.data import tokenizers as jax_tokenizers
from leccr_tpu.models.leccr import LECCRModel
from leccr_tpu.serve import Embedder

ATOL = 1e-4
WORDS = "a man rides his red bike dog runs in the green field".split()
CAPTIONS = ["a man rides his red bike", "a dog runs", "the green field",
            "a red dog in the field", "his bike", "a man"]
QUERIES = ["a red bike", "dog in field", "man", "the green dog runs",
           "his field", "a bike"]  # 6 > batch_size 4: both search paths


@pytest.fixture(scope="module")
def embedders(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    write_tiny_wordpiece_vocab(str(vocab), WORDS)
    cfg = tiny_test_config()
    cfg.data.text_vocab = str(vocab)
    model = LECCRModel(cfg.model)
    rs = np.random.RandomState(0)
    res = cfg.model.vision.image_res
    ids = rs.randint(1, 512, (1, 8)).astype(np.int32)
    one = np.ones((1, 8), np.int32)
    batch = {"vision": rs.rand(1, res, res, 3).astype(np.float32),
             "text_ids_s": ids, "text_mask_s": one, "text_ids_t": ids,
             "text_mask_t": one, "caption_ids": ids, "caption_mask": one}
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jax.tree.map(jnp.asarray, batch))["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    jax_emb = Embedder(cfg, params, batch_size=4)

    tcfg = torch_tiny_config()
    tcfg.data.text_vocab = str(vocab)
    port = TorchEmbedder.from_config(tcfg, params=params, device="cpu",
                                     batch_size=4)
    images = rs.randint(0, 256, (len(CAPTIONS), res, res, 3)).astype(
        np.uint8)
    return jax_emb, port, images


def _same_ranking(got, want):
    """Scores agree everywhere; ids agree where the scores are distinct."""
    for g_row, w_row in zip(got, want):
        g_ids, g_s = zip(*g_row)
        w_ids, w_s = zip(*w_row)
        np.testing.assert_allclose(g_s, w_s, rtol=0, atol=ATOL)
        w_s = np.asarray(w_s)
        for j, wid in enumerate(w_ids):
            gaps = np.abs(np.delete(w_s, j) - w_s[j])
            if gaps.min() > 1e-3:
                assert g_ids[j] == wid


@pytest.fixture(scope="module")
def indexes(embedders):
    jax_emb, port, images = embedders
    return (jax_emb.build_image_index(images, CAPTIONS),
            port.build_image_index(images, CAPTIONS))


def test_index_matches_jax(indexes):
    want, got = indexes
    assert got.ids == want.ids and got.n_valid == len(CAPTIONS)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.slots.numpy(), np.asarray(want.slots),
                               rtol=0, atol=ATOL)


def test_embed_texts_matches_jax(embedders):
    jax_emb, port, _ = embedders
    np.testing.assert_allclose(port.embed_texts(QUERIES),
                               jax_emb.embed_texts(QUERIES), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("fusion", ["none", "raw", "minmax"])
@pytest.mark.parametrize("n_queries", [3, len(QUERIES)])
def test_search_texts_matches_jax(embedders, indexes, fusion, n_queries):
    jax_emb, port, _ = embedders
    want_index, got_index = indexes
    queries = QUERIES[:n_queries]
    want = jax_emb.search_texts(queries, want_index, k=4, fusion=fusion,
                                alpha=0.6)
    got = port.search_texts(queries, got_index, k=4, fusion=fusion,
                            alpha=0.6)
    assert len(got) == n_queries and all(len(r) == 4 for r in got)
    _same_ranking(got, want)


@pytest.mark.parametrize("threads", [1, 4, 8])
@pytest.mark.parametrize("fusion", ["none", "minmax"])
def test_search_texts_on_tied_rows_matches_jax(embedders, indexes, fusion,
                                               threads):
    """Index row 4 a copy of row 1 in both packages: every query scores
    them bit for bit alike, and both list id 1 right before id 4."""
    jax_emb, port, _ = embedders
    want_index, got_index = indexes

    def tie(x):
        x = np.array(x)
        x[4] = x[1]
        return x

    want_index = dataclasses.replace(
        want_index, feats=jnp.asarray(tie(want_index.feats)),
        slots=jnp.asarray(tie(want_index.slots)))
    got_index = dataclasses.replace(
        got_index, feats=torch.from_numpy(tie(got_index.feats)),
        slots=torch.from_numpy(tie(got_index.slots)))
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = port.search_texts(QUERIES, got_index, k=len(CAPTIONS),
                                fusion=fusion, alpha=0.6)
    finally:
        torch.set_num_threads(before)
    want = jax_emb.search_texts(QUERIES, want_index, k=len(CAPTIONS),
                                fusion=fusion, alpha=0.6)
    _same_ranking(got, want)
    for g_row, w_row in zip(got, want):
        g_ids, g_s = zip(*g_row)
        w_ids = [i for i, _ in w_row]
        at = g_ids.index("1")
        assert g_ids[at + 1] == "4" and g_s[at + 1] == g_s[at]
        assert w_ids.index("4") == w_ids.index("1") + 1


def test_search_images_matches_jax(embedders, indexes):
    jax_emb, port, _ = embedders
    want_index, got_index = indexes
    want = jax_emb.search_images(want_index, QUERIES, k=3)
    got = port.search_images(got_index, QUERIES, k=3)
    assert len(got) == len(CAPTIONS)
    _same_ranking(got, want)


def test_search_rejects_bad_requests(embedders, indexes):
    _, port, _ = embedders
    _, index = indexes
    assert port.search_texts([], index) == []
    with pytest.raises(ValueError, match="unknown fusion"):
        port.search_texts(["a"], index, fusion="max")


@pytest.mark.parametrize("lowercase", [False, True])
def test_wordpiece_copy_matches_jax(tmp_path, lowercase):
    """The port's own tokenizer copy: same vocab file, same ids/masks."""
    words = WORDS + ["Straße", "naïve", "日本"]
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    write_tiny_wordpiece_vocab(str(ours), words)
    jax_tokenizers.write_tiny_wordpiece_vocab(str(theirs), words)
    assert ours.read_text(encoding="utf-8") == theirs.read_text(
        encoding="utf-8")
    texts = ["A man, his RED bike!", "naïve Straße 日本語 dogs",
             "unknownword\tfield\u00a0runs", "", "the " * 40]
    got = WordPieceTokenizer(str(ours), lowercase=lowercase).encode(texts, 16)
    want = jax_tokenizers.WordPieceTokenizer(
        str(ours), lowercase=lowercase).encode(texts, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
