"""The port's streaming ranker against the JAX package's: exact rank
equality for every fusion, several block sizes and torch CPU thread counts
1, 4 and 8, on embeddings with duplicated rows (exact score ties), plus the
Recall@K metric dict and the fixed-order score product."""

import numpy as np
import pytest
import torch

from leccr_torch.eval.retrieval import (
    itm_metrics_from_ranks,
    pairwise_scores,
    retrieval_ranks,
    score_matrix,
)
from leccr_tpu.eval import retrieval as jax_retrieval

N_IMG, N_TXT, N_Q, E = 11, 29, 3, 16


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    img = _unit(rs.randn(N_IMG, E))
    img[7] = img[2]  # duplicated image rows -> tied columns
    img[10] = img[2]
    txt = _unit(rs.randn(N_TXT, E))
    txt[5] = txt[4]  # duplicated texts -> tied rows
    txt[20] = txt[4]
    txt[:N_IMG] = 0.6 * txt[:N_IMG] + 0.4 * img  # some signal
    txt = _unit(txt)
    slots = _unit(rs.randn(N_IMG, N_Q, E))
    slots[7] = slots[2]
    txt2img = np.arange(N_TXT) % N_IMG
    img2txt = {i: [t for t in range(N_TXT) if t % N_IMG == i]
               for i in range(N_IMG)}
    return img, txt, slots, txt2img, img2txt


@pytest.fixture(params=[1, 4, 8], ids=lambda n: f"threads{n}")
def threads(request):
    """torch's CPU thread count for one test, restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(before)


@pytest.mark.parametrize("fusion", ["none", "raw", "minmax"])
@pytest.mark.parametrize("block", [3, 4, 256])
def test_ranks_equal_jax(data, fusion, block, threads):
    img, txt, slots, txt2img, img2txt = data
    want = jax_retrieval.retrieval_ranks(
        img, txt, txt2img, img2txt, slots=slots, fusion=fusion, alpha=0.7,
        block=block)
    got = retrieval_ranks(
        img, txt, txt2img, img2txt, slots=slots, fusion=fusion, alpha=0.7,
        block=block, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_ranks_follow_the_stable_argsort_rule(data):
    """Dense numpy check: rank = #greater + #equal-with-larger-index."""
    img, txt, _, txt2img, img2txt = data
    i2t, t2i = retrieval_ranks(torch.from_numpy(img), torch.from_numpy(txt),
                               txt2img, img2txt, block=4)
    s = img @ txt.T
    for t in range(N_TXT):
        col, g = s[:, t], txt2img[t]
        order = np.argsort(col, kind="stable")[::-1]
        assert t2i[t] == int(np.nonzero(order == g)[0][0])
    for i in range(N_IMG):
        order = list(np.argsort(s[i], kind="stable")[::-1])
        assert i2t[i] == min(order.index(t) for t in img2txt[i])


def test_metrics_equal_jax(data):
    img, txt, _, txt2img, img2txt = data
    ranks = retrieval_ranks(img, txt, txt2img, img2txt, device="cpu")
    got = itm_metrics_from_ranks(*ranks)
    want = jax_retrieval.itm_metrics_from_ranks(*ranks)
    assert len(got) == 13 and got == want


def test_score_matrix_and_bad_fusion(data):
    img, txt, _, txt2img, img2txt = data
    np.testing.assert_allclose(
        score_matrix(torch.from_numpy(img), torch.from_numpy(txt)).numpy(),
        np.asarray(jax_retrieval.score_matrix(img, txt)), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="needs slots"):
        retrieval_ranks(img, txt, txt2img, img2txt, fusion="minmax",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown fusion"):
        retrieval_ranks(img, txt, txt2img, img2txt, fusion="max",
                        device="cpu")


@pytest.mark.parametrize("chunk_elems", [1, 100, 1 << 25])
def test_pairwise_scores_give_equal_rows_equal_bits(data, threads,
                                                    chunk_elems):
    """Equal rows score bit for bit alike wherever they sit (the tie the
    ranker's rule counts), within 1e-6 of the dense product, for any
    column chunking."""
    img, txt, _, _, _ = data
    s = pairwise_scores(torch.from_numpy(img), torch.from_numpy(txt),
                        chunk_elems).numpy()
    assert s.shape == (N_IMG, N_TXT)
    np.testing.assert_array_equal(s[7], s[2])
    np.testing.assert_array_equal(s[10], s[2])
    t = pairwise_scores(torch.from_numpy(txt), torch.from_numpy(img),
                        chunk_elems).numpy()
    np.testing.assert_array_equal(t[:, 7], t[:, 2])  # equal rows of b
    np.testing.assert_array_equal(t[:, 10], t[:, 2])
    np.testing.assert_allclose(s, img @ txt.T, rtol=0, atol=1e-6)
