"""The port's row-sharded serving index (`serve.shard_index`,
`load_index(mesh=...)`, the sharded search) against its unsharded index
and the JAX package's `shard_index` on a 4-device CPU mesh.

The index: the tiny Embedder's 6 images with their captions, plus copies
of rows 1, 4 and 0 (9 rows: equal rows tie, and 9 does not split over 4
shards, so 3 pad rows are masked), f32 and int8, searched with fusion
none, raw and minmax, k = 4 and k = 7 (more than a shard's 3 rows).

- Port sharded over ["cpu"] * 4 against port unsharded: ids and scores
  bit for bit, on the padded (3 queries) and the chunked (6 queries)
  query paths at 1 and 8 CPU threads, and search_images; equal rows
  lowest id first.
- Port sharded against JAX's sharded search on the same index arrays at
  the same params: scores within ATOL = 1e-4 (the two packages' query
  embeddings differ by that much, tests/test_torch_serve.py), ids equal
  where scores are 1e-3 apart, and each tie group in the same order.
- A JAX save loads sharded (`load_index(mesh=...)`) and searches as the
  unsharded load does; a sharded save equals the unsharded one byte for
  byte; quantize, merge and remove raise JAX's ValueErrors on it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from leccr_torch import serve as port
from leccr_tpu import serve as ref
from test_torch_serve import (  # noqa: F401  (embedders is a fixture)
    CAPTIONS,
    QUERIES,
    _same_ranking,
    embedders,
)

W = 4
DEVICES = ["cpu"] * W
COPIES = [1, 4, 0]  # rows repeated at the end: ties across shards


@pytest.fixture(scope="module")
def indexes(embedders):
    """(JAX index, port index), f32, with the repeated rows, from the
    port's embeddings of the images (both packages get the same arrays)."""
    _, emb, images = embedders
    built = emb.build_image_index(images, CAPTIONS,
                                  ids=[f"img{i}" for i in range(6)])
    rows = list(range(6)) + COPIES
    feats = built.feats.numpy()[rows]
    slots = built.slots.numpy()[rows]
    ids = [f"img{i}" for i in range(6)] + [f"dup{i}" for i in COPIES]
    return (ref.ImageIndex(feats=jnp.asarray(feats), slots=jnp.asarray(slots),
                           ids=list(ids)),
            port.ImageIndex(feats=torch.from_numpy(feats),
                            slots=torch.from_numpy(slots), ids=list(ids)))


def _layouts(indexes, quantized):
    want, got = indexes
    if quantized:
        want, got = ref.quantize_index(want), port.quantize_index(got)
    return want, got


def _hits_equal(got, want):
    assert got == want  # ids and float scores, bit for bit


def _ties_by_row(hits, index):
    """Within each run of equal scores, rows in ascending order."""
    pos = {i: r for r, i in enumerate(index.ids)}
    for row in hits:
        for (a, sa), (b, sb) in zip(row, row[1:]):
            if sa == sb:
                assert pos[a] < pos[b], row


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("fusion", ["none", "raw", "minmax"])
@pytest.mark.parametrize("n_queries,k", [(3, 4), (len(QUERIES), 7)])
def test_sharded_search_equals_unsharded(embedders, indexes, quantized,
                                         fusion, n_queries, k, threads):
    _, emb, _ = embedders
    _, index = _layouts(indexes, quantized)
    sharded = port.shard_index(index, DEVICES)
    assert sharded.n_valid == 9 and len(sharded.shards) == W
    assert [sh.feats.shape[0] for sh in sharded.shards] == [3] * W
    assert sharded.quantized == quantized and sharded.has_slots
    queries = QUERIES[:n_queries]
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        want = emb.search_texts(queries, index, k=k, fusion=fusion,
                                alpha=0.8)
        got = emb.search_texts(queries, sharded, k=k, fusion=fusion,
                               alpha=0.8)
    finally:
        torch.set_num_threads(before)
    _hits_equal(got, want)
    _ties_by_row(got, index)
    assert all(not h[0].startswith("pad") for row in got for h in row)
    assert any(a[1] == b[1] for row in got for a, b in zip(row, row[1:]))


@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_search_images_equals_unsharded(embedders, indexes,
                                                quantized):
    _, emb, _ = embedders
    _, index = _layouts(indexes, quantized)
    sharded = port.shard_index(index, DEVICES)
    _hits_equal(emb.search_images(sharded, QUERIES, k=3),
                emb.search_images(index, QUERIES, k=3))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("fusion", ["none", "raw", "minmax"])
def test_sharded_search_matches_jax_shard_index(embedders, indexes,
                                                quantized, fusion):
    jax_emb, emb, _ = embedders
    want_index, index = _layouts(indexes, quantized)
    mesh = Mesh(np.asarray(jax.devices()[:W]), axis_names=("data",))
    want = jax_emb.search_texts(QUERIES[:3], ref.shard_index(want_index, mesh),
                                k=7, fusion=fusion, alpha=0.8)
    got = emb.search_texts(QUERIES[:3], port.shard_index(index, DEVICES),
                           k=7, fusion=fusion, alpha=0.8)
    _same_ranking(got, want)
    for g_row, w_row in zip(got, want):  # each tie group in one order
        for (ga, gs), (gb, gsb), (wa, _), (wb, _) in zip(
                g_row, g_row[1:], w_row, w_row[1:]):
            if gs == gsb:
                assert {ga, gb} == {wa, wb} and (ga, gb) == (wa, wb)


def test_load_index_of_a_jax_save_onto_a_mesh(embedders, indexes, tmp_path):
    _, emb, _ = embedders
    for quantized in (False, True):
        want_index, _ = _layouts(indexes, quantized)
        path = str(tmp_path / f"jax{int(quantized)}")
        ref.save_index(want_index, path)
        sharded = port.load_index(path, mesh=DEVICES)
        whole = port.load_index(path, "cpu")
        assert sharded.shards is not None and sharded.ids == whole.ids
        for fusion in ("none", "minmax"):
            _hits_equal(
                emb.search_texts(QUERIES, sharded, k=5, fusion=fusion),
                emb.search_texts(QUERIES, whole, k=5, fusion=fusion))


def test_sharded_save_is_the_unsharded_save(indexes, tmp_path):
    _, index = _layouts(indexes, True)
    port.save_index(index, str(tmp_path / "whole"))
    port.save_index(port.shard_index(index, DEVICES), str(tmp_path / "shard"))
    names = sorted(os.listdir(tmp_path / "whole"))
    assert names == sorted(os.listdir(tmp_path / "shard"))
    for name in names:
        assert ((tmp_path / "whole" / name).read_bytes()
                == (tmp_path / "shard" / name).read_bytes()), name


def test_sharded_index_rejects_updates(indexes):
    _, index = _layouts(indexes, False)
    sharded = port.shard_index(index, DEVICES)
    with pytest.raises(ValueError, match="quantize_index before shard_index"):
        port.quantize_index(sharded)
    with pytest.raises(ValueError, match="merge unsharded indexes"):
        port.merge_indexes(sharded, index)
    with pytest.raises(ValueError, match="remove from the unsharded index"):
        port.remove_from_index(sharded, ["img0"])
