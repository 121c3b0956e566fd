"""The port's IVF index (`leccr_torch/serve_ann.py`) against the JAX
package's (`leccr_tpu/serve_ann.py`), on the JAX tests' corpus: 512 unit
rows at E = 32 around 12 concepts, numpy seed 0.

- `_greedy_place` (numpy in both) and `_pack` given the same inputs are
  bit-equal; `_kmeans` from one seed ends within 1e-5 of JAX's (the same
  row sample, then f32 products summed in other orders).
- On the same IVF arrays, the int8 bank, `_ivf_topk`'s scores,
  `calibrate_nprobe`, `add_to_ivf` and `remove_from_ivf` give JAX's
  results; the port's own build holds the JAX tests' anchors (the full
  probe is exact, recall at a partial probe, int8 within 5e-3).
- Saves are byte for byte JAX's files, and each package loads the
  other's; `search_texts_ivf` agrees with JAX's at the same params
  (scores within 1e-4, as test_torch_serve.py's searches).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch import serve as port_serve
from leccr_torch import serve_ann as port
from leccr_tpu import serve as ref_serve
from leccr_tpu import serve_ann as ref
from test_serve_ann import _clustered_feats, _exact_topk
from test_torch_serve import (  # noqa: F401  (embedders is a fixture)
    QUERIES,
    _same_ranking,
    embedders,
)


@pytest.fixture(scope="module")
def corpus():
    rs = np.random.RandomState(0)
    cents = rs.randn(12, 32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    feats = _clustered_feats(512, 32, 12, rs, cents=cents)
    return feats, cents


def _indexes(feats, ids=None):
    ids = ids or [f"item{i}" for i in range(len(feats))]
    return (ref_serve.ImageIndex(feats=jnp.asarray(feats), slots=None,
                                 ids=list(ids)),
            port_serve.ImageIndex(feats=torch.from_numpy(np.array(feats)),
                                  slots=None, ids=list(ids)))


def _to_port(ivf):
    """A JAX IVFIndex's arrays as the port's (CPU) IVFIndex."""
    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    return port.IVFIndex(
        centroids=t(ivf.centroids), packed=t(ivf.packed), valid=t(ivf.valid),
        rows=t(ivf.rows), ids=list(ivf.ids), scale=t(ivf.scale),
        default_nprobe=ivf.default_nprobe)


def _same_ivf(got, want):
    assert got.ids == want.ids and got.default_nprobe == want.default_nprobe
    for name in ("centroids", "packed", "valid", "rows", "scale"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert g.tobytes() == w.tobytes(), name


@pytest.fixture(scope="module")
def jax_ivf(corpus):
    return ref.build_ivf_index(_indexes(corpus[0])[0], n_clusters=16,
                               iters=10, seed=0)


@pytest.fixture(scope="module")
def ivf(corpus):
    """The port's own build."""
    return port.build_ivf_index(_indexes(corpus[0])[1], n_clusters=16,
                                iters=10, seed=0, device="cpu")


def _search(ivf, q, k, nprobe):
    s, i = port._ivf_topk(torch.from_numpy(q), port._ivf_arrays(ivf), k,
                          nprobe)
    return s.numpy(), i.numpy()


def _jax_search(ivf, q, k, nprobe):
    f = jax.jit(lambda qq: ref._ivf_topk(
        qq, (ivf.centroids, ivf.packed, ivf.valid, ivf.rows, ivf.scale),
        k, nprobe))
    s, i = f(jnp.asarray(q))
    return np.asarray(s), np.asarray(i)


# ------------------------------------------------------------- building

@pytest.mark.parametrize("cap,tight", [(40, False), (9, True)])
def test_greedy_place_bit_equal_to_jax(cap, tight):
    """A roomy bank, and one with 8 free slots a cluster for 120 rows of
    4 candidates each, whose candidates fill up (the spill)."""
    rs = np.random.RandomState(1)
    cids = np.stack([rs.permutation(16)[:4] for _ in range(120)])
    margin = rs.rand(120).astype(np.float32)
    fill = rs.randint(0, 5, 16).astype(np.int64)
    if tight:
        fill[:] = cap - 8
    got_fill, want_fill = fill.copy(), fill.copy()
    got = port._greedy_place(cids, margin, cap, got_fill)
    want = ref._greedy_place(cids, margin, cap, want_fill)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_fill, want_fill)


def test_pack_bit_equal_to_jax(corpus, jax_ivf):
    feats = corpus[0]
    cent = np.asarray(jax_ivf.centroids)
    got_rows, got_cap = port._pack(torch.from_numpy(feats),
                                   torch.from_numpy(cent), 1.3, 8)
    want_rows, want_cap = ref._pack(jnp.asarray(feats), jnp.asarray(cent),
                                    1.3, 8)
    assert got_cap == want_cap
    np.testing.assert_array_equal(got_rows, want_rows)


@pytest.mark.parametrize("blocked", [False, True])
def test_kmeans_matches_jax(corpus, monkeypatch, blocked):
    """Within 1e-5 of JAX's centroids; `blocked` streams 64-row blocks
    over 500 rows (a padded last block) in both packages."""
    feats = corpus[0]
    if blocked:
        feats = feats[:500]
        monkeypatch.setattr(ref, "_sim_block_rows", lambda n, c: 64)
        monkeypatch.setattr(port, "_sim_block_rows", lambda n, c: 64)
    got = port._kmeans(torch.from_numpy(feats), 16, 10, 0).numpy()
    want = np.asarray(ref._kmeans(jnp.asarray(feats), 16, 10, 0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_kmeans_reseeds_an_empty_cluster_as_jax_does():
    """Duplicated rows leave clusters empty after the first assignment:
    both reseed them from the worst-fit rows."""
    rs = np.random.RandomState(2)
    base = _clustered_feats(6, 8, 3, rs)
    feats = np.concatenate([np.repeat(base, 10, axis=0),
                            _clustered_feats(4, 8, 3, rs)])
    got = port._kmeans(torch.from_numpy(feats), 8, 3, 1).numpy()
    want = np.asarray(ref._kmeans(jnp.asarray(feats), 8, 3, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_packing_places_every_row_exactly_once(ivf, corpus):
    feats = corpus[0]
    rows, valid = ivf.rows.numpy(), ivf.valid.numpy()
    placed = rows[valid]
    assert placed.shape[0] == feats.shape[0]
    assert len(np.unique(placed)) == feats.shape[0]
    np.testing.assert_array_equal(ivf.packed.numpy()[valid], feats[placed])
    assert ivf.capacity % 8 == 0 and ivf.rows.dtype == torch.int32


def test_two_builds_from_one_seed_are_bit_identical(corpus, ivf):
    again = port.build_ivf_index(_indexes(corpus[0])[1], n_clusters=16,
                                 iters=10, seed=0, device="cpu")
    assert torch.equal(again.centroids, ivf.centroids)
    assert torch.equal(again.rows, ivf.rows)
    assert torch.equal(again.valid, ivf.valid)


def test_build_rejects_bad_inputs(corpus, monkeypatch):
    index = _indexes(corpus[0])[1]
    with pytest.raises(ValueError, match="fp32"):
        port.build_ivf_index(port_serve.quantize_index(index), n_clusters=4,
                             device="cpu")
    for c in (0, 10_000):
        with pytest.raises(ValueError, match="n_clusters"):
            port.build_ivf_index(index, n_clusters=c, device="cpu")
    with pytest.raises(ValueError, match="capacity_factor"):
        port.build_ivf_index(index, n_clusters=4, capacity_factor=0.5,
                             device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.build_ivf_index(index, n_clusters=4)


# ------------------------------------------------------------ searching

def test_full_probe_is_exact(ivf, corpus):
    feats, cents = corpus
    q = _clustered_feats(9, 32, 12, np.random.RandomState(1), cents=cents)
    es, ei = _exact_topk(feats, q, k=10)
    s, i = _search(ivf, q, 10, ivf.n_clusters)
    np.testing.assert_allclose(s, es, atol=1e-5)
    untied = np.abs(np.diff(es, axis=1)) > 1e-6
    assert (i[:, :-1] == ei[:, :-1])[untied].mean() > 0.99


def test_partial_probe_recall(ivf, corpus):
    feats, cents = corpus
    q = _clustered_feats(32, 32, 12, np.random.RandomState(2), cents=cents)
    _, ei = _exact_topk(feats, q, k=10)
    recall = {}
    for nprobe in (4, 8):
        _, i = _search(ivf, q, 10, nprobe)
        recall[nprobe] = np.mean(
            [len(set(a) & set(b)) / 10.0 for a, b in zip(i, ei)])
    assert recall[4] >= 0.9 and recall[8] >= 0.97
    assert recall[8] >= recall[4]


@pytest.mark.parametrize("nprobe", [3, 16])
def test_ivf_topk_matches_jax_on_the_same_arrays(jax_ivf, corpus, nprobe):
    """f32 scores within 1e-6, int8 scores bit for bit, ids equal."""
    cents = corpus[1]
    q = _clustered_feats(8, 32, 12, np.random.RandomState(3), cents=cents)
    for j in (jax_ivf, ref.quantize_ivf(jax_ivf)):
        s, i = _search(_to_port(j), q, 10, nprobe)
        ws, wi = _jax_search(j, q, 10, nprobe)
        if j.scale is None:
            np.testing.assert_allclose(s, ws, rtol=0, atol=1e-6)
        else:
            assert s.tobytes() == ws.tobytes()
        np.testing.assert_array_equal(i, wi)


def test_int8_ivf(ivf, jax_ivf, corpus):
    """quantize_ivf is JAX's bit for bit; the port's int8 bank keeps the
    f32 order (JAX's test bounds)."""
    _same_ivf(port.quantize_ivf(_to_port(jax_ivf)),
              ref.quantize_ivf(jax_ivf))
    q8 = port.quantize_ivf(ivf)
    assert q8.packed.dtype == torch.int8 and q8.scale.shape == (
        ivf.n_clusters, ivf.capacity)
    q = _clustered_feats(8, 32, 12, np.random.RandomState(3),
                         cents=corpus[1])
    sf, idf = _search(ivf, q, 5, ivf.n_clusters)
    sq, idq = _search(q8, q, 5, ivf.n_clusters)
    np.testing.assert_allclose(sq, sf, atol=5e-3)
    untied = np.abs(np.diff(sf, axis=1)) > 1e-2
    assert (idq[:, :-1] == idf[:, :-1])[untied].mean() > 0.95
    assert port.quantize_ivf(q8) is q8


@pytest.mark.parametrize("int8", [False, True])
def test_calibrate_nprobe_matches_jax(jax_ivf, int8):
    j = ref.quantize_ivf(jax_ivf) if int8 else jax_ivf
    p = _to_port(j)
    for target in (0.9, 1.0):
        got = port.calibrate_nprobe(p, target_recall=target, k=10, sample=64,
                                    seed=3)
        want = ref.calibrate_nprobe(j, target_recall=target, k=10,
                                    sample=64, seed=3)
        assert got == want
    with pytest.raises(ValueError, match="target_recall"):
        port.calibrate_nprobe(p, target_recall=0.0)


# --------------------------------------------------------- add, remove

def test_add_to_ivf_matches_jax(corpus):
    """Exact after the merge (the full probe is the dense ranker over the
    merged corpus), JAX's arrays bit for bit, the original untouched."""
    feats, cents = corpus
    jb, pb = _indexes(feats[:400])
    jn, pn = _indexes(feats[400:], [f"item{i}" for i in range(400, 512)])
    j_ivf = ref.build_ivf_index(jb, n_clusters=16, iters=10, seed=0)
    base = _to_port(j_ivf)
    merged = port.add_to_ivf(base, pn)
    _same_ivf(merged, ref.add_to_ivf(j_ivf, jn))
    assert base.n_valid == 400 and base.capacity <= merged.capacity
    q = _clustered_feats(9, 32, 12, np.random.RandomState(7), cents=cents)
    es, ei = _exact_topk(feats, q, k=10)
    s, i = _search(merged, q, 10, merged.n_clusters)
    np.testing.assert_allclose(s, es, atol=1e-5)
    empty = port_serve.ImageIndex(feats=torch.zeros(0, 32), slots=None,
                                  ids=[])
    assert port.add_to_ivf(merged, empty) is merged
    with pytest.raises(ValueError, match="duplicate"):
        port.add_to_ivf(merged, pb)
    with pytest.raises(ValueError, match="fp32"):
        port.add_to_ivf(merged, port_serve.quantize_index(pn))


def test_add_to_int8_ivf_keeps_existing_bytes(corpus):
    feats = corpus[0]
    jb, _ = _indexes(feats[:400])
    jn, pn = _indexes(feats[400:], [f"item{i}" for i in range(400, 512)])
    j8 = ref.quantize_ivf(ref.build_ivf_index(jb, n_clusters=16, iters=10,
                                              seed=0))
    q8 = _to_port(j8)
    merged = port.add_to_ivf(q8, pn)
    _same_ivf(merged, ref.add_to_ivf(j8, jn))
    was = q8.valid
    cap0 = q8.capacity
    assert torch.equal(merged.packed[:, :cap0][was], q8.packed[was])
    assert torch.equal(merged.scale[:, :cap0][was], q8.scale[was])
    _, i = _search(merged, feats[400:416], 1, merged.n_clusters)
    np.testing.assert_array_equal(i[:, 0], np.arange(400, 416))


def test_add_to_ivf_grows_capacity():
    rs = np.random.RandomState(1)
    feats = _clustered_feats(76, 16, 4, rs)
    jb, _ = _indexes(feats[:60])
    jn, pn = _indexes(feats[60:], [f"item{i}" for i in range(60, 76)])
    j_ivf = ref.build_ivf_index(jb, n_clusters=4, iters=5,
                                capacity_factor=1.0, seed=0)
    merged = port.add_to_ivf(_to_port(j_ivf), pn)
    assert merged.capacity > j_ivf.capacity and merged.capacity % 8 == 0
    _same_ivf(merged, ref.add_to_ivf(j_ivf, jn))
    _, i = _search(merged, feats[:8], 1, merged.n_clusters)
    np.testing.assert_array_equal(i[:, 0], np.arange(8))


@pytest.mark.parametrize("int8", [False, True])
def test_remove_then_add_matches_jax(corpus, int8):
    """remove_from_ivf compacts each cluster to a slot prefix (the
    invariant add_to_ivf writes by), as JAX's does, on f32 and int8
    banks; every survivor and every new row retrieves itself."""
    feats = corpus[0]
    jb, _ = _indexes(feats[:60])
    j_ivf = ref.build_ivf_index(jb, n_clusters=6, iters=8, seed=0)
    if int8:
        j_ivf = ref.quantize_ivf(j_ivf)
    drop = [f"item{i}" for i in range(0, 60, 8)]
    kept = port.remove_from_ivf(_to_port(j_ivf), drop)
    j_kept = ref.remove_from_ivf(j_ivf, drop)
    _same_ivf(kept, j_kept)
    v = kept.valid.numpy()
    fill = v.sum(axis=1)
    for c in range(v.shape[0]):
        assert v[c, :fill[c]].all() and not v[c, fill[c]:].any()
    jn, pn = _indexes(feats[60:64], [f"new{i}" for i in range(4)])
    merged = port.add_to_ivf(kept, pn)
    _same_ivf(merged, ref.add_to_ivf(j_kept, jn))
    survivors = [i for i in range(60) if f"item{i}" not in set(drop)]
    corpus_feats = np.concatenate([feats[survivors], feats[60:64]])
    _, i = _search(merged, corpus_feats, 1, merged.n_clusters)
    np.testing.assert_array_equal(i[:, 0], np.arange(56))
    assert port.remove_from_ivf(kept, []) is kept
    with pytest.raises(ValueError, match="unknown ids"):
        port.remove_from_ivf(kept, ["nope"])


# ------------------------------------------------------------ save, load

def _files(path):
    return {name: (path / name).read_bytes()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nprobe", [None, 5])
def test_saves_are_the_jax_format_byte_for_byte(jax_ivf, tmp_path, int8,
                                                nprobe):
    j = dataclasses.replace(
        ref.quantize_ivf(jax_ivf) if int8 else jax_ivf,
        default_nprobe=nprobe)
    port.save_ivf(_to_port(j), str(tmp_path / "port"))
    ref.save_ivf(j, str(tmp_path / "jax"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert port.is_ivf_save(str(tmp_path / "jax"))
    _same_ivf(port.load_ivf(str(tmp_path / "jax"), "cpu"), j)
    back = ref.load_ivf(str(tmp_path / "port"))
    _same_ivf(_to_port(back), j)


def test_save_over_an_int8_save_and_other_dirs(ivf, tmp_path):
    """An f32 save over an int8 one drops its scales; an exact save or a
    bare directory is not an IVF save."""
    p = tmp_path / "ivf"
    port.save_ivf(port.quantize_ivf(ivf), str(p))
    assert port.load_ivf(str(p), "cpu").quantized
    port.save_ivf(ivf, str(p))
    assert not port.load_ivf(str(p), "cpu").quantized
    exact = tmp_path / "exact"
    port_serve.save_index(_indexes(np.eye(4, 8, dtype=np.float32))[1],
                          str(exact))
    assert not port.is_ivf_save(str(exact))
    assert not port.is_ivf_save(str(tmp_path / "none"))
    with pytest.raises(ValueError, match="not an IVF"):
        port.load_ivf(str(exact), "cpu")


# ------------------------------------------------- Embedder search path

@pytest.fixture(scope="module")
def text_ivfs(embedders):
    """An IVF of the tiny model's image index (JAX's build) in both
    packages, and 24 images' worth of corpus."""
    jax_emb, _, _ = embedders
    res = jax_emb.cfg.model.vision.image_res
    rs = np.random.RandomState(5)
    images = rs.randint(0, 255, (24, res, res, 3)).astype(np.uint8)
    caps = [f"a man rides his red bike {i}" for i in range(24)]
    index = jax_emb.build_image_index(images, caps,
                                      ids=[f"img{i}" for i in range(24)])
    j = ref.build_ivf_index(index, n_clusters=4, iters=5)
    return j, _to_port(j)


@pytest.mark.parametrize("nprobe", [2, 4])
def test_search_texts_ivf_matches_jax(embedders, text_ivfs, nprobe):
    jax_emb, emb, _ = embedders
    j, p = text_ivfs
    want = ref.search_texts_ivf(jax_emb, QUERIES, j, k=5, nprobe=nprobe)
    got = port.search_texts_ivf(emb, QUERIES, p, k=5, nprobe=nprobe)
    assert [len(r) for r in got] == [len(r) for r in want]
    _same_ranking(got, want)


def test_search_texts_ivf_short_rows_and_errors(embedders, text_ivfs):
    """k beyond the candidate pool comes back short, without pad slots;
    an nprobe outside [1, C] raises; no query, no result."""
    _, emb, _ = embedders
    _, p = text_ivfs
    rows = port.search_texts_ivf(emb, ["a man rides"], p, k=24, nprobe=1)
    assert 0 < len(rows[0]) <= p.capacity
    assert all(np.isfinite(s) for _, s in rows[0])
    assert len({i for i, _ in rows[0]}) == len(rows[0])
    assert port.search_texts_ivf(emb, [], p) == []
    with pytest.raises(ValueError, match="nprobe"):
        port.search_texts_ivf(emb, QUERIES, p, nprobe=99)
    stamped = dataclasses.replace(p, default_nprobe=p.n_clusters)
    full = port.search_texts_ivf(emb, QUERIES[:2], stamped, k=3)
    exact = emb.search_texts(
        QUERIES[:2], port_serve.ImageIndex(
            feats=p.packed[p.valid][torch.argsort(p.rows[p.valid])],
            slots=None, ids=p.ids), k=3)
    _same_ranking(full, exact)
