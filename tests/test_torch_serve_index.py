"""The port's int8 index, merge and remove, and index saves against the JAX
package's (`leccr_tpu/serve.py`) on the same arrays made from a numpy seed.

- Quantization and the int8 scores are bit-equal to the JAX package's
  compiled functions (every JAX path runs them under jit, where the
  scale is max|row| times the f32 reciprocal of 127): both round x /
  scale (f32) half to even, and an int8 · int8 sum over E is exact in
  int32.
- Embedder searches of an int8 index (fusion none, raw and minmax, on the
  padded and the chunked query path; search_images) run both packages'
  Embedders at the same params on the same int8 index bytes.  The two
  query embeddings agree within ATOL = 1e-4 (test_torch_serve.py), and
  that can flip one element's int8 rounding, so the bound is derived per
  query (`_int8_tolerance`): an element flips only where q / qs lies
  within 2·ATOL / qs of a half-integer, and a flip of element e moves a
  score by at most qs · |row[e]| · (the row's scale); the query scale's
  own move shifts a score by at most ATOL / max|q| <= ATOL · √E.  The
  minmax fusion divides by each batch's score range R, which scales the
  bound by 4 / R.
- Saves are byte for byte the JAX package's files, and each package
  loads the other's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leccr_torch import serve as port
from leccr_tpu import serve as ref
from test_torch_serve import (  # noqa: F401  (embedders is a fixture)
    ATOL,
    CAPTIONS,
    QUERIES,
    embedders,
)

E = 32


def _unit_rows(rs, *shape):
    x = rs.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _bits(x):
    """An array's raw bytes, for bit-for-bit comparisons (NaN-safe)."""
    x = np.ascontiguousarray(np.asarray(x))
    return x.dtype, x.shape, x.tobytes()


def _indexes(feats, slots, ids, quantize=False):
    """The same numpy arrays as a JAX and a port (CPU) ImageIndex."""
    want = ref.ImageIndex(feats=jnp.asarray(feats),
                          slots=None if slots is None else jnp.asarray(slots),
                          ids=list(ids))
    got = port.ImageIndex(
        feats=torch.from_numpy(np.array(feats)),
        slots=None if slots is None else torch.from_numpy(np.array(slots)),
        ids=list(ids))
    if quantize:
        want, got = ref.quantize_index(want), port.quantize_index(got)
    return want, got


def _same_index(got, want):
    assert got.ids == want.ids and got.quantized == want.quantized
    for name in ("feats", "slots", "scale", "slot_scale"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert _bits(g.numpy()) == _bits(w), name


# ---------------------------------------------------------- quantization

@pytest.mark.parametrize("shape", [(37, E), (37, 4, E), (5, 36)])
def test_quantize_rows_bit_equal_to_jax(shape):
    rs = np.random.RandomState(0)
    x = _unit_rows(rs, *shape)
    x[1] = 0.0  # a zero row: scale 0, divided by 1
    flat = x[2].reshape(-1)  # max |x| = 127, so scale = 1 exactly, and
    flat[:] = 0.0            # these land on halves: round half to even
    flat[:6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    got_q, got_s = port._quantize_rows(torch.from_numpy(x))
    want_q, want_s = jax.jit(ref._quantize_rows)(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert _bits(got_q.numpy()) == _bits(want_q)
    assert _bits(got_s.numpy()) == _bits(want_s)
    assert got_q[2].reshape(-1)[:6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.mark.parametrize("b,n,e", [(3, 13, E), (20, 64, E), (4, 9, 36)])
def test_int8_scores_bit_equal_to_jax(b, n, e):
    """Fewer than 17 query rows, a column count off the multiple of 8 and
    an E off it all go through `_int8_mm`'s zero padding."""
    rs = np.random.RandomState(1)
    q = _unit_rows(rs, b, e)
    quantize = jax.jit(ref._quantize_rows)
    f, fs = quantize(jnp.asarray(_unit_rows(rs, n, e)))
    sl, ss = quantize(jnp.asarray(_unit_rows(rs, n, 4, e)))
    tq, tf, tfs, tsl, tss = (torch.from_numpy(np.array(a))
                             for a in (q, f, fs, sl, ss))
    assert _bits(port._int8_scores(tq, tf, tfs).numpy()) == _bits(
        jax.jit(ref._int8_scores)(jnp.asarray(q), f, fs))
    assert _bits(port._int8_slot_scores(tq, tsl, tss).numpy()) == _bits(
        jax.jit(ref._int8_slot_scores)(jnp.asarray(q), sl, ss))


def test_int8_mm_is_exact_on_the_padded_shapes():
    rs = np.random.RandomState(2)
    a = torch.from_numpy(rs.randint(-127, 128, (5, 20)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-127, 128, (11, 20)).astype(np.int8))
    got = port._int8_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (5, 11)
    assert torch.equal(got, a.int() @ b.int().T)


@pytest.mark.parametrize("slots", [True, False])
def test_quantize_index_bit_equal_to_jax(slots):
    rs = np.random.RandomState(3)
    feats = _unit_rows(rs, 21, E)
    sl = _unit_rows(rs, 21, 4, E) if slots else None
    want, got = _indexes(feats, sl, [f"i{j}" for j in range(21)], True)
    _same_index(got, want)
    assert port.quantize_index(got) is got


# ------------------------------------------------------ Embedder, int8

@pytest.fixture(scope="module")
def int8_indexes(embedders):
    """Both packages' int8 index of the JAX f32 index's arrays: the same
    int8 bytes, so only the query embeddings differ."""
    jax_emb, _, images = embedders
    f32 = jax_emb.build_image_index(images, CAPTIONS)
    want, got = _indexes(np.asarray(f32.feats), np.asarray(f32.slots),
                         f32.ids, quantize=True)
    _same_index(got, want)
    return want, got


def _int8_tolerance(q, rows, scale):
    """How far an int8 score can move between the two packages (module
    docstring), the largest over every (query, row) pair: q [B, E] the
    port's query embeddings; rows the index's int8 rows [N, E] (or slots
    [N, K, E], the max over K), scale their dequant scales.  A flip of
    element e moves a sum by at most |rows[i, e]|."""
    qs = np.abs(q).max(axis=1) / 127.0
    x = q / qs[:, None]
    near = (np.abs(np.abs(x - np.floor(x)) - 0.5)
            <= 2 * ATOL / qs[:, None]).astype(np.float32)
    mags = np.abs(rows.astype(np.float32))
    flip = (np.einsum("be,nke->bnk", near, mags).max(axis=-1)
            if mags.ndim == 3 else near @ mags.T)
    bound = flip * qs[:, None] * scale[None, :] + ATOL * np.sqrt(q.shape[1])
    return float(bound.max())


def _ranges(q, index):
    """The ranges R of the feature and the slot scores of the queries q
    (minmax divides by them)."""
    s = port._feat_scores(q, index.feats, index.scale)
    c = port._slot_scores(q, index.slots, index.slot_scale)
    return float(s.max() - s.min()), float(c.max() - c.min())


def _same_ranking_within(got, want, tol):
    for g_row, w_row in zip(got, want):
        g_ids, g_s = zip(*g_row)
        w_ids, w_s = zip(*w_row)
        np.testing.assert_allclose(g_s, w_s, rtol=0, atol=tol)
        w_s = np.asarray(w_s)
        for j, wid in enumerate(w_ids):
            if np.abs(np.delete(w_s, j) - w_s[j]).min() > 2 * tol:
                assert g_ids[j] == wid


@pytest.mark.parametrize("fusion", ["none", "raw", "minmax"])
@pytest.mark.parametrize("n_queries", [3, len(QUERIES)])
def test_search_texts_int8_matches_jax(embedders, int8_indexes, fusion,
                                       n_queries):
    jax_emb, emb, _ = embedders
    want_index, index = int8_indexes
    queries = QUERIES[:n_queries]
    alpha = 0.6
    q = torch.from_numpy(emb.embed_texts(queries))
    t_s = _int8_tolerance(q.numpy(), index.feats.numpy(),
                          index.scale.numpy())
    t_c = _int8_tolerance(q.numpy(), index.slots.numpy(),
                          index.slot_scale.numpy())
    tol = {"none": t_s, "raw": alpha * t_s + (1 - alpha) * t_c}.get(fusion)
    if fusion == "minmax":
        r_s, r_c = _ranges(q, index)
        tol = (alpha * 4 * t_s / (r_s - 2 * t_s)
               + (1 - alpha) * 4 * t_c / (r_c - 2 * t_c))
    want = jax_emb.search_texts(queries, want_index, k=4, fusion=fusion,
                                alpha=alpha)
    got = emb.search_texts(queries, index, k=4, fusion=fusion, alpha=alpha)
    assert len(got) == n_queries and all(len(r) == 4 for r in got)
    _same_ranking_within(got, want, tol)


def test_search_images_int8_matches_jax(embedders, int8_indexes):
    jax_emb, emb, _ = embedders
    want_index, index = int8_indexes
    texts = torch.from_numpy(emb.embed_texts(QUERIES)).numpy()
    tol = _int8_tolerance(texts, index.feats.numpy(), index.scale.numpy())
    want = jax_emb.search_images(want_index, QUERIES, k=3)
    got = emb.search_images(index, QUERIES, k=3)
    assert len(got) == len(CAPTIONS)
    _same_ranking_within(got, want, tol)


def test_fusion_on_slotless_index_names_the_save(embedders, int8_indexes):
    _, emb, _ = embedders
    _, index = int8_indexes
    slotless = port.ImageIndex(feats=index.feats, slots=None,
                               ids=index.ids, scale=index.scale)
    with pytest.raises(ValueError, match="slots.npy"):
        emb.search_texts(["a"], slotless, fusion="minmax")


# --------------------------------------------------------- merge, remove

@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("slots", [True, False])
def test_merge_and_remove_match_jax(quantize, slots):
    rs = np.random.RandomState(4)
    feats = _unit_rows(rs, 12, E)
    sl = _unit_rows(rs, 12, 4, E) if slots else None
    ids = [f"i{j}" for j in range(12)]
    want_a, got_a = _indexes(feats[:8], None if sl is None else sl[:8],
                             ids[:8], quantize)
    want_b, got_b = _indexes(feats[8:], None if sl is None else sl[8:],
                             ids[8:], quantize)
    merged = port.merge_indexes(got_a, got_b)
    _same_index(merged, ref.merge_indexes(want_a, want_b))
    drop = ["i0", "i5", "i11"]
    _same_index(port.remove_from_index(merged, drop),
                ref.remove_from_index(ref.merge_indexes(want_a, want_b),
                                      drop))
    # a merged int8 index keeps every existing row's bytes
    if quantize:
        assert torch.equal(merged.feats[:8], got_a.feats)


@pytest.mark.parametrize("case,match", [
    ("duplicate", "duplicate ids"), ("quantized", "quantized"),
    ("slots", "slot-carrying"), ("unknown", "unknown ids")])
def test_merge_and_remove_errors_match_jax(case, match):
    rs = np.random.RandomState(5)
    feats, sl = _unit_rows(rs, 4, E), _unit_rows(rs, 4, 2, E)
    pairs = {
        "duplicate": (_indexes(feats, sl, list("abcd")),
                      _indexes(feats, sl, list("defg"))),
        "quantized": (_indexes(feats, sl, list("abcd")),
                      _indexes(feats, sl, list("efgh"), True)),
        "slots": (_indexes(feats, sl, list("abcd")),
                  _indexes(feats, None, list("efgh"))),
    }
    for pkg, i in ((port, 1), (ref, 0)):
        with pytest.raises(ValueError, match=match):
            if case == "unknown":
                pkg.remove_from_index(_indexes(feats, sl, list("abcd"))[i],
                                      ["a", "z"])
            else:
                a, b = pairs[case]
                pkg.merge_indexes(a[i], b[i])


# ------------------------------------------------------------ save, load

def _files(path):
    return {name: (path / name).read_bytes()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("slots", [True, False])
def test_saves_are_the_jax_format_byte_for_byte(tmp_path, quantize, slots):
    rs = np.random.RandomState(6)
    feats = _unit_rows(rs, 9, E)
    sl = _unit_rows(rs, 9, 3, E) if slots else None
    want, got = _indexes(feats, sl, [f"img{j}" for j in range(9)], quantize)
    port.save_index(got, str(tmp_path / "port"))
    ref.save_index(want, str(tmp_path / "jax"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    # each package loads the other's save bit for bit
    _same_index(port.load_index(str(tmp_path / "jax"), "cpu"), want)
    back = ref.load_index(str(tmp_path / "port"))
    for name in ("feats", "slots", "scale", "slot_scale"):
        w = getattr(want, name)
        assert (getattr(back, name) is None) == (w is None)
        if w is not None:
            assert _bits(getattr(back, name)) == _bits(w)
    assert back.ids == want.ids


def test_save_overwrite_drops_stale_optional_files(tmp_path):
    """An f32 save over an int8 one must not leave its scales behind (the
    manifest scopes the optional files to one save), and a save without a
    manifest falls back to the files present."""
    rs = np.random.RandomState(7)
    _, index = _indexes(_unit_rows(rs, 5, E), _unit_rows(rs, 5, 2, E),
                        list("abcde"))
    d = tmp_path / "idx"
    port.save_index(port.quantize_index(index), str(d))
    assert (d / "scale.npy").exists()
    port.save_index(index, str(d))
    assert not (d / "scale.npy").exists()
    loaded = port.load_index(str(d), "cpu")
    assert not loaded.quantized and loaded.slots is not None
    assert json.loads((d / "manifest.json").read_text()) == {
        "optional": ["slots"], "n": 5}
    # a stale file that the manifest does not name is ignored ...
    np.save(d / "scale.npy", np.ones(5, np.float32))
    assert port.load_index(str(d), "cpu").scale is None
    # ... and without a manifest, the files present decide
    (d / "manifest.json").unlink()
    assert port.load_index(str(d), "cpu").scale is not None


def test_load_rejects_a_corrupt_save_and_a_mesh(tmp_path):
    rs = np.random.RandomState(8)
    _, index = _indexes(_unit_rows(rs, 3, E), None, list("abc"))
    d = tmp_path / "idx"
    port.save_index(index, str(d))
    (d / "ids.json").write_text(json.dumps(["a", "b"]))
    with pytest.raises(ValueError, match="corrupt"):
        port.load_index(str(d), "cpu")
    # a mesh lays the rows out sharded (tests/test_torch_serve_sharded.py);
    # a corrupt save raises there too, before any row is placed
    with pytest.raises(ValueError, match="corrupt"):
        port.load_index(str(d), mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="at least one device"):
        port.shard_index(index, [])


def test_save_load_keeps_the_device_and_defaults_to_the_gpu(tmp_path,
                                                            monkeypatch):
    rs = np.random.RandomState(9)
    _, index = _indexes(_unit_rows(rs, 3, E), None, list("abc"))
    port.save_index(index, str(tmp_path / "idx"))
    assert port.load_index(str(tmp_path / "idx"), "cpu").feats.device.type \
        == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.load_index(str(tmp_path / "idx"))


def test_from_checkpoint_reads_the_config_file(tmp_path):
    """Embedder.from_checkpoint(config.json) equals from_config of the
    same config (seeded random weights: the output dir holds no
    checkpoint)."""
    from leccr_torch.config import tiny_test_config
    from leccr_torch.data.tokenizers import write_tiny_wordpiece_vocab

    vocab = tmp_path / "vocab.txt"
    write_tiny_wordpiece_vocab(str(vocab), "a man rides".split())
    cfg = tiny_test_config()
    cfg.data.text_vocab = str(vocab)
    cfg.output_dir = str(tmp_path / "run")
    cfg.save(str(tmp_path / "config.json"))
    got = port.Embedder.from_checkpoint(str(tmp_path / "config.json"),
                                        batch_size=3, device="cpu")
    want = port.Embedder.from_config(cfg, device="cpu", batch_size=3)
    assert got.batch_size == 3
    np.testing.assert_array_equal(got.embed_texts(["a man rides"]),
                                  want.embed_texts(["a man rides"]))
