"""The port's data pipeline against the JAX package's, on CPU.

Bit for bit (exact equality, no tolerance): the synthetic datasets' files,
`shard_indices` / `bucket_width` / `pad_token_batch`, the train decode
(exact and `fast`) with its flip and the RandomState it leaves, every array
of two epochs of `TrainLoader` batches (with `start_step`) on the tiny
synthetic set and on the MSCOCO layout with caption features, `EvalLoader`'s
text and image batches, `normalize_caption` and `build_eval_index`.  Then
the port's own guarantees: a mid-epoch start equals the tail of the epoch
with three target languages, and an exception in a sample read reaches
the consumer of the train loader, of `device_prefetch` and of the eval
image batches, within a deadline, without ending the stream cleanly.
"""

import dataclasses
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from leccr_torch.data import datasets as port_ds
from leccr_torch.data import images as port_images
from leccr_torch.data import pipeline as port_pipe
from leccr_torch.data import synthetic as port_synth
from leccr_torch.data import text as port_text
from leccr_torch.data.tokenizers import WordPieceTokenizer as PortWordPiece
from leccr_tpu.data import datasets as jax_ds
from leccr_tpu.data import images as jax_images
from leccr_tpu.data import pipeline as jax_pipe
from leccr_tpu.data import synthetic as jax_synth
from leccr_tpu.data import text as jax_text
from leccr_tpu.data.tokenizers import WordPieceTokenizer as JaxWordPiece

DEADLINE_S = 20.0


def _files(root: Path):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("maker,kwargs", [
    ("make_image_dataset", {"n_train": 6, "n_eval": 3, "image_res": 24}),
    ("make_image_dataset", {"n_train": 9, "n_eval": 8, "image_res": 16,
                            "learnable": True, "seed": 3,
                            "target_lang": "fr"}),
    ("make_mscoco_dataset", {"n_train": 5, "n_eval": 3, "image_res": 20,
                             "seed": 1}),
])
def test_synthetic_files_are_byte_identical(tmp_path, maker, kwargs):
    port_cfg = getattr(port_synth, maker)(str(tmp_path / "port"), **kwargs)
    jax_cfg = getattr(jax_synth, maker)(str(tmp_path / "jax"), **kwargs)
    port_files, jax_files = (_files(tmp_path / "port"),
                             _files(tmp_path / "jax"))
    assert list(port_files) == list(jax_files)
    assert port_files == jax_files
    want = dataclasses.asdict(jax_cfg)
    got = dataclasses.asdict(port_cfg)
    for key in ("root_dir", "image_root", "generated_caption_dir",
                "text_vocab"):
        want[key] = want[key].replace(str(tmp_path / "jax"),
                                      str(tmp_path / "port"))
    assert got == want


@pytest.mark.parametrize("n,epoch,seed,count,index,shuffle,drop", [
    (103, 0, 42, 1, 0, True, True), (103, 3, 7, 4, 2, True, True),
    (10, 1, 0, 3, 1, False, False), (17, 2, 5, 4, 3, True, False)])
def test_shard_indices_match(n, epoch, seed, count, index, shuffle, drop):
    np.testing.assert_array_equal(
        port_pipe.shard_indices(n, epoch, seed, count, index, shuffle, drop),
        jax_pipe.shard_indices(n, epoch, seed, count, index, shuffle, drop))


def test_bucket_width_and_pad_token_batch_match():
    rs = np.random.RandomState(0)
    for _ in range(20):
        lengths = list(rs.randint(1, 150, rs.randint(1, 6)))
        assert (port_pipe.bucket_width(lengths, [64, 32, 128])
                == jax_pipe.bucket_width(lengths, [64, 32, 128]))
        toks = [list(rs.randint(1, 99, k)) for k in lengths]
        for got, want in zip(port_pipe.pad_token_batch(toks, 40, 3),
                             jax_pipe.pad_token_batch(toks, 40, 3)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("suffix", ["jpg", "png"])
def test_train_decode_matches(tmp_path, fast, suffix):
    """Pixels, the flip and the RandomState left behind are JAX's."""
    from PIL import Image

    rs = np.random.RandomState(4)
    path = tmp_path / f"img.{suffix}"
    Image.fromarray(rs.randint(0, 256, (150, 220, 3), np.uint8)).save(path)
    for seed in range(6):
        r_port, r_jax = (np.random.RandomState(seed),
                         np.random.RandomState(seed))
        got, flip = port_images.load_train_image(str(path), 48, r_port, fast)
        want, want_flip = jax_images.load_train_image(str(path), 48, r_jax,
                                                      fast)
        assert got.shape == (48, 48, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert flip == want_flip
        assert r_port.randint(1 << 30) == r_jax.randint(1 << 30)
    np.testing.assert_array_equal(
        port_images.load_eval_image(str(path), 40, fast),
        jax_images.load_eval_image(str(path), 40, fast))
    decoded = port_images.decode_image(str(path))
    np.testing.assert_array_equal(decoded,
                                  jax_images.decode_image(str(path)))
    np.testing.assert_array_equal(port_images._pil_resize(decoded, (30, 50)),
                                  jax_images._pil_resize(decoded, (30, 50)))
    for top, left, h, w in (port_images.sample_resized_crop(
            150, 220, np.random.RandomState(s)) for s in range(20)):
        assert 0 <= top and top + h <= 150 and 0 <= left and left + w <= 220


def _feats_layout(cfg, root: Path, ids):
    """Point `cfg` (both packages' DataConfigs) at per-image [n, 768]
    caption features, n from 2 to 5."""
    rs = np.random.RandomState(0)
    feats = root / "feats"
    feats.mkdir()
    for image_id in ids:
        np.save(feats / f"{image_id}.npy",
                rs.randn(rs.randint(2, 6), 768).astype(np.float32))
    cfg.generated_caption_dir = str(feats)
    cfg.generated_caption_type = "feats"


@pytest.fixture(params=["multi30k", "mscoco_feats"])
def both_datasets(request, tmp_path):
    """(port dataset, JAX dataset, port cfg, JAX cfg, tokenizers) of one
    layout, made by each package's own generator."""
    cfgs = []
    for pkg, synth in (("port", port_synth), ("jax", jax_synth)):
        if request.param == "multi30k":
            cfg = synth.make_image_dataset(str(tmp_path / pkg), n_train=12,
                                           n_eval=5, caps_per_image=3,
                                           image_res=40, seed=2)
        else:
            cfg = synth.make_mscoco_dataset(str(tmp_path / pkg), n_train=10,
                                            n_eval=4, caps_per_image=2,
                                            image_res=40, seed=5)
            ids = [ln.split()[0] for ln in Path(
                tmp_path / pkg / "img_id" / "image_ids.txt").read_text()
                .splitlines()]
            _feats_layout(cfg, tmp_path / pkg, ids)
        cfg.max_tokens, cfg.token_buckets, cfg.seed = 24, [8, 16, 24], 11
        cfgs.append(cfg)
    port_cfg, jax_cfg = cfgs
    return (port_ds.ImageTrainDataset(port_cfg, 32),
            jax_ds.ImageTrainDataset(jax_cfg, 32), port_cfg, jax_cfg,
            PortWordPiece(port_cfg.text_vocab),
            JaxWordPiece(jax_cfg.text_vocab))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_train_loader_batches_match(both_datasets):
    port_train, jax_train, port_cfg, jax_cfg, port_tok, jax_tok = \
        both_datasets
    port_loader = port_pipe.TrainLoader(port_train, port_tok, port_cfg,
                                        batch_size=4, num_workers=2)
    jax_loader = jax_pipe.TrainLoader(jax_train, jax_tok, jax_cfg,
                                      batch_size=4, num_workers=2)
    assert port_loader.steps_per_epoch() == jax_loader.steps_per_epoch() >= 4
    for epoch in range(2):
        _assert_batches_equal(list(port_loader.epoch(epoch)),
                              list(jax_loader.epoch(epoch)))
    _assert_batches_equal(list(port_loader.epoch(1, start_step=2)),
                          list(jax_loader.epoch(1, start_step=2)))
    _assert_batches_equal(list(port_loader.epoch(1, start_step=2)),
                          list(port_loader.epoch(1))[2:])


def test_eval_loader_batches_match(both_datasets, tmp_path):
    _, _, port_cfg, jax_cfg, port_tok, jax_tok = both_datasets
    if port_cfg.dataset == "mscoco":
        ann = dict(port_cfg.val_file)
    else:
        ann = dict(port_cfg.test_file)
    split = "eval" if port_cfg.dataset == "mscoco" else "test"
    (lang, rel), = ann.items()
    port_eval = port_ds.ImageEvalDataset(port_cfg, rel, 36, split)
    jax_eval = jax_ds.ImageEvalDataset(jax_cfg, rel, 36, split)
    port_loader = port_pipe.EvalLoader(port_eval, port_tok, port_cfg,
                                       batch_size=3, text_batch_size=4,
                                       num_workers=2)
    jax_loader = jax_pipe.EvalLoader(jax_eval, jax_tok, jax_cfg,
                                     batch_size=3, text_batch_size=4,
                                     num_workers=2)
    for _ in range(2):  # the second pass reads the cached tokenization
        got, want = (list(port_loader.text_batches()),
                     list(jax_loader.text_batches()))
        assert [g[2] for g in got] == [w[2] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
    got, want = (list(port_loader.image_batches()),
                 list(jax_loader.image_batches()))
    assert [g[1] for g in got] == [w[1] for w in want]
    _assert_batches_equal([g[0] for g in got], [w[0] for w in want])
    assert (dataclasses.asdict(port_eval.index)
            == dataclasses.asdict(jax_eval.index))


def test_normalize_caption_and_eval_index_match():
    raw = ["A man, riding a BIKE!", "Two-dogs/run (fast) <person> here.",
           "  spaces   everywhere\n", "x " * 40, "Ünïcode: café; naïve?",
           "it's 'quoted' \"text\" #1 ~ok~ *star*"]
    for text in raw:
        for max_words in (30, 5):
            assert (port_text.normalize_caption(text, max_words)
                    == jax_text.normalize_caption(text, max_words))
    assert port_text.normalize_caption("A man, riding a BIKE!") == (
        "a man riding a bike")
    assert port_text.normalize_caption("Two-dogs/run <person>") == (
        "two dogs run person")
    with pytest.raises(ValueError):
        port_text.normalize_caption(" ,.!? ")
    entries = [("img2.jpg#enc#0", "A dog."), ("img1#enc#0", "A cat."),
               ("img2.jpg#enc#1", "Dog runs."), ("img3.mp4#enc#0", "Bird"),
               ("img1#enc#1", "Cat sits")]
    got = port_text.build_eval_index(entries)
    want = jax_text.build_eval_index(entries)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.image_ids == ["img2", "img1", "img3"]
    for cap_id in ("a#enc#0", "b.jpg#enc2fr#1", "c.mp4"):
        assert port_text.video_id_of(cap_id) == jax_text.video_id_of(cap_id)
    for path in ("TextData/Flickr30ktrain_google_enc2fr.caption.txt",
                 "x/train_enc2de.caption.txt"):
        assert (port_text.language_of_train_file(path)
                == jax_text.language_of_train_file(path))


def test_mid_epoch_start_with_three_target_languages(tmp_path):
    """start_step continues the per-batch target-language round robin
    where it was (the batch's position in the epoch), so a resumed epoch
    equals the tail of the uninterrupted one."""
    cfg = port_synth.make_image_dataset(str(tmp_path), n_train=12, n_eval=2,
                                        caps_per_image=2, image_res=24)
    text = Path(tmp_path, "TextData")
    for lang in ("fr", "cs"):
        (text / f"train_enc2{lang}.caption.txt").write_text(
            (text / "train_enc2de.caption.txt").read_text()
            .replace("#enc2de#", f"#enc2{lang}#").replace("ein", lang))
        cfg.train_file.append(f"TextData/train_enc2{lang}.caption.txt")
    loader = port_pipe.TrainLoader(port_ds.ImageTrainDataset(cfg, 24),
                                   PortWordPiece(cfg.text_vocab), cfg,
                                   batch_size=4, num_workers=2)
    full = list(loader.epoch(0))
    assert len(full) == 6
    targets = {tuple(b["text_ids_t"][0]) for b in full}
    assert len(targets) > 1
    for start in (1, 2, 5):
        _assert_batches_equal(list(loader.epoch(0, start_step=start)),
                              full[start:])


class _Broken(Exception):
    pass


class _FailingTrainDataset:
    """Wraps a train dataset; get() raises for sample `bad`."""

    def __init__(self, inner, bad: int):
        self.inner, self.bad = inner, bad

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self):
        return len(self.inner)

    def get(self, index, *args):
        if index == self.bad:
            raise _Broken(f"cannot read sample {index}")
        return self.inner.get(index, *args)


def _consume(make_iter):
    """Consume make_iter() on a thread within DEADLINE_S; returns (items
    consumed, exception raised)."""
    out = {"items": 0, "error": None}

    def run():
        try:
            for _ in make_iter():
                out["items"] += 1
        except BaseException as exc:
            out["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(DEADLINE_S)
    assert not thread.is_alive(), "the consumer hung"
    return out["items"], out["error"]


def test_worker_exceptions_reach_the_consumer(tmp_path):
    cfg = port_synth.make_image_dataset(str(tmp_path), n_train=12, n_eval=5,
                                        caps_per_image=2, image_res=24)
    tok = PortWordPiece(cfg.text_vocab)
    train = port_ds.ImageTrainDataset(cfg, 24)
    order = port_pipe.shard_indices(len(train), 0, cfg.seed)
    bad = int(order[9])  # in the third batch of 4
    loader = port_pipe.TrainLoader(_FailingTrainDataset(train, bad), tok,
                                   cfg, batch_size=4, num_workers=2)
    items, error = _consume(lambda: loader.epoch(0))
    assert isinstance(error, _Broken) and items == 2
    items, error = _consume(lambda: port_pipe.device_prefetch(
        loader.epoch(0), torch.device("cpu")))
    assert isinstance(error, _Broken) and items == 2
    items, error = _consume(lambda: port_pipe.device_prefetch(
        port_pipe.background_iter(loader.epoch(0)), torch.device("cpu")))
    assert isinstance(error, _Broken) and items == 2

    (rel,) = cfg.test_file.values()
    evals = port_ds.ImageEvalDataset(cfg, rel, 24, "test")
    read = evals.get

    def get(index):  # sample 4: in the second batch of 3
        if index == 4:
            raise _Broken(f"cannot read sample {index}")
        return read(index)

    evals.get = get
    eval_loader = port_pipe.EvalLoader(evals, tok, cfg, batch_size=3,
                                       text_batch_size=4, num_workers=2)
    items, error = _consume(lambda: port_pipe.device_prefetch(
        port_pipe.background_iter(eval_loader.image_batches()),
        torch.device("cpu")))
    assert isinstance(error, _Broken) and items == 1


def test_background_stops_its_thread_when_the_consumer_stops():
    produced = []

    def produce(put):
        for i in range(1000):
            produced.append(i)
            if not put(i):
                return

    before = threading.active_count()
    it = port_pipe.background(produce, depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert threading.active_count() == before
    assert len(produced) <= 6
