"""The port's video data path against the JAX package's, bit for bit: the
feature bank (round trip, row reads, the streaming reader, `read_video`'s
uniform subsampling and padding), `read_video2frames` (a literal, never
code), `make_video_dataset`'s files byte for byte, the video datasets'
samples and the train and eval loaders' batches, frames and masks
included."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from leccr_torch.data import datasets as port_ds
from leccr_torch.data import feature_bank as port_fb
from leccr_torch.data import pipeline as port_pipe
from leccr_torch.data import synthetic as port_synth
from leccr_torch.data.tokenizers import WordPieceTokenizer as PortWordPiece
from leccr_tpu.data import datasets as jax_ds
from leccr_tpu.data import feature_bank as jax_fb
from leccr_tpu.data import pipeline as jax_pipe
from leccr_tpu.data import synthetic as jax_synth
from leccr_tpu.data.tokenizers import WordPieceTokenizer as JaxWordPiece


def _files(root: Path):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kwargs", [
    {},
    {"n_train": 7, "n_eval": 4, "caps_per_video": 3, "feat_dim": 24,
     "frames_per_video": 9, "seed": 5, "target_lang": "fr"},
])
def test_make_video_dataset_is_byte_identical(tmp_path, kwargs):
    port_cfg = port_synth.make_video_dataset(str(tmp_path / "port"),
                                             **kwargs)
    jax_cfg = jax_synth.make_video_dataset(str(tmp_path / "jax"), **kwargs)
    port_files, jax_files = (_files(tmp_path / "port"),
                             _files(tmp_path / "jax"))
    assert list(port_files) == list(jax_files)
    assert port_files == jax_files
    want = dataclasses.asdict(jax_cfg)
    for key in ("root_dir", "generated_caption_dir", "text_vocab"):
        want[key] = want[key].replace(str(tmp_path / "jax"),
                                      str(tmp_path / "port"))
    assert dataclasses.asdict(port_cfg) == want


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    rs = np.random.RandomState(3)
    names = [f"v{i // 7}_f{i % 7}" for i in range(40)]
    matrix = rs.randn(40, 12).astype(np.float32)
    path = tmp_path_factory.mktemp("bank") / "feats"
    port_fb.write_feature_bank(str(path), names, matrix)
    return path, names, matrix


def test_feature_bank_round_trip_matches_jax(bank_dir, tmp_path):
    path, names, matrix = bank_dir
    jax_fb.write_feature_bank(str(tmp_path / "jax"), names, matrix)
    assert _files(path) == _files(tmp_path / "jax")
    port, jax = port_fb.FeatureBank(str(path)), jax_fb.FeatureBank(str(path))
    assert port.shape == jax.shape == (40, 12)
    assert port.names == jax.names == names
    pick = [names[i] for i in (5, 0, 39, 5, 17)]
    np.testing.assert_array_equal(port.read_rows(pick), jax.read_rows(pick))
    np.testing.assert_array_equal(port.read_rows(pick), matrix[
        [5, 0, 39, 5, 17]])
    np.testing.assert_array_equal(port.read_one(names[9]), matrix[9])
    for block in (1, 7, 64):
        got, want = list(port.iter_rows(block)), list(jax.iter_rows(block))
        assert [n for n, _ in got] == [n for n, _ in want] == names
        np.testing.assert_array_equal(np.stack([r for _, r in got]), matrix)


@pytest.mark.parametrize("n_frames,max_frames", [
    (3, 5), (5, 5), (7, 5), (7, 3), (40, 32), (1, 4)])
def test_read_video_subsamples_and_pads_as_jax(bank_dir, n_frames,
                                               max_frames):
    path, names, _ = bank_dir
    frames = names[:n_frames]
    got = port_fb.FeatureBank(str(path)).read_video(frames, max_frames)
    want = jax_fb.FeatureBank(str(path)).read_video(frames, max_frames)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() == min(n_frames, max_frames)


def test_read_video2frames_parses_a_literal_only(tmp_path):
    path = tmp_path / "video2frames.txt"
    mapping = {"video0": ["video0_f0", "video0_f1"], "v1": ["v1_f0"]}
    path.write_text(repr(mapping))
    assert (port_fb.read_video2frames(str(path))
            == jax_fb.read_video2frames(str(path)) == mapping)
    path.write_text("__import__('os').getcwd()")
    for read in (port_fb.read_video2frames, jax_fb.read_video2frames):
        with pytest.raises(ValueError):
            read(str(path))


@pytest.fixture(scope="module")
def both_video(tmp_path_factory):
    """The same synthetic MSR-VTT-layout set, written by each package,
    with 3–9 frames a video against max_frames 6 (some padded, some
    subsampled)."""
    tmp = tmp_path_factory.mktemp("video")
    cfgs = []
    for pkg, synth in (("port", port_synth), ("jax", jax_synth)):
        cfg = synth.make_video_dataset(str(tmp / pkg), n_train=11, n_eval=5,
                                       caps_per_video=2, feat_dim=16,
                                       frames_per_video=9, seed=4)
        cfg.max_tokens, cfg.token_buckets, cfg.seed = 24, [8, 16, 24], 7
        cfgs.append(cfg)
    return cfgs


def test_video_samples_match(both_video):
    port_cfg, jax_cfg = both_video
    port, jax = (port_ds.VideoTrainDataset(port_cfg, 6),
                 jax_ds.VideoTrainDataset(jax_cfg, 6))
    assert len(port) == len(jax) == 22
    rs = np.random.RandomState(0)
    for i in range(len(port)):
        got, want = port.get(i, rs), jax.get(i, rs)
        assert (got.texts, got.caption, got.idx, got.cap_id, got.flip) == (
            want.texts, want.caption, want.idx, want.cap_id, want.flip)
        assert got.image_u8 is None
        np.testing.assert_array_equal(got.frames, want.frames)
        np.testing.assert_array_equal(got.frame_mask, want.frame_mask)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_video_train_loader_batches_match(both_video):
    port_cfg, jax_cfg = both_video
    port_loader = port_pipe.TrainLoader(
        port_ds.VideoTrainDataset(port_cfg, 6),
        PortWordPiece(port_cfg.text_vocab), port_cfg, batch_size=4,
        num_workers=2)
    jax_loader = jax_pipe.TrainLoader(
        jax_ds.VideoTrainDataset(jax_cfg, 6),
        JaxWordPiece(jax_cfg.text_vocab), jax_cfg, batch_size=4,
        num_workers=2)
    assert port_loader.steps_per_epoch() == jax_loader.steps_per_epoch() == 5
    for epoch in range(2):
        got = list(port_loader.epoch(epoch))
        _assert_batches_equal(got, list(jax_loader.epoch(epoch)))
        assert got[0]["vision"].shape == (4, 6, 16)
        assert got[0]["vision_mask"].dtype == bool
        assert "flip" not in got[0]
    _assert_batches_equal(list(port_loader.epoch(1, start_step=3)),
                          list(jax_loader.epoch(1, start_step=3)))


@pytest.mark.parametrize("split", ["eval", "test"])
def test_video_eval_loader_batches_match(both_video, split):
    """Batches of 3 over 5 videos: the last one padded by repeating its
    last row, as in JAX."""
    port_cfg, jax_cfg = both_video
    files = port_cfg.val_file if split == "eval" else port_cfg.test_file
    (_, rel), = dict(files).items()
    port_eval = port_ds.VideoEvalDataset(port_cfg, rel, 6, split)
    jax_eval = jax_ds.VideoEvalDataset(jax_cfg, rel, 6, split)
    port_loader = port_pipe.EvalLoader(
        port_eval, PortWordPiece(port_cfg.text_vocab), port_cfg,
        batch_size=3, text_batch_size=4, num_workers=2)
    jax_loader = jax_pipe.EvalLoader(
        jax_eval, JaxWordPiece(jax_cfg.text_vocab), jax_cfg, batch_size=3,
        text_batch_size=4, num_workers=2)
    got, want = (list(port_loader.text_batches()),
                 list(jax_loader.text_batches()))
    assert [g[2] for g in got] == [w[2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    got, want = (list(port_loader.image_batches()),
                 list(jax_loader.image_batches()))
    assert [g[1] for g in got] == [w[1] for w in want] == [3, 2]
    _assert_batches_equal([g[0] for g in got], [w[0] for w in want])
    last = got[-1][0]
    np.testing.assert_array_equal(last["vision"][2], last["vision"][1])
    np.testing.assert_array_equal(last["vision_mask"][2],
                                  last["vision_mask"][1])
    assert (dataclasses.asdict(port_eval.index)
            == dataclasses.asdict(jax_eval.index))
