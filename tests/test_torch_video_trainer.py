"""The port's video path end to end on CPU, against the JAX package's
(tests/test_train.py's video trainer, at the same tiny widths: 32-d frames
at 4 heads, 2 slots, 6 frames; every dropout at 0, lr 1e-3, no warmup):

  - one epoch of `Trainer.fit` over byte-identical synthetic MSR-VTT
    sets, from JAX's initial parameters: the JSONL record's train_*
    averages within 1e-4 (printed to 5 decimals), the double-sim eval's
    metrics equal;
  - `evaluate` on identical weights: text embeddings, video features and
    slots within 1e-5, metrics equal for the default fusion (auto:
    minmax for video) and for none and raw;
  - `python -m leccr_torch.run --task vtr_caption` on a synthetic video
    set: trains, evaluates and resumes; a config without a temporal tower
    is refused;
  - serving: `build_video_index` (an [N, T, D] array with its mask, and a
    list of [t_i, D] arrays) and `search_texts(fusion="minmax")` against
    the JAX Embedder at equal weights: index rows within 1e-4, scores
    within 1e-4, ids wherever the scores are distinct.
"""

import json

import jax
import numpy as np
import pytest

from leccr_torch.config import tiny_test_config as port_tiny_config
from leccr_torch.data.synthetic import make_video_dataset as port_videos
from leccr_torch.data.tokenizers import write_tiny_wordpiece_vocab
from leccr_torch.models.weights import load_jax_params
from leccr_torch.serve import Embedder as PortEmbedder
from leccr_torch.train import trainer as port_trainer
from leccr_tpu.config import tiny_test_config
from leccr_tpu.data.synthetic import make_video_dataset as jax_videos

LR = 1e-3
VIDEO = {"model.vision.kind": "temporal", "model.vision.frame_feat_dim": 32,
         "model.vision.num_layers": 1, "model.vision.num_heads": 4,
         "model.vision.max_frames": 6, "model.num_queries": 2,
         "model.dropout": 0.0, "model.text.hidden_dropout": 0.0,
         "model.text.attention_dropout": 0.0, "data.num_workers": 2,
         "train.batch_size_train": 8, "train.batch_size_test": 4,
         "train.batch_size_test_text": 8, "train.schedular.epochs": 1,
         "train.schedular.num_warmup_steps": 0, "train.optimizer.lr": LR,
         "parallel.data": 1}


def _cfg(make_config, make_data, root, **overrides):
    """The tiny video config over a synthetic MSR-VTT set written under
    `root` (12 videos x 2 captions: 3 steps at bs8; 4 eval videos a
    split)."""
    cfg = make_config(**{**VIDEO, **overrides})
    cfg.data = make_data(str(root / "data"), n_train=12, n_eval=4,
                         feat_dim=32, frames_per_video=8)
    cfg.output_dir = str(root / "out")
    return cfg


def _records(cfg):
    with open(f"{cfg.output_dir}/log.txt") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    from leccr_tpu.train.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("video_fit")
    jax_tr = JaxTrainer(_cfg(tiny_test_config, jax_videos, tmp / "jax"),
                        devices=jax.devices()[:1])
    assert jax_tr.is_video
    init = jax.tree.map(lambda x: np.array(x, copy=True), jax_tr.state.params)
    port_tr = port_trainer.Trainer(
        _cfg(port_tiny_config, port_videos, tmp / "port"), device="cpu")
    assert port_tr.is_video
    load_jax_params(port_tr.state.model, init)
    jax_tr.fit()
    port_tr.fit()
    return jax_tr, port_tr


def test_video_fit_logs_match_jax(fitted):
    jax_tr, port_tr = fitted
    (want, want_best), (got, got_best) = (_records(jax_tr.cfg),
                                          _records(port_tr.cfg))
    assert set(got) == set(want)
    assert "zh_test_sumr_sum" in got
    for key, value in want.items():
        if key.startswith("train_"):
            assert abs(float(got[key]) - float(value)) <= 1e-4, key
        else:
            assert got[key] == value, key
    assert got_best == want_best
    assert port_tr.state.step == 3


@pytest.mark.parametrize("fusion", ["auto", "none", "raw"])
def test_video_evaluate_matches_jax_on_equal_weights(fitted, fusion):
    """Both evaluate JAX's final parameters; "auto" is the double-sim
    (minmax) for video in both packages."""
    from leccr_tpu.data.pipeline import EvalLoader

    jax_tr, port_tr = fitted
    params = jax.tree.map(np.asarray, jax_tr.eval_params)
    load_jax_params(port_tr.state.model, params)
    for lang, port_ds in port_tr.test_ds.items():
        jax_ds = jax_tr.test_ds[lang]
        img, slots, txt = port_tr.embed_split(port_ds)
        loader = EvalLoader(jax_ds, jax_tr.tokenizer, jax_tr.cfg.data,
                            jax_tr.cfg.train.batch_size_test,
                            jax_tr.cfg.train.batch_size_test_text)
        want_txt = np.concatenate([np.asarray(jax_tr._embed_texts_stacked(
            params, ids[None], mask[None]))[0][:n]
            for ids, mask, n in loader.text_batches()])
        want_img, want_slots = [], []
        for batch, count in loader.image_batches():
            out = jax_tr._embed_images(params, batch)  # frames as they are
            want_img.append(np.asarray(out["feat"])[:count])
            want_slots.append(np.asarray(out["slots"])[:count])
        for got, want in ((txt, want_txt), (img, np.concatenate(want_img)),
                          (slots, np.concatenate(want_slots))):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        for trainer in (port_tr, jax_tr):
            trainer.cfg.train.eval_fusion = fusion
        try:
            assert port_tr.evaluate(port_ds) == jax_tr.evaluate(jax_ds)
        finally:
            for trainer in (port_tr, jax_tr):
                trainer.cfg.train.eval_fusion = "auto"


def test_auto_fusion_is_the_double_sim_for_video(fitted, monkeypatch):
    _, port_tr = fitted
    seen = []
    ranker = port_trainer.retrieval_ranks

    def spy(*args, **kwargs):
        seen.append(kwargs["fusion"])
        return ranker(*args, **kwargs)

    monkeypatch.setattr(port_trainer, "retrieval_ranks", spy)
    port_tr.evaluate(next(iter(port_tr.test_ds.values())))
    assert seen == ["minmax"]


def _cli(args):
    from leccr_torch.run import main

    main(["--task", "vtr_caption", "--device", "cpu", *args])


def test_cli_trains_evaluates_and_resumes_a_video_set(tmp_path):
    cfg = _cfg(port_tiny_config, port_videos, tmp_path, **{
        "train.schedular.epochs": 2})
    config = tmp_path / "video.json"
    cfg.save(str(config))
    out = tmp_path / "run"
    _cli(["--config", str(config), "--output_dir", str(out)])
    records = [json.loads(line)
               for line in (out / "log.txt").read_text().splitlines()]
    assert [r.get("epoch") for r in records] == [0, 1, None]
    assert np.isfinite(records[1]["zh_test_sumr_sum"])
    assert np.isfinite(float(records[1]["train_loss_itc_vs"]))
    assert list((out / "checkpoints").glob("step_*.pt"))
    # the restored weights evaluated again as epoch 2 of 3: the same
    # double-sim metrics as the last epoch's
    _cli(["--config", str(config), "--output_dir", str(out), "--evaluate",
          "--resume", "--epoch", "3"])
    again = [json.loads(line) for line in
             (out / "log.txt").read_text().splitlines()][len(records):]
    assert [r.get("epoch") for r in again] == [2, None]
    assert {k: v for k, v in again[0].items() if k != "epoch"} == {
        k: v for k, v in records[1].items()
        if k != "epoch" and not k.startswith("train_")}


def test_cli_vtr_caption_needs_a_temporal_tower(tmp_path):
    cfg = port_tiny_config()
    config = tmp_path / "image.json"
    cfg.save(str(config))
    with pytest.raises(SystemExit, match="temporal"):
        _cli(["--config", str(config), "--output_dir", str(tmp_path / "o")])


WORDS = "a man rides his red bike dog runs in the green field".split()


@pytest.fixture(scope="module")
def embedders(tmp_path_factory):
    """The JAX and the port's Embedder of the tiny video model at equal
    (moved-off-init) weights, batch 4."""
    import jax.numpy as jnp

    from leccr_tpu.models.leccr import LECCRModel
    from leccr_tpu.serve import Embedder

    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    write_tiny_wordpiece_vocab(str(vocab), WORDS)
    cfg = tiny_test_config(**VIDEO)
    cfg.data.text_vocab = str(vocab)
    rs = np.random.RandomState(0)
    ids = rs.randint(1, 512, (1, 8)).astype(np.int32)
    one = np.ones((1, 8), np.int32)
    batch = {"vision": rs.randn(1, 6, 32).astype(np.float32),
             "vision_mask": np.ones((1, 6), bool),
             "text_ids_s": ids, "text_mask_s": one, "text_ids_t": ids,
             "text_mask_t": one, "caption_ids": ids, "caption_mask": one}
    params = LECCRModel(cfg.model).init(
        {"params": jax.random.PRNGKey(0)},
        jax.tree.map(jnp.asarray, batch))["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rs.randn(*np.shape(x)), np.float32),
        params)
    port_cfg = port_tiny_config(**VIDEO)
    port_cfg.data.text_vocab = str(vocab)
    return (Embedder(cfg, params, batch_size=4),
            PortEmbedder.from_config(port_cfg, params=params, device="cpu",
                                     batch_size=4))


CAPTIONS = ["a man rides his red bike", "a dog runs", "the green field",
            "a red dog in the field", "his bike", "a man", "dog"]
QUERIES = ["a red bike", "dog in field", "man", "the green dog runs",
           "his field", "a bike"]  # 6 > batch_size 4: both search paths


def _same_ranking(got, want):
    """Scores agree everywhere; ids agree where the scores are distinct."""
    for g_row, w_row in zip(got, want):
        g_ids, g_s = zip(*g_row)
        w_ids, w_s = zip(*w_row)
        np.testing.assert_allclose(g_s, w_s, rtol=0, atol=1e-4)
        w_s = np.asarray(w_s)
        for j, wid in enumerate(w_ids):
            if np.abs(np.delete(w_s, j) - w_s[j]).min() > 1e-3:
                assert g_ids[j] == wid


@pytest.mark.parametrize("layout", ["array", "array_no_mask", "list"])
def test_video_index_and_minmax_search_match_jax(embedders, layout):
    """7 videos of 2-9 frames (max_frames 6: some padded, some cut) in two
    index batches (the last padded by repeating its last row)."""
    jax_emb, port = embedders
    rs = np.random.RandomState(1)
    lengths = [2, 6, 9, 3, 1, 6, 4]
    if layout == "list":
        frames = [rs.randn(t, 32).astype(np.float32) for t in lengths]
        masks = None
    else:
        frames = rs.randn(len(lengths), 8, 32).astype(np.float32)
        masks = (None if layout == "array_no_mask" else
                 np.arange(8)[None, :] < np.asarray(lengths)[:, None])
    want = jax_emb.build_video_index(frames, CAPTIONS, frame_masks=masks)
    got = port.build_video_index(frames, CAPTIONS, frame_masks=masks)
    assert got.ids == want.ids
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.slots.numpy(), np.asarray(want.slots),
                               rtol=0, atol=1e-4)
    for n in (3, len(QUERIES)):
        hits = port.search_texts(QUERIES[:n], got, k=5, fusion="minmax")
        assert len(hits) == n and all(len(r) == 5 for r in hits)
        _same_ranking(hits, jax_emb.search_texts(QUERIES[:n], want, k=5,
                                                 fusion="minmax"))


def test_video_index_needs_a_temporal_tower(tmp_path):
    cfg = port_tiny_config()
    vocab = tmp_path / "vocab.txt"
    write_tiny_wordpiece_vocab(str(vocab), WORDS)
    cfg.data.text_vocab = str(vocab)
    emb = PortEmbedder.from_config(cfg, device="cpu", batch_size=4)
    with pytest.raises(ValueError, match="temporal"):
        emb.build_video_index(np.zeros((2, 3, 32), np.float32), ["a", "b"])
