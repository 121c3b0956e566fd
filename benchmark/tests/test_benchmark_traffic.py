"""The traffic: each mix is a function of the seed alone through its
kind's input maker, and every seed gives the same padded widths."""

import dataclasses
import json

import pytest
import torch

from benchmark.drivers import load_kind
from benchmark.run import ROOT

MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "benchmark" / "traffic").glob("*.json")}


def _small(mix):
    return dict(mix, **load_kind(mix["kind"]).TEST_SIZE)


def _make(mix, cfg, seed):
    return load_kind(mix["kind"]).inputs(mix, cfg, seed, "cpu")


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            xa, ya = torch.as_tensor(x[k]), torch.as_tensor(y[k])
            if not torch.equal(xa, ya):
                return False
    return True


@pytest.mark.parametrize("name", sorted(MIXES))
def test_mix_is_deterministic_per_seed(name, tiny):
    cfg, _ = tiny
    mix = _small(MIXES[name])
    seed = 2 ** 31 + 12345
    a, b = _make(mix, cfg, seed), _make(mix, cfg, seed)
    assert _equal(a, b)
    c = _make(mix, cfg, seed + 1)
    assert not _equal(a, c)
    # the seed changes tokens and pixels, never the padded widths
    for x, y in zip(a, c):
        assert {k: tuple(v.shape) for k, v in x.items()
                if hasattr(v, "shape")} == {k: tuple(v.shape)
                                            for k, v in y.items()
                                            if hasattr(v, "shape")}


def test_train_widths_follow_the_buckets(tiny):
    """8-48 real tokens a text: a batch of 128 rows (256 texts) reaches
    bucket 64 on every seed, so no batch pads to 32."""
    cfg, _ = tiny
    cfg.data.token_buckets = [32, 64, 128]
    cfg.model.text.vocab_size = 2000
    cfg.train.batch_size_train = 128
    mix = MIXES["train_bucketed"]
    pool = _make(dict(mix, pool=4), cfg, 7)
    assert [b["text_ids_s"].shape[1] for b in pool] == [64] * 4
    # a bucket-32 batch needs all 256 lengths at most 32 of 8-48
    assert (25 / 41) ** 256 < 1e-50
    small = _make(dict(mix, pool=8), dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size_train=1)), 7)
    assert {b["text_ids_s"].shape[1] for b in small} == {32, 64}
    assert {b["caption_ids"].shape[1] for b in pool} == {128}
    for b in pool:
        real = b["text_mask_s"].sum(1)
        assert int(real.min()) >= 8 and int(real.max()) <= 48
        assert torch.equal(b["text_ids_s"] != 0, b["text_mask_s"].bool())
        assert len(set(b["idx"].tolist())) == len(b["idx"])


def test_eval_split_pads_like_the_eval_loader(tiny):
    cfg, _ = tiny
    cfg.data.token_buckets, cfg.data.max_tokens = [32, 64, 128], 200
    cfg.model.text.vocab_size = 2000
    mix = dict(MIXES["eval_multi30k"], images=10)
    split = _make(mix, cfg, 3)[0]
    assert split["caption_ids"].shape == (10, 200)
    assert split["text_ids"].shape == (50, 64)
    assert list(split["txt2img"][:6]) == [0, 0, 0, 0, 0, 1]
    assert list(split["img2txt"][1]) == [5, 6, 7, 8, 9]
