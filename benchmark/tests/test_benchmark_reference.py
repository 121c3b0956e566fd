"""The plain reference against the port's own path at
configs/tiny_synth.yaml's widths on the CPU, in float32: the same
weights, batches and dropout bits give the same losses, gradients,
features and ranks; the fp8 control does not."""

import copy

import numpy as np
import pytest
import torch

from benchmark.drivers import load_kind
from benchmark.reference import retrieval
from benchmark.reference.train import leaf_decay, reference_steps
from benchmark.tests.conftest import tiny_meta

TRAIN = load_kind("train")
EVAL = load_kind("eval")
TRAIN_MIX = {"kind": "train", "pool": 4, "text_tokens": [[3, 8], [3, 14]],
             "caption_tokens": [5, 16], "flip_share": 0.5,
             "compared_steps": 3, "warmup_steps": 4, "trace_steps": 2}
EVAL_MIX = {"kind": "eval", "images": 12, "captions_per_image": 3,
            "caption_tokens": [5, 16], "text_tokens": [3, 12]}


def _driver(kind, mix, fused, seed=2 ** 33 + 17):
    from leccr_torch.config import LECCRConfig

    meta = tiny_meta(fused)
    cfg = LECCRConfig.from_dict(copy.deepcopy(meta["config"]))
    return kind.Driver(meta, cfg, mix, seed, "cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_train_steps_match_the_port(fused):
    d = _driver(TRAIN, TRAIN_MIX, fused)
    d.setup()
    d.after_window()
    d.release()
    numbers = {k: v for k, (v, _) in d.check().items()}
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-5
    assert numbers["change_gap"] < 1e-4
    assert numbers["optimizer_mismatches"] == 0


def test_a_step_that_changes_nothing_reads_one():
    d = _driver(TRAIN, TRAIN_MIX, True)
    d.setup()
    ref = reference_steps(d._weights(), d.meta["config"], d.pool[:3],
                          [0, 1, 2], d.meta["schedule_steps"])
    unchanged = {n: torch.zeros_like(c) for n, c in d.changes.items()}
    got = TRAIN.compare_train(d.losses, ref["losses"], d.grad_norms,
                              unchanged, ref, 0.0)
    assert got["change_gap"][0] == pytest.approx(1.0)


def test_the_decay_rule_is_the_programs():
    """Every leaf's weight decay in the program's optimizer is the
    reference's rule's, and the rule decays weights, not biases or
    LayerNorm scales."""
    d = _driver(TRAIN, TRAIN_MIX, True)
    d.setup()
    groups = d._groups()
    config = d.meta["config"]
    wd = config["train"]["optimizer"]["weight_decay"]
    assert {n: g[0] for n, g in groups.items()} == {
        n: leaf_decay(n, config) for n in groups}
    held = {g[0] for g in groups.values()}
    assert held == {0.0, wd}
    assert TRAIN.optimizer_mismatches(groups, config,
                                      d.meta["schedule_steps"], 4) == 0


def test_the_fp8_control_reads_far_from_the_reference():
    d = _driver(TRAIN, TRAIN_MIX, True)
    d.setup()
    got = d.readings(control=True)
    program, control = got["program"], got["control"]
    assert control["loss_gap"] > 100 * program["loss_gap"]
    assert control["grad_gap"] > 100 * program["grad_gap"]


def test_eval_matches_the_port():
    d = _driver(EVAL, EVAL_MIX, True)
    d.setup()
    d.out = d._eval()
    d.release()
    numbers = {k: v for k, (v, _) in d.check().items()}
    assert numbers["image_feat_gap"] < 1e-5
    assert numbers["text_feat_gap"] < 1e-5
    assert numbers["rank_mismatches"] == 0
    assert numbers["metric_mismatches"] == 0


def test_ranks_follow_the_stable_argsort_tie_rule():
    g = torch.Generator().manual_seed(0)
    img = torch.nn.functional.normalize(torch.randn(7, 8, generator=g), dim=1)
    txt = torch.cat([img[[0, 0, 1]], torch.nn.functional.normalize(
        torch.randn(11, 8, generator=g), dim=1)])
    txt2img = np.array([0, 1, 1] + [i % 7 for i in range(11)])
    img2txt = np.full((7, 3), -1)
    for t, i in enumerate(txt2img):
        row = img2txt[i]
        row[np.argmax(row < 0)] = t
    i2t, t2i = retrieval.ranks(img, txt, txt2img, img2txt)
    scores = (img @ txt.T).numpy()
    for t in range(len(txt)):
        order = np.argsort(scores[:, t], kind="stable")[::-1]
        assert t2i[t] == int(np.where(order == txt2img[t])[0][0])
    for i in range(7):
        order = np.argsort(scores[i], kind="stable")[::-1]
        want = min(int(np.where(order == t)[0][0])
                   for t in img2txt[i] if t >= 0)
        assert i2t[i] == want
