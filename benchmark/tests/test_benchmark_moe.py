"""The DeepSeek-V2-Lite cell's harness at a CPU test size: the kind
"train_moe" (a whole run, `correct` false under each of its faults), its
mix and limits, the configuration file against the catalog's widths, the
weights' rules, `roofline_moe`'s counts against a hand count, and the
readers of its four per-layer metrics."""

import copy
import json
import types

import pytest
import torch
import yaml

from benchmark import roofline_moe
from benchmark.drivers import load_kind
from benchmark.reference.deepseek_v2 import Tower
from benchmark.reference.model import Arch
from benchmark.run import ROOT, Run, read_metric, run_cell
from benchmark.tests.conftest import tiny_meta
from benchmark.weights_moe import initial_weights

CELL = "dsv2lite_text.train"
TINY_TEXT = {
    "kind": "deepseek_v2", "vocab_size": 512, "hidden_size": 64,
    "num_layers": 3, "num_heads": 2, "intermediate_size": 96,
    "hidden_dropout": 0.0, "attention_dropout": 0.0, "deepseek": {
        "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "moe_intermediate_size": 32, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "n_shared_experts": 1,
        "first_k_dense_replace": 1, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0,
        "rope_scaling": {"factor": 40,
                         "original_max_position_embeddings": 4096,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                         "mscale_all_dim": 0.707},
        "experts_held": 4, "expert_offset": 0, "aux_loss_alpha": 0.001}}


@pytest.fixture
def tiny_moe():
    from leccr_torch.config import LECCRConfig

    meta = tiny_meta()
    meta["config"]["model"]["text"] = copy.deepcopy(TINY_TEXT)
    return LECCRConfig.from_dict(copy.deepcopy(meta["config"])), meta


def _run(tiny_moe):
    cfg, meta = tiny_moe
    return run_cell(CELL, 2 ** 31 + 77, 0.3, False, device="cpu",
                    cfg_override=cfg, meta_override=meta, watchdog=False)


def test_a_sound_run_is_correct(tiny_moe):
    result = _run(tiny_moe)
    assert result["correct"], result["checks"]
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{CELL}.json")
                        .read_text())["limits"]
    assert set(result["checks"]) == set(limits)
    assert result["checks"]["routing_mismatches"]["value"] == 0.0
    assert result["checks"]["choice_mismatches"]["value"] == 0.0
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_bf16_hidden_states_alone_flip_the_reference_routing(tiny_moe):
    """At bf16 compute the reference's own f32 top-k (from its f32 hidden
    states) differs from the program's on some tokens, while the top-k of
    the program's own router rows agrees on every token: the floor of
    `routing_mismatches` is the hidden states' rounding, and
    `choice_mismatches` is free of it."""
    cfg, meta = tiny_moe
    cfg.model.dtype = meta["config"]["model"]["dtype"] = "bfloat16"
    checks = _run((cfg, meta))["checks"]
    assert checks["routing_mismatches"]["value"] > 0.0
    assert checks["choice_mismatches"]["value"] == 0.0


@pytest.mark.parametrize("fault", [f.__name__ for f in
                                   load_kind("train_moe").FAULTS])
def test_every_fault_is_caught(fault, tiny_moe):
    with getattr(load_kind("train_moe"), fault)():
        result = _run(tiny_moe)
    assert not result["correct"], result["checks"]


def test_the_configuration_holds_the_catalog_widths():
    meta = yaml.safe_load((ROOT / "benchmark" / "configs"
                           / "dsv2lite_text.yaml").read_text())
    text = meta["config"]["model"]["text"]
    same = {"hidden_size": "hidden_size", "num_attention_heads": "num_heads",
            "intermediate_size": "intermediate_size",
            "vocab_size": "vocab_size", "num_hidden_layers": "num_layers"}
    for top, key in same.items():
        assert meta[top] == text[key], top
    deepseek = text["deepseek"]
    for key in ("kv_lora_rank", "experts_held", "qk_nope_head_dim",
                "qk_rope_head_dim", "v_head_dim", "moe_intermediate_size",
                "n_routed_experts", "num_experts_per_tok", "n_shared_experts",
                "first_k_dense_replace", "rms_norm_eps", "rope_theta"):
        assert meta[key] == deepseek[key], key
    assert {k: v for k, v in meta["rope_scaling"].items() if k != "type"} \
        == deepseek["rope_scaling"]
    assert set(meta["reduced"]) == {"num_hidden_layers", "experts_held"}
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / "train_bucketed_moe.json").read_text())
    flagship = json.loads((ROOT / "benchmark" / "traffic"
                           / "train_bucketed.json").read_text())
    assert {k: v for k, v in mix.items() if k not in ("kind", "about")} == \
        {k: v for k, v in flagship.items() if k not in ("kind", "about")}


def test_weights_follow_their_rules():
    shapes = [("text_encoder.layers.1.input_layernorm.weight", (64,)),
              ("text_encoder.layers.1.mlp.experts.down_proj", (4, 64, 400)),
              ("text_encoder.layers.1.mlp.gate.weight", (8, 64)),
              ("text_encoder.embed_tokens.weight", (512, 64)),
              ("temp", ())]
    w = initial_weights(shapes, 0.07, 5, "cpu")
    assert list(w) == [n for n, _ in shapes]
    assert torch.equal(w[shapes[0][0]], torch.ones(64))
    assert float(w[shapes[1][0]].std()) == pytest.approx(400 ** -0.5,
                                                         rel=0.05)
    assert float(w["temp"]) == pytest.approx(0.07)
    again = initial_weights(shapes, 0.07, 5, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    with pytest.raises(ValueError, match="no initial value rule"):
        initial_weights([("text_encoder.layers.0.odd", (2, 2, 2, 2))], 0.07,
                        5, "cpu")


def _tower():
    return Tower.of(dict(TINY_TEXT, num_layers=3))


def test_roofline_moe_against_a_hand_count():
    t = _tower()
    # one sequence of 4 tokens: per token, per layer q 2*64*(2*24),
    # kv_a 2*64*24, kv_b 2*16*(2*32), o 2*(2*16)*64, attention 2*4*2*40;
    # the dense layer 6*64*96; two MoE layers 2*64*8 + 6*64*32
    per_layer = (2 * 64 * 48 + 2 * 64 * 24 + 2 * 16 * 64 + 2 * 32 * 64
                 + 2 * 4 * 2 * 40)
    hand = 4 * (3 * per_layer + 6 * 64 * 96 + 2 * (2 * 64 * 8
                                                  + 6 * 64 * 32))
    assert roofline_moe.tower_forward_flops(t, 1, 4, 0) == hand
    assert roofline_moe.tower_forward_flops(t, 1, 4, 10) == \
        hand + 10 * 6 * 64 * 32
    ms, what = roofline_moe.gemm_launch("dw", 1000, 1408, 2048, 8)
    n_bytes = 2 * (1000 * 1408 + 1000 * 2048) + 4 * 8 * 1408 * 2048
    assert what == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3)
    launches = roofline_moe.step_launches(t, [5, 7], [3, 2])
    assert roofline_moe.launch_counts(launches) == {
        "fwd": 2 * 6 + 2 * 3, "dx": 2 * 3, "dw": 2 * 3}


def _fake_run(tiny_moe, slots, counted=None, families_ms=1.0):
    """A traced run's trace and a span store of 3 steps, each noting its
    routed slots as the program's `train.step` does."""
    cfg, meta = tiny_moe

    class Root:
        parent, name = None, "train.step"

        def __init__(self, i, s):
            self.id = self.root = i
            self.device_ms, self.syncs = 10.0, 0
            self.s = s

        def reading(self, name):
            return self.s.get(name.split(".")[1])

    class Child:
        device_ms, syncs = 2.5, 0

        def __init__(self, i, name):
            self.id, self.root, self.parent, self.name = 100 + i, i, i, name

    spans = []
    for i, s in enumerate(slots):
        spans += [Root(i, s), Child(i, "text.moe"), Child(i, "text.mla")]
    widths = [{"text": 16, "caption": 16, "batch": 8}] * len(slots)
    n = sum(len(roofline_moe.step_launches(_tower(), s["text"],
                                           s["caption"])) for s in slots)
    trace = {"window_s": 1.0, "widths": widths,
             "families": {"grouped_gemm": families_ms / 1e3},
             "grouped_gemm_traced": n,
             "grouped_gemm_counted": n if counted is None else counted}
    driver = types.SimpleNamespace(
        arch=Arch.of(meta["config"]["model"]), cfg=cfg, trace=trace,
        meta=meta, mix={"trace_steps": len(slots)})
    return Run(driver), spans


def test_the_metric_readers(tiny_moe, monkeypatch):
    from benchmark.metrics import _moe, _spans

    slots = [{"text": [40, 50], "caption": [10, 20]}] * 3
    run, spans = _fake_run(tiny_moe, slots)
    monkeypatch.setattr(_spans, "_spans", lambda: spans)
    assert read_metric("moe_ms.train", run) == pytest.approx(2.5)
    assert read_metric("mla_ms.train", run) == pytest.approx(2.5)
    t = _tower()
    flops = roofline_moe.train_step_flops(run.arch, t, 8, 16, 16, 90, 30)
    assert read_metric("moe_train_mfu", run) == pytest.approx(
        100 * 3 * flops / 989e12)
    bound = sum(roofline_moe.gemm_launch(*x)[0] for x in
                roofline_moe.step_launches(t, [40, 50], [10, 20])) * 3
    assert read_metric("grouped_gemm_roofline", run) == pytest.approx(
        100 * bound / 1.0)
    # a counter that disagrees with the shapes leaves the roofline out
    run, spans = _fake_run(tiny_moe, slots, counted=1)
    monkeypatch.setattr(_spans, "_spans", lambda: spans)
    assert read_metric("grouped_gemm_roofline", run) is None
    # a program that notes no routing (the parent's) reads nothing
    for s in spans:
        if s.parent is None:
            s.s = {}
    assert read_metric("moe_train_mfu", run) is None
    assert _moe.routed_slots(run) is None
