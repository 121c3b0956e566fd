"""The train step replayed as CUDA graphs (`train.step.TrainStep`), and what
makes it capturable: `lean_dropout`'s scale as a Python float, the CLIP
constants cached on the device, kernels 2/3's seeds read from device slots
(`ops.dropout.SeedSlots`), the graph gate.

On the CPU: the scale and the preprocessing give the bits they gave, the
gate declines where a graph cannot hold the step and those steps run
eagerly, the seed slots hand out the host draws, the launch counters take
what a replay adds, and an optimizer state written in the other
capturable mode loads.  On the card (skipped here): a replayed flagship
step's losses, gradients and parameters equal the eager step's bit for
bit with dropout on, also where two signatures' graphs share the pool and
replay in turn; the launch counters advance on a replay as on an eager
step, the returned losses do not alias, a step makes no host sync,
kernels 2/3 read their seed from its slot, and a signature stays eager
where its step launches kernels 4/5 with dropout on or the device lacks
room for the pool:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graphs.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from leccr_torch.config import load_config, tiny_test_config
from leccr_torch.data.images import (
    CLIP_MEAN,
    CLIP_STD,
    normalize_images,
    preprocess_train_images,
)
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.ops import add_launch_counts, launch_counts
from leccr_torch.ops.dropout import (
    FlashSeed,
    Generators,
    SeedSlots,
    lean_dropout,
)
from leccr_torch.train.step import graph_declines, make_train_step

ROOT = Path(__file__).resolve().parent.parent


def _old_lean_dropout(x, rate, gen, shard=None):
    """`lean_dropout` as it was: the scale a 0-dim tensor on x's device."""
    thresh = min(65535, int(round(rate * 65536.0)))
    shape = list(x.shape)
    if shard is not None:
        dim, m, world = shard
        shape[dim] *= world
    bits = torch.randint(0, 65536, shape, generator=gen.device,
                         device=x.device, dtype=torch.int32)
    if shard is not None:
        n = x.shape[dim]
        bits = bits.narrow(dim, m * n, n)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(bits >= thresh, x * scale,
                       torch.zeros((), dtype=x.dtype, device=x.device))


@pytest.mark.parametrize("shard", [None, (1, 2, 3)])
@pytest.mark.parametrize("rate", [0.1, 0.2, 1 / 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_lean_dropout_rounds_the_scale_as_before(dtype, rate, shard):
    x = (torch.randn(6, 35, 9, generator=torch.Generator().manual_seed(3))
         * 5).to(dtype)
    got = lean_dropout(x, rate, False, Generators.from_seed(11, "cpu"),
                       shard)
    want = _old_lean_dropout(x, rate, Generators.from_seed(11, "cpu"), shard)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("flipped", [False, True])
def test_image_preprocessing_is_unchanged(flipped):
    u8 = torch.randint(0, 256, (4, 8, 8, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1))
    flip = torch.tensor([True, False, True, False]) if flipped else None
    x = u8.to(torch.float32) / 255.0
    want = (x - torch.from_numpy(CLIP_MEAN)) / torch.from_numpy(CLIP_STD)
    assert torch.equal(normalize_images(u8), want)
    if flipped:
        want = torch.where(flip[:, None, None, None], want.flip(2), want)
    assert torch.equal(preprocess_train_images(u8, flip), want)


GATE = {
    "a mesh": ({}, {"mesh": object()}),
    "blocks replayed": ({}, {"num_blocks": 2}),
    "GradCache": ({"train.grad_cache_microbatches": 2}, {}),
    "RandAugment": ({"data.randaugment": True}, {}),
    "debug_nans": ({"train.debug_nans": True}, {}),
    "video": ({"model.vision.kind": "temporal"}, {}),
    "remat": ({"model.remat": True}, {}),
}


@pytest.mark.parametrize("reason", sorted(GATE))
def test_the_graph_gate_declines(reason):
    overrides, kwargs = GATE[reason]
    why = graph_declines(tiny_test_config(**overrides), "cuda", **kwargs)
    assert len(why) == 1 and why[0].startswith(reason), why
    assert graph_declines(tiny_test_config(**overrides), "cpu",
                          **kwargs)[0] == "not a CUDA device"


def test_the_graph_gate_takes_the_flagship_on_a_card():
    cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
    assert graph_declines(cfg, "cuda") == []
    assert graph_declines(cfg, "cpu") == ["not a CUDA device"]


def _tiny_batch(cfg, seed):
    rs = np.random.RandomState(seed)
    b, length = cfg.train.batch_size_train, cfg.data.max_tokens
    res = cfg.model.vision.image_res
    mask = np.ones((b, length), np.int64)
    mask[1, length // 2:] = 0
    batch = {"vision": torch.from_numpy(
                 rs.randint(0, 256, (b, res, res, 3)).astype(np.uint8)),
             "flip": torch.from_numpy(rs.rand(b) < 0.5),
             "idx": torch.arange(b)}
    for key in ("text_ids_s", "text_ids_t", "caption_ids"):
        batch[key] = torch.from_numpy(rs.randint(5, 500, (b, length)) * mask)
    for key in ("text_mask_s", "text_mask_t", "caption_mask"):
        batch[key] = torch.from_numpy(mask)
    return batch


@pytest.mark.parametrize("options", [
    {}, {"train.grad_cache_microbatches": 2}, {"data.randaugment": True},
    {"train.debug_nans": True}], ids=["cpu", "grad_cache", "randaugment",
                                      "debug_nans"])
def test_declined_steps_run_eagerly(options):
    cfg = tiny_test_config(**{"model.text.fused_attention": True, **options})
    runs = []
    for _ in range(2):
        model = LECCRModel(cfg.model, device="cpu", seed=1)
        step = make_train_step(cfg, model, total_steps=20)
        assert step.graph_declines
        losses = [step.run(_tiny_batch(cfg, k % 2), k) for k in range(3)]
        assert (step.eager_steps, step.graph_captures,
                step.graph_replays) == (3, 0, 0)
        runs.append(torch.stack(losses))
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])


def test_seed_slots_hand_out_the_host_draws():
    plain = Generators.from_seed(9, "cpu")
    slotted = Generators.from_seed(9, "cpu")
    slotted.seeds = SeedSlots("cpu")
    want = [plain.flash_seed() for _ in range(5)]
    got = [slotted.flash_seed() for _ in range(5)]
    assert got == want and all(type(s) is int for s in want)
    assert all(isinstance(s, FlashSeed) for s in got)
    assert [s.slot.data_ptr() for s in got] == [
        slotted.seeds.buf[i:i + 1].data_ptr() for i in range(5)]
    assert slotted.seeds.taken == 5
    with pytest.raises(ValueError):
        slotted.seeds.stage(want[:4])


def test_launch_counts_take_what_is_added():
    from leccr_torch.ops.flash_attention import flash_tower_attention
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention

    before = launch_counts()
    assert ("flash_tower_attention", "fwd_launches") in before
    assert ("flash_tower_attention", "by_value_seed_launches") in before
    assert ("launches_by_body", "few_keys") in before
    assert ("infonce", "stats_launches") in before
    added = {("flash_tower_attention", "fwd_launches"): 36,
             ("fused_cross_attention", "launches"): 2,
             ("launches_by_body", "few_keys"): 2,
             ("infonce", "dq_launches"): 1}
    add_launch_counts(added)
    try:
        assert {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]} == added
        assert flash_tower_attention.fwd_launches == before[
            ("flash_tower_attention", "fwd_launches")] + 36
        assert fused_cross_attention.launches_by_body["few_keys"] == before[
            ("launches_by_body", "few_keys")] + 2
    finally:
        add_launch_counts({k: -v for k, v in added.items()})
    assert launch_counts() == before


def test_spans_are_not_recorded_while_suspended():
    from leccr_torch.utils import tracing

    tracing.reset()
    with tracing.record():
        with tracing.span("train.step"):
            with tracing.suspended():
                with tracing.span("train.forward"):
                    pass
            with tracing.span("train.loss"):
                pass
    assert [s.name for s in tracing.spans()] == ["train.loss", "train.step"]
    tracing.reset()


def test_a_dropped_step_is_freed_without_the_collector():
    """No reference cycle holds a step (nor, on a card, its graphs and
    their pool) until the garbage collector runs."""
    import gc
    import weakref

    cfg = tiny_test_config()
    model = LECCRModel(cfg.model, device="cpu", seed=1)
    step = make_train_step(cfg, model, total_steps=20)
    step.run(_tiny_batch(cfg, 0), 0)
    ref = weakref.ref(step)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del step
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_optimizer_state_of_the_other_mode_loads():
    """A state written by a capturable AdamW (step counts on the card)
    loads into a step on the CPU, and trains on."""
    cfg = tiny_test_config()
    model = LECCRModel(cfg.model, device="cpu", seed=1)
    step = make_train_step(cfg, model, total_steps=20)
    step.run(_tiny_batch(cfg, 0), 0)
    state = step.optimizer.state_dict()
    for group in state["param_groups"]:
        group["capturable"] = True
    step.optimizer.load_state_dict(state)
    groups = step.optimizer.param_groups
    assert not any(g["capturable"] for g in groups)
    assert all(step.optimizer.state[p]["step"].device.type == "cpu"
               for g in groups for p in g["params"])
    assert torch.isfinite(step.run(_tiny_batch(cfg, 1), 1)).all()


# ------------------------------------------------------------- on the card


def _card_batch(cfg, seed, batch=128, text=64, caption=128):
    g = torch.Generator(device="cuda").manual_seed(seed)
    res, vocab = cfg.model.vision.image_res, cfg.model.text.vocab_size
    out = {"vision": torch.randint(0, 256, (batch, res, res, 3),
                                   dtype=torch.uint8, device="cuda",
                                   generator=g),
           "flip": torch.rand(batch, device="cuda", generator=g) < 0.5,
           "idx": torch.arange(batch, device="cuda")}
    for name, width in (("text_ids_s", text), ("text_ids_t", text),
                        ("caption_ids", caption)):
        lengths = torch.randint(8, width + 1, (batch,), device="cuda",
                                generator=g)
        mask = (torch.arange(width, device="cuda")[None]
                < lengths[:, None]).to(torch.int64)
        out[name] = torch.randint(1, vocab, (batch, width), device="cuda",
                                  generator=g) * mask
        out[name.replace("ids", "mask")] = mask
    return out


STEPS = 4


@pytest.fixture(scope="module")
def flagship_steps():
    """The flagship's step at bs128 with dropout on, run twice from the same
    weights: once free to replay graphs, once held eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return _deterministic(_run_flagship_steps)


def _run_flagship_steps():
    from leccr_torch.utils import tracing

    cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
    cfg.train.schedular.num_warmup_steps = 2  # lr 0, lr/2, then lr
    assert cfg.model.text.attention_dropout > 0 and cfg.model.dropout > 0
    models = [LECCRModel(cfg.model, device="cuda", seed=0) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    graphed, eager = (make_train_step(cfg, m, total_steps=1000)
                      for m in models)
    eager.graph_declines.append("held eager for the comparison")
    batches = [_card_batch(cfg, k) for k in range(2)]
    out = {"losses": [], "kept": [], "grads": [], "params": [],
           "launches": [], "syncs": [], "spans": []}
    for k in range(STEPS):
        row = []
        for step in (graphed, eager):
            before = launch_counts()
            tracing.reset()
            with tracing.record():
                losses = step.run(batches[k % 2], k)
            torch.cuda.synchronize()
            spans = tracing.spans()
            row.append((losses, {c: v - before.get(c, 0) for c, v in
                                 launch_counts().items()
                                 if v != before.get(c, 0)},
                        sum(s.syncs for s in spans if s.parent is None),
                        spans))
        (lg, dg, sg, spg), (le, de, se, _) = row
        out["losses"].append((lg, le))
        out["kept"].append(lg.clone())
        out["grads"].append(all(
            torch.equal(a.grad, b.grad)
            for a, b in zip(graphed.params, eager.params)))
        out["params"].append(all(
            torch.equal(a, b) for a, b in zip(graphed.params, eager.params)))
        out["launches"].append((dg, de))
        out["syncs"].append((sg, se))
        out["spans"].append(spg)
        out["graphed"], out["eager"], out["cfg"] = graphed, eager, cfg
    return out


@pytest.mark.cuda
def test_replayed_steps_equal_eager_steps_bit_for_bit(flagship_steps):
    graphed = flagship_steps["graphed"]
    assert (graphed.eager_steps, graphed.graph_captures,
            graphed.graph_replays) == (1, 1, STEPS - 1)
    assert flagship_steps["eager"].eager_steps == STEPS
    for k, (lg, le) in enumerate(flagship_steps["losses"]):
        assert torch.equal(lg, le), k
    assert flagship_steps["grads"] == [True] * STEPS
    assert flagship_steps["params"] == [True] * STEPS


@pytest.mark.cuda
def test_replays_advance_the_launch_counters(flagship_steps):
    for dg, de in flagship_steps["launches"]:
        assert dg == de
        assert (dg[("flash_tower_attention", "fwd_launches")],
                dg[("flash_tower_attention", "bwd_launches")]) == (36, 24)


@pytest.mark.cuda
def test_returned_losses_do_not_alias(flagship_steps):
    got = [lg for lg, _ in flagship_steps["losses"]]
    assert len({t.data_ptr() for t in got}) == STEPS
    for t, kept in zip(got, flagship_steps["kept"]):
        assert torch.equal(t, kept)


@pytest.mark.cuda
def test_steps_make_no_host_sync_and_replays_are_spanned(flagship_steps):
    assert flagship_steps["syncs"] == [(0, 0)] * STEPS
    phases = ["train.forward", "train.loss", "train.backward",
              "train.optimizer"]
    for k, spans in enumerate(flagship_steps["spans"]):
        names = {s.id: s.name for s in spans}
        replayed = sorted(names[s.parent] for s in spans
                          if s.name == "train.graph")
        assert replayed == ([] if k == 0 else sorted(phases)), k


@pytest.mark.cuda
def test_optimizer_state_round_trips_on_the_card(flagship_steps):
    from leccr_torch.train.checkpoints import _to_host

    graphed = flagship_steps["graphed"]
    state = _to_host(graphed.optimizer.state_dict())
    graphed.optimizer.load_state_dict(state)  # drops the graphs
    groups = graphed.optimizer.param_groups
    assert all(g["capturable"] for g in groups)
    assert all(graphed.optimizer.state[p]["step"].device.type == "cuda"
               for g in groups for p in g["params"])
    batch = _card_batch(flagship_steps["cfg"], 5)
    for k in range(STEPS, STEPS + 2):  # eager, then captured anew
        assert torch.isfinite(graphed.run(batch, k)).all()
    assert (graphed.graph_captures, graphed.graph_replays) == (2, STEPS)


@pytest.mark.cuda
def test_kernels_2_3_read_their_seed_from_its_slot():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from leccr_torch.ops.dropout import staged
    from leccr_torch.ops.flash_attention import flash_tower_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 12, 64, 64, device="cuda", generator=g,
                           dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    slot = staged(7, "cuda").slot
    results = []
    for seed in (FlashSeed(5, slot), 7, 5):
        out = flash_tower_attention(q, k, v, None, seed, 0.1)
        grads = torch.autograd.grad(out.float().sum(), (q, k, v))
        results.append((out, *grads))
    assert all(torch.equal(a, b) for a, b in zip(results[0], results[1]))
    assert not torch.equal(results[0][0], results[2][0])


def _deterministic(fn):
    """fn() under torch.use_deterministic_algorithms (an eager step alone
    differs from itself without them: the token-type embedding's gradient
    sums one row with atomics), with the span store emptied after."""
    from leccr_torch.utils import tracing

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn()
    finally:
        tracing.reset()
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _card_steps(batch=32):
    """Two flagship steps from the same weights with dropout on: one free
    to replay graphs, one held eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = load_config(str(ROOT / "configs" / "multi30k_all.yaml"))
    cfg.train.batch_size_train = batch
    models = [LECCRModel(cfg.model, device="cuda", seed=0) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    graphed, eager = (make_train_step(cfg, m, total_steps=1000)
                      for m in models)
    eager.graph_declines.append("held eager for the comparison")
    return cfg, graphed, eager


@pytest.mark.cuda
def test_two_signatures_share_the_pool_and_replay_in_turn():
    """Signatures A and B captured in that order into one pool and
    replayed A, B, A, B: a replay of A reuses blocks that B's capture took
    from A's free ones, and neither's steps move off the eager bits."""

    def steps():
        cfg, graphed, eager = _card_steps()
        batches = [_card_batch(cfg, 0, 32, 32, 128),
                   _card_batch(cfg, 1, 32, 64, 64)]
        same = []
        for k in range(6):
            lg = graphed.run(batches[k % 2], k)
            le = eager.run(batches[k % 2], k)
            same.append((torch.equal(lg, le),
                         all(torch.equal(a.grad, b.grad) for a, b in
                             zip(graphed.params, eager.params)),
                         all(torch.equal(a, b) for a, b in
                             zip(graphed.params, eager.params))))
        return graphed, same

    graphed, same = _deterministic(steps)
    assert (graphed.eager_steps, graphed.graph_captures,
            graphed.graph_replays) == (2, 2, 4)
    assert graphed.graph_skips == {}
    assert same == [(True, True, True)] * 6


@pytest.mark.cuda
def test_a_step_through_kernels_4_5_with_dropout_stays_eager():
    """Texts of 256 tokens take kernels 4/5, which take their dropout seed
    by value: the signature's first step shows it, and it is never
    captured."""
    from leccr_torch.ops.flash_attention import flash_tower_attention

    cfg, graphed, _ = _card_steps(batch=8)
    batch = _card_batch(cfg, 0, 8, 256, 128)
    before = (flash_tower_attention.chunk_fwd_launches,
              flash_tower_attention.by_value_seed_launches)
    losses = [graphed.run(batch, k) for k in range(3)]
    assert flash_tower_attention.chunk_fwd_launches > before[0]
    assert flash_tower_attention.by_value_seed_launches > before[1]
    assert (graphed.eager_steps, graphed.graph_captures,
            graphed.graph_replays) == (3, 0, 0)
    assert [why.startswith("kernels 4-8 with dropout on")
            for why in graphed.graph_skips.values()] == [True]
    assert torch.isfinite(torch.stack(losses)).all()


@pytest.mark.cuda
def test_a_signature_without_room_for_the_pool_stays_eager(monkeypatch):
    cfg, graphed, _ = _card_steps()
    total = torch.cuda.mem_get_info()[1]
    batch = _card_batch(cfg, 0, 32, 64, 128)
    graphed.run(batch, 0)
    peak = graphed._peaks[next(iter(graphed._peaks))]
    # room for less than one more eager step
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (peak - 1, total))
    losses = [graphed.run(batch, k) for k in range(1, 3)]
    assert (graphed.eager_steps, graphed.graph_captures,
            graphed.graph_replays) == (3, 0, 0)
    assert [why.endswith("the pool's growth and an eager step")
            for why in graphed.graph_skips.values()] == [True]
    assert torch.isfinite(torch.stack(losses)).all()


@pytest.mark.cuda
def test_a_capture_outlasts_a_dropped_step_in_the_collector():
    """A step whose graphs only the garbage collector can free (a cycle
    holds them), with the collector set to run at every allocation: the
    next step's capture still ends, since no collection runs inside it."""
    import gc

    cfg, first, _ = _card_steps()
    batch = _card_batch(cfg, 0, 32, 64, 128)
    for k in range(2):
        first.run(batch, k)
    assert first.graph_captures == 1
    cycle = [first]
    cycle.append(cycle)
    del first, cycle
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        cfg, second, _ = _card_steps()
        losses = [second.run(batch, k) for k in range(3)]
    finally:
        gc.set_threshold(*thresholds)
    assert (second.graph_captures, second.graph_replays) == (1, 2)
    assert torch.isfinite(torch.stack(losses)).all()
