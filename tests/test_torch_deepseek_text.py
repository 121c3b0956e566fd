"""The DeepSeek-V2 text tower (`text.kind: deepseek_v2`, `models.deepseek`)
and its MoE routing (`ops.moe`, `ops.grouped_gemm`) against the plain
reference `tests/reference_deepseek_v2.py`, at a tiny width on the CPU:
hidden 64, 2 heads, latent 16, nope / rope / v 16 / 8 / 16, 8 experts of
which 4 held, top-2, one shared expert, a dense layer and 2 MoE layers.

The port has no JAX counterpart here (the JAX package has no such tower):
the reference is written from the published equations.  f32 on both
sides; sums in another order than the reference's loops, so 1e-5.
"""

import copy
from pathlib import Path

import pytest
import torch

import reference_deepseek_v2 as ref
from leccr_torch.config import (
    DeepseekConfig,
    LECCRConfig,
    TextConfig,
    load_config,
    tiny_test_config,
)
from leccr_torch.models.leccr import LECCRModel, MoETrainEmbeddings
from leccr_torch.ops import grouped_gemm as gg
from leccr_torch.ops.dropout import Generators
from leccr_torch.ops.moe import balance_loss, route
from leccr_torch.train.optim import classify_params
from leccr_torch.train.step import check_parallel, make_train_step

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
WIDTHS = dict(kind="deepseek_v2", vocab_size=512, hidden_size=64,
              num_heads=2, num_layers=3, intermediate_size=96,
              hidden_dropout=0.0, attention_dropout=0.0)
DEEPSEEK = dict(kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16, moe_intermediate_size=32, n_routed_experts=8,
                experts_held=4, num_experts_per_tok=2, n_shared_experts=1,
                first_k_dense_replace=1,
                rope_scaling={"factor": 40,
                              "original_max_position_embeddings": 4096,
                              "beta_fast": 32, "beta_slow": 1,
                              "mscale": 0.707, "mscale_all_dim": 0.707})


def _config(**deepseek):
    cfg = tiny_test_config()
    for k, v in WIDTHS.items():
        setattr(cfg.model.text, k, v)
    cfg.model.text.deepseek = DeepseekConfig(**{**DEEPSEEK, **deepseek})
    return cfg


def _widths(cfg):
    t = cfg.model.text
    return {"num_heads": t.num_heads, "num_layers": t.num_layers,
            **{k: getattr(t.deepseek, k) for k in (
                "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                "v_head_dim", "num_experts_per_tok", "first_k_dense_replace",
                "rms_norm_eps", "rope_theta", "rope_scaling",
                "aux_loss_alpha")}}


def _texts(seed, b=6, length=12, vocab=512):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, length + 1, (b,), generator=g)
    lens[0] = length
    mask = (torch.arange(length)[None] < lens[:, None]).to(torch.int64)
    return torch.randint(1, vocab, (b, length), generator=g) * mask, mask


def _tower_params(model):
    return {n[len("text_encoder."):]: p.detach()
            for n, p in model.named_parameters()
            if n.startswith("text_encoder.")}


@pytest.fixture(scope="module")
def model():
    cfg = _config()
    m = LECCRModel(cfg.model, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():  # no zero query slots, RMSNorm scales off 1
        for n, p in m.named_parameters():
            if n.endswith("layernorm.weight") or n.endswith("norm.weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return cfg, m


def test_embed_texts_matches_the_reference(model):
    cfg, m = model
    ids, mask = _texts(0)
    got = m.embed_texts(ids, mask)
    hidden, _, _ = ref.tower(_tower_params(m), _widths(cfg), ids, mask,
                             held=4)
    pooled = ref.last_token(hidden, mask) @ m.text_proj.weight.T \
        + m.text_proj.bias
    want = pooled / pooled.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(got, want, **TOL)


def test_training_text_call_losses_and_gradients(model):
    """The text call as a training forward takes it: hidden state, balance
    loss and the gradients of a loss of both, every tower leaf."""
    cfg, m = model
    ids, mask = _texts(1)
    for p in m.parameters():
        p.grad = None
    hidden, balance = m._encode_text(ids, mask, balance=True)
    feat = m.text_features(hidden, mask)
    (feat.square().sum() * 0.5 + 100 * balance).backward()
    got = {n: p.grad.clone() for n, p in m.text_encoder.named_parameters()}
    P = {n: p.clone().requires_grad_(True)
         for n, p in _tower_params(m).items()}
    w = m.text_proj.weight.detach()
    b = m.text_proj.bias.detach()
    r_hidden, r_balance, _ = ref.tower(P, _widths(cfg), ids, mask, held=4)
    pooled = ref.last_token(r_hidden, mask) @ w.T + b
    r_feat = pooled / pooled.norm(dim=-1, keepdim=True)
    (r_feat.square().sum() * 0.5 + 100 * r_balance).backward()
    torch.testing.assert_close(balance, r_balance.detach(), **TOL)
    torch.testing.assert_close(hidden, r_hidden.detach(), **TOL)
    assert set(got) == set(P)
    for n, p in P.items():
        torch.testing.assert_close(got[n], p.grad, rtol=1e-4, atol=1e-6,
                                   msg=n)
    assert got["layers.1.mlp.experts.gate_proj"].abs().sum() > 0


def test_a_training_forward_adds_the_balance_loss_to_total(model):
    cfg, m = model
    step = make_train_step(cfg, copy.deepcopy(m), total_steps=10)
    g = torch.Generator().manual_seed(5)
    b = cfg.train.batch_size_train
    batch = {"vision": torch.randint(0, 256, (b, 64, 64, 3),
                                     dtype=torch.uint8, generator=g),
             "idx": torch.arange(b)}
    for key in ("text_ids_s", "text_ids_t", "caption_ids"):
        ids, mask = _texts(int(torch.randint(0, 99, (), generator=g)), b=b)
        batch[key], batch[key.replace("ids", "mask")] = ids, mask
    emb = step.model(dict(batch, vision=batch["vision"].float() / 255),
                     Generators.from_seed(0, "cpu"))
    assert isinstance(emb, MoETrainEmbeddings)
    value, losses = step.objective(emb, batch["idx"])
    assert float(losses["loss_balance"].detach()) > 0
    terms = ("loss_itc_vs", "loss_itc_vt", "loss_itc_st", "loss_itc_c",
             "loss_reg_c")
    others = sum(float(losses[k].detach()) for k in terms)
    total = float(losses["total"].detach())
    assert total == pytest.approx(
        others + float(losses["loss_balance"].detach()), rel=1e-6)
    assert float(value.detach()) == pytest.approx(total, rel=1e-6)
    out = step.run(batch, 0)
    assert out.shape == (10,) and torch.isfinite(out).all()


def test_two_held_shares_and_the_shared_expert_make_the_whole_layer():
    """Experts 0-3 and 4-7 on two 'cards', the shared expert counted once,
    add up to the uncut 8-expert layer (port and reference)."""
    whole = LECCRModel(_config(experts_held=0).model, device="cpu", seed=7)
    shares = [LECCRModel(_config(experts_held=4, expert_offset=o).model,
                         device="cpu", seed=7) for o in (0, 4)]
    layer = whole.text_encoder.layers[1].mlp
    for share, o in zip(shares, (0, 4)):
        sd = whole.state_dict()
        for n in ("gate_proj", "up_proj", "down_proj"):
            key = f"text_encoder.layers.1.mlp.experts.{n}"
            sd[key] = sd[key][o:o + 4]
        sd = {k: v for k, v in sd.items() if ".layers.2.mlp.experts." not in k}
        share.load_state_dict(sd, strict=False)
    g = torch.Generator().manual_seed(8)
    x = torch.randn(3, 10, 64, generator=g)
    valid = torch.ones(3, 10, dtype=torch.bool)
    valid[1, 6:] = False
    y_whole, _ = layer(x, valid, "text", False)
    parts = [s.text_encoder.layers[1].mlp(x, valid, "text", False)[0]
             for s in shares]
    shared = layer.shared_experts(x)
    torch.testing.assert_close(parts[0] + parts[1] - shared, y_whole, **TOL)
    P = {k[len("text_encoder.layers.1."):]: v
         for k, v in whole.state_dict().items()
         if k.startswith("text_encoder.layers.1.mlp.")}
    c = _widths(_config())
    r_parts = [ref.routed({k: v[o:o + 4] if ".experts." in k else v
                           for k, v in P.items()}, "mlp", x, valid, c, 4,
                          o)[0] for o in (0, 4)]
    r_whole = ref.routed(P, "mlp", x, valid, c, 8, 0)[0]
    torch.testing.assert_close(r_parts[0] + r_parts[1], r_whole, **TOL)
    torch.testing.assert_close(y_whole, r_whole + shared, **TOL)


def test_padding_routes_to_no_expert_and_reaches_no_valid_output(model):
    cfg, m = model
    ids, mask = _texts(2)
    assert int(mask[3].sum()) < ids.shape[1]
    hidden = m.encode_text(ids, mask)
    layers = [layer.mlp for layer in m.text_encoder.layers[1:]]
    for mlp in layers:
        choices, counts = mlp.routing_record["text"][:2]
        assert (choices[~mask.bool()] == -1).all()
        assert (choices[mask.bool()] >= 0).all()
        held = ((choices >= 0) & (choices < 4)).sum()
        assert int(counts[:4].sum()) == int(held)
    changed = ids.clone()
    changed[3, int(mask[3].sum()):] = 7
    again = m.encode_text(changed, mask)
    keep = mask.bool()
    assert torch.equal(hidden[keep], again[keep])
    assert torch.equal(m.embed_texts(ids, mask), m.embed_texts(changed, mask))


def _offsets(sizes):
    return torch.tensor([0] + list(torch.tensor(sizes).cumsum(0)),
                        dtype=torch.int32)


@pytest.mark.parametrize("sizes", [[3, 0, 5, 1], [0, 0, 9, 0], [0, 0, 0, 0]],
                         ids=["ragged", "one_group", "empty"])
def test_grouped_gemm_plain_versions_against_a_loop_of_experts(sizes):
    g = torch.Generator().manual_seed(len(sizes) + sum(sizes))
    m, n, k = sum(sizes) + 3, 6, 5
    x = torch.randn(m, k, generator=g, requires_grad=True)
    w = torch.randn(len(sizes), n, k, generator=g, requires_grad=True)
    off = _offsets(sizes)
    y = gg.grouped_gemm(x, w, off)
    loop = torch.zeros(m, n)
    bounds = off.tolist()
    for e in range(len(sizes)):
        rows = slice(bounds[e], bounds[e + 1])
        loop[rows] = x[rows] @ w[e].T
    torch.testing.assert_close(y, loop.detach(), **TOL)
    assert y[bounds[-1]:].abs().sum() == 0
    dy = torch.randn(m, n, generator=g)
    dy[bounds[-1]:] = 0
    loop.backward(dy)
    torch.testing.assert_close(gg.grouped_gemm_dx(dy, w.detach(), off)
                               [:bounds[-1]], x.grad[:bounds[-1]], **TOL)
    dw = gg.grouped_gemm_dw(dy, x.detach(), off)
    torch.testing.assert_close(dw, w.grad, **TOL)
    assert dw.dtype == torch.float32


def test_balance_loss_and_routing_against_the_reference():
    g = torch.Generator().manual_seed(9)
    scores = torch.softmax(torch.randn(3, 7, 8, generator=g), -1)
    valid = torch.ones(3, 7, dtype=torch.bool)
    valid[0, 4:] = False
    valid[2, 1:] = False
    top = torch.topk(scores, 2, -1).indices
    torch.testing.assert_close(balance_loss(scores, top, valid),
                               ref.balance_loss(scores, top, valid), **TOL)
    r = route(scores.view(-1, 8), valid.view(-1), 2, 4, 2)
    mine = (top >= 2) & (top < 6) & valid[..., None]
    assert r.counts.tolist()[:4] == [int(((top == e + 2) & mine).sum())
                                     for e in range(4)]
    assert int(r.offsets[-1]) == int(mine.sum())
    keys = torch.where(r.held, r.experts - 2, 4).flatten()[r.order]
    assert torch.equal(keys, keys.sort().values)
    assert torch.equal(r.order[r.inv], torch.arange(r.order.numel()))


def test_flax_paths_and_optimizer_groups_of_the_new_leaves(model):
    _, m = model
    labels = classify_params(m)
    names = [n for n in labels if n.startswith("text_encoder.")]
    for n in names:
        norm = (n.endswith("layernorm.weight")
                or n == "text_encoder.norm.weight")
        assert labels[n] == ("base_no_decay" if norm else "base_decay"), n
    assert labels["text_encoder.layers.1.mlp.experts.down_proj"] == \
        "base_decay"
    assert labels["text_encoder.layers.1.mlp.gate.weight"] == "base_decay"


def test_out_of_scope_layouts_and_towers_raise():
    cfg = _config()
    cfg.parallel.model = 2
    with pytest.raises(ValueError, match="deepseek_v2"):
        check_parallel(cfg, 2)
    cfg = _config()
    cfg.parallel.fsdp = True
    with pytest.raises(ValueError, match="deepseek_v2"):
        check_parallel(cfg, 1)
    cfg = _config()
    cfg.model.text.kind = "gpt2"
    with pytest.raises(ValueError, match="deepseek_v2"):
        LECCRModel(cfg.model, device="meta")


def test_grad_cache_takes_the_balance_loss_as_the_microbatches_mean(model):
    """GradCache over 2 microbatches (no dropout anywhere) gives the one
    pass's losses and gradients: the balance loss is a mean over the
    sequences, so the microbatches' mean."""
    cfg, m = model
    cfg = copy.deepcopy(cfg)
    cfg.model.dropout = 0.0
    g = torch.Generator().manual_seed(11)
    b = cfg.train.batch_size_train
    batch = {"vision": torch.randint(0, 256, (b, 64, 64, 3),
                                     dtype=torch.uint8, generator=g),
             "idx": torch.arange(b)}
    for key in ("text_ids_s", "text_ids_t", "caption_ids"):
        ids, mask = _texts(int(torch.randint(0, 99, (), generator=g)), b=b)
        batch[key], batch[key.replace("ids", "mask")] = ids, mask
    out = []
    for micro in (0, 2):
        cfg.train.grad_cache_microbatches = micro
        model_copy = copy.deepcopy(m)
        model_copy.cfg.dropout = 0.0
        for mod in model_copy.modules():
            if hasattr(mod, "dropout") and isinstance(mod.dropout, float):
                mod.dropout = 0.0
        step = make_train_step(cfg, model_copy, total_steps=10)
        step.optimizer.step = lambda *a, **k: None  # keep the gradients
        losses = step(batch, 0)
        out.append((losses, {n: p.grad.clone()
                             for n, p in model_copy.named_parameters()}))
    (whole, g1), (cached, g2) = out
    assert cached == pytest.approx(whole, rel=1e-5)
    for n in g1:  # f32 sums in another order: to the leaf's largest
        torch.testing.assert_close(
            g2[n], g1[n], rtol=0, atol=1e-5 * float(g1[n].abs().max()) + 1e-6)


def test_the_config_keeps_the_deepseek_block_only_where_set():
    """`text.deepseek` loads from and saves to its own block; a config of
    another tower saves none, whatever fields the block gains."""
    cfg = load_config(str(ROOT / "configs" / "dsv2lite_text.yaml"))
    d = cfg.model.text.deepseek
    assert (d.experts_held, d.n_routed_experts, d.kv_lora_rank) == (8, 64,
                                                                    512)
    data = cfg.to_dict()
    assert data["model"]["text"]["deepseek"]["rope_scaling"]["factor"] == 40
    assert LECCRConfig.from_dict(data).to_dict() == data
    assert "deepseek" not in tiny_test_config().to_dict()["model"]["text"]
    assert TextConfig(kind="deepseek_v2").deepseek == DeepseekConfig()
