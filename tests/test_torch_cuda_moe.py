"""The MoE text tower on the card (skipped without one): kernel 12, the
grouped GEMM (`ops.grouped_gemm`), against its plain versions at the
DeepSeek-V2-Lite cell's widths and group sizes; a two-step train step of
an MoE tower replayed as CUDA graphs, bit for bit against a twin held
eager; the routing under CUDA's sync debug mode "error".

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_moe.py
"""

import pytest
import torch

from leccr_torch.config import DeepseekConfig, tiny_test_config
from leccr_torch.ops import grouped_gemm as gg
from leccr_torch.ops.moe import route

# the cell's slots: 256 texts of 64 tokens and 128 captions of 128, 6
# choices each; ~1,700 slots an expert of the 8 held
TEXT_SLOTS = 256 * 64 * 6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _offsets(sizes, device):
    return torch.tensor([0] + list(torch.tensor(sizes).cumsum(0)),
                        dtype=torch.int32, device=device)


def _group_sizes(seed):
    """A traced step's shape of groups: ~1,700 slots each, uneven."""
    g = torch.Generator().manual_seed(seed)
    return (1700 + torch.randint(-400, 400, (8,), generator=g)).tolist()


CASES = [("step", _group_sizes(0)), ("empty_groups", [0, 900, 0, 0, 1, 63,
                                                      64, 1500]),
         ("one_group", [0, 0, 0, 3000, 0, 0, 0, 0])]


@pytest.mark.cuda
@pytest.mark.parametrize("name,sizes", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("n,k", [(1408, 2048), (2048, 1408)])
def test_grouped_gemm_matches_its_plain_versions(name, sizes, n, k):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    m = sum(sizes) + 777  # rows past the last group, as the tower has
    off = _offsets(sizes, dev)
    x = torch.randn(m, k, device=dev, generator=g).bfloat16()
    w = (torch.randn(len(sizes), n, k, device=dev, generator=g)
         * k ** -0.5).bfloat16()
    dy = torch.randn(m, n, device=dev, generator=g).bfloat16()
    end = sum(sizes)
    before = (gg.fwd_launches, gg.dx_launches, gg.dw_launches)
    y = gg.grouped_gemm(x, w, off)
    dx = gg.grouped_gemm_dx(dy, w, off)
    dw = gg.grouped_gemm_dw(dy, x, off)
    torch.cuda.synchronize()
    assert (gg.fwd_launches, gg.dx_launches, gg.dw_launches) == tuple(
        b + 1 for b in before)
    y_ref = gg.grouped_gemm_reference(x, w, off)
    dx_ref = gg.grouped_gemm_dx_reference(dy, w, off)
    dw_ref = gg.grouped_gemm_dw_reference(dy, x, off)
    # bf16 outputs of f32 sums in another order: one bf16 rounding apart
    torch.testing.assert_close(y[:end].float(), y_ref[:end].float(),
                               rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(dx[:end].float(), dx_ref[:end].float(),
                               rtol=1e-2, atol=2e-2)
    # f32 sums over up to 3,000 rows in another order
    torch.testing.assert_close(dw, dw_ref, rtol=1e-3, atol=1e-2)
    assert dw[[i for i, s in enumerate(sizes) if s == 0]].abs().sum() == 0


@pytest.mark.cuda
def test_grouped_gemm_is_the_same_bits_twice():
    dev = _card()
    sizes = _group_sizes(3)
    off = _offsets(sizes, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(sum(sizes), 2048, device=dev, generator=g).bfloat16()
    w = torch.randn(8, 1408, 2048, device=dev, generator=g).bfloat16()
    dy = torch.randn(sum(sizes), 1408, device=dev, generator=g).bfloat16()
    first = (gg.grouped_gemm(x, w, off), gg.grouped_gemm_dw(dy, x, off))
    again = (gg.grouped_gemm(x, w, off), gg.grouped_gemm_dw(dy, x, off))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_routing_makes_no_host_sync():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    scores = torch.softmax(torch.randn(4096, 64, device=dev, generator=g),
                           -1)
    valid = torch.rand(4096, device=dev, generator=g) < 0.6
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = route(scores, valid, 6, 8, 8)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    mine = ((r.experts >= 8) & (r.experts < 16) & valid[:, None])
    assert r.counts[:8].sum() == mine.sum()
    assert int(r.offsets[-1]) == int(mine.sum())


def _moe_config():
    """A small MoE tower at widths the kernel takes."""
    cfg = tiny_test_config()
    t = cfg.model.text
    t.kind, t.hidden_size, t.num_heads, t.num_layers = "deepseek_v2", 256, 2, 3
    t.intermediate_size, t.vocab_size = 512, 1000
    t.deepseek = DeepseekConfig(
        kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
        v_head_dim=32, moe_intermediate_size=128, n_routed_experts=16,
        experts_held=4, num_experts_per_tok=4, n_shared_experts=1,
        rope_scaling={"factor": 40, "original_max_position_embeddings": 4096,
                      "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                      "mscale_all_dim": 0.707})
    cfg.model.dtype = "bfloat16"
    cfg.train.batch_size_train = 16
    return cfg


def _batch(cfg, seed, dev, width=32):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, res = cfg.train.batch_size_train, cfg.model.vision.image_res
    out = {"vision": torch.randint(0, 256, (b, res, res, 3),
                                   dtype=torch.uint8, device=dev,
                                   generator=g),
           "flip": torch.rand(b, device=dev, generator=g) < 0.5,
           "idx": torch.arange(b, device=dev)}
    for name in ("text_ids_s", "text_ids_t", "caption_ids"):
        lengths = torch.randint(1, width + 1, (b,), device=dev, generator=g)
        mask = (torch.arange(width, device=dev)[None]
                < lengths[:, None]).to(torch.int64)
        out[name] = torch.randint(1, 1000, (b, width), device=dev,
                                  generator=g) * mask
        out[name.replace("ids", "mask")] = mask
    return out


@pytest.mark.cuda
def test_moe_step_replayed_as_graphs_equals_eager_bit_for_bit():
    from leccr_torch.models.leccr import LECCRModel
    from leccr_torch.train.step import make_train_step

    dev = _card()
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = _moe_config()
        models = [LECCRModel(cfg.model, device=dev, seed=0) for _ in range(2)]
        models[1].load_state_dict(models[0].state_dict())
        graphed, eager = (make_train_step(cfg, m, total_steps=100)
                          for m in models)
        eager.graph_declines.append("held eager for the comparison")
        same = []
        for k in range(3):
            batch = _batch(cfg, k, dev)
            lg, le = graphed.run(batch, k), eager.run(batch, k)
            rg = [m.routing_record["text"][0] for m in graphed.moe_layers]
            re = [m.routing_record["text"][0] for m in eager.moe_layers]
            same.append((torch.equal(lg, le),
                         all(torch.equal(a, b) for a, b in zip(rg, re)),
                         all(torch.equal(a, b) for a, b in
                             zip(graphed.params, eager.params))))
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    assert (graphed.graph_captures, graphed.graph_replays) == (1, 2)
    assert same == [(True, True, True)] * 3
