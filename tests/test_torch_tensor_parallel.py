"""Tensor parallelism in one process (`parallel/tensor.py`, the model ranks
replayed by `replay_model_ranks`), and the layout and head-offset rules it
rests on.

  - Each sharded layer equals its dense layer in f32, forward and
    backward, within f32 sum-order noise (atol 2e-6 for a layer, 1e-5 for
    a block, whose LayerNorms divide by a standard deviation): column-
    parallel, row-parallel on a column-parallel input and on a replicated
    one, `ShardedEmbed`, CLIP's residual block (the fused in_proj cut per
    head, the flash path with dropout), BERT's attention and layer (the
    flash and the plain path, dropout 0.1, whose masks are the dense
    layer's), the caption `CrossAttentionStack` and the temporal
    `SelfAttentionStack` (dropout 0.1).  Every rank draws from its own
    copy of one seed's generators, as the model ranks of a data rank do.
  - The layout: `partition_spec` of every parameter of a tiny flagship,
    the video model and an XLM-R model equals `params_shardings`' spec of
    the JAX package for the same flax path, at model 2 and 4 (an FFN of
    130 features falls back to replicated at 4, as JAX does), and the
    replayed shards of `shard_model` reassemble to the dense state bit for
    bit.
  - The flash kernels' head offset: the plain masks (`keep_mask`,
    `tile_keep_mask` at the chunked and the tiled head group) of a rank's
    heads equal the dense mask's slice bit for bit, with a head group
    across two ranks (H = 4 and 12 under `head_group`, H = 6 under
    `chunk_head_group`); `flash_tower_attention` on a rank's heads equals
    the dense call's heads in each regime, forward and backward; the
    regime of a rank's view at the layer's H is the dense view's.
  - `check_layout` raises for a model count that does not divide the
    world, and `parallel.fsdp` still raises; `--task export` runs a
    `parallel.model > 1` config dense, as the JAX package does.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from leccr_torch.config import ParallelConfig
from leccr_torch.config import tiny_test_config as port_tiny_config
from leccr_torch.models.bert import _BertLayer, _BertSelfAttention
from leccr_torch.models.clip import _ResidualBlock
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.weights import flax_paths
from leccr_torch.ops import flash_attention as fa
from leccr_torch.ops.attention import (
    CrossAttentionStack,
    Dense,
    Embed,
    SelfAttentionStack,
)
from leccr_torch.ops.dropout import Generators
from leccr_torch.parallel.mesh import check_layout, partition_spec
from leccr_torch.parallel.tensor import (
    ShardedEmbed,
    _Lockstep,
    ReplayModelGroup,
    merge_replay,
    replay_model_ranks,
    shard_dense,
    shard_model,
)
from leccr_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parent.parent
ATOL = 2e-6
BLOCK_ATOL = 1e-5


def _randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return module


def _dense_run(module, inputs, gy, fn=None):
    """(output, {param: grad}, [input grads]) of the dense module."""
    for x in inputs:
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            x.grad = None
    module.zero_grad()
    y = fn(module, *inputs) if fn else module(*inputs)
    y.backward(gy)
    return (y.detach(), {n: p.grad.clone() for n, p in
                         module.named_parameters() if p.grad is not None},
            [x.grad.clone() for x in inputs
             if isinstance(x, torch.Tensor) and x.grad is not None])


def _check_replay(module, inputs, world, atol, call=None, dense_fn=None,
                  shard=shard_model, sharded_output=False):
    """The replay of `module` over `world` ranks against the dense module:
    output, parameter gradients and input gradients."""
    y = dense_fn(module, *inputs) if dense_fn else module(*inputs)
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
    want_y, want_g, want_dx = _dense_run(module, inputs, gy, dense_fn)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            x.grad = None
    outs, shards = replay_model_ranks(module, world, inputs, call, shard)
    if sharded_output:  # each rank holds its slice of the output features
        n = want_y.shape[-1] // world
        for r, out in enumerate(outs):
            torch.testing.assert_close(out, want_y[..., r * n:(r + 1) * n],
                                       rtol=0, atol=atol)
        torch.autograd.backward(
            outs, [gy[..., r * n:(r + 1) * n] for r in range(world)])
    else:
        for out in outs:
            assert out is outs[0] or torch.equal(out, outs[0])
        torch.testing.assert_close(outs[0], want_y, rtol=0, atol=atol)
        outs[0].backward(gy)
    got = merge_replay(shards, grads=True)
    for name, g in want_g.items():
        torch.testing.assert_close(got[name], g, rtol=0, atol=atol,
                                   msg=name)
    got_dx = [x.grad for x in inputs
              if isinstance(x, torch.Tensor) and x.grad is not None]
    for g, w in zip(got_dx, want_dx):
        torch.testing.assert_close(g, w, rtol=0, atol=atol)
    return shards


# ------------------------------------------------------------- the layers

@pytest.mark.parametrize("world", [2, 4])
def test_column_and_row_parallel_dense(world):
    dense = _randomize(Dense(12, 16), 0)
    x = torch.randn(3, 5, 12, requires_grad=True)
    _check_replay(dense, (x,), world, ATOL, sharded_output=True,
                  shard=lambda m, g: shard_dense(m, g, 0))
    # row-parallel on the rank's slice of the input (a column output) ...
    dense = _randomize(Dense(16, 12), 1)
    x = torch.randn(3, 5, 16, requires_grad=True)
    _check_replay(dense, (x,), world, ATOL,
                  shard=lambda m, g: shard_dense(m, g, 1, True),
                  call=lambda s, r, x: s(x[..., s.rows]))
    # ... and on a replicated input, cut by rank
    _check_replay(dense, (x,), world, ATOL,
                  shard=lambda m, g: shard_dense(m, g, 1, False))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_embed(world):
    table = _randomize(Embed(30, 16), 2)
    ids = torch.randint(0, 30, (4, 7))
    _check_replay(table, (ids,), world, 0.0,
                  shard=lambda m, g: ShardedEmbed(m, g))


def _gens(seed):
    return Generators.from_seed(seed, "cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_clip_block_on_local_heads(world):
    """The fused in_proj cut per head in each of q, k and v, the flash
    path (deterministic=False) on each rank's heads."""
    block = _randomize(_ResidualBlock(32, 4, fused=True), 3)
    x = torch.randn(2, 9, 32, requires_grad=True)
    shards = _check_replay(block, (x, False), world, BLOCK_ATOL)
    assert shards[1].attn.head_span == (4 // world, 4 // world)
    assert shards[1].attn.in_proj.weight.shape == (3 * 32 // world, 32)


def _bert_cfg(fused):
    cfg = port_tiny_config().model.text
    cfg.hidden_size, cfg.num_heads, cfg.intermediate_size = 32, 4, 48
    cfg.fused_attention = fused
    cfg.hidden_dropout = cfg.attention_dropout = 0.1
    return cfg


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("cls", [_BertSelfAttention, _BertLayer])
def test_bert_attention_and_layer(cls, fused):
    """Dropout 0.1 everywhere: on the plain path the probabilities'
    mask is drawn whole and sliced by head, on the flash path the kernel
    hashes the absolute head; the output's dropout is replicated."""
    module = _randomize(cls(_bert_cfg(fused)), 4)
    x = torch.randn(2, 6, 32, requires_grad=True)
    mask = torch.ones(2, 6, dtype=torch.int32)
    mask[1, 4:] = 0
    world = 2
    _check_replay(
        module, (x, mask), world, BLOCK_ATOL,
        dense_fn=lambda m, x, mask: m(x, mask, False, _gens(5)),
        call=lambda s, r, x, mask: s(x, mask, False, _gens(5)))


@pytest.mark.parametrize("cls", [CrossAttentionStack, SelfAttentionStack])
def test_caption_and_temporal_stacks(cls):
    """q/k/v replicated (no pattern matches them), out_proj row-parallel
    on the replicated heads, the FFN column → row with its dropout mask
    drawn whole and sliced."""
    stack = _randomize(cls(32, 8, 2, dropout=0.1), 6)
    x = torch.randn(2, 5, 32, requires_grad=True)
    pad = torch.zeros(2, 5, dtype=torch.bool)
    pad[1, 3:] = True
    if cls is CrossAttentionStack:
        mem = torch.randn(2, 7, 32, requires_grad=True)
        mpad = torch.zeros(2, 7, dtype=torch.bool)
        mpad[0, 5:] = True
        inputs = (x, mem, mpad)
        dense_fn = lambda m, x, mem, mpad: m(x, mem, mpad, False, False,
                                              _gens(7))
        call = lambda s, r, x, mem, mpad: s(x, mem, mpad, False, False,
                                             _gens(7))
    else:
        inputs = (x, pad)
        dense_fn = lambda m, x, pad: m(x, pad, False, _gens(7))
        call = lambda s, r, x, pad: s(x, pad, False, _gens(7))
    shards = _check_replay(stack, inputs, 2, BLOCK_ATOL, call=call,
                           dense_fn=dense_fn)
    ffn = shards[1].layers[0].ffn
    assert ffn.dropout_shard == (-1, 1, 2)
    assert not shards[1].layers[0].attn.out_proj.input_sharded


# ------------------------------------------------------------- the layout

def _jax_models():
    """(name, JAX config, port config) of the three models."""
    from leccr_tpu.config import tiny_test_config as jax_tiny_config

    flagship = {"model.vision.width": 128, "model.text.intermediate_size":
                130}
    video = {"model.vision.kind": "temporal",
             "model.vision.frame_feat_dim": 64, "model.vision.num_heads": 4,
             "model.vision.num_layers": 1, "model.vision.max_frames": 4,
             "model.num_queries": 2}
    xlmr = {"model.text.kind": "xlmr", "model.text.pad_token_id": 1,
            "model.vision.width": 128}
    return [(name, jax_tiny_config(**o), port_tiny_config(**o))
            for name, o in (("flagship", flagship), ("video", video),
                            ("xlmr", xlmr))]


def _jax_shapes(model_cfg):
    """The JAX model's param shapes (jax.eval_shape: no compute)."""
    from leccr_tpu.models.leccr import LECCRModel as JaxLECCR

    b, length = 2, 8
    ids = jnp.ones((b, length), jnp.int32)
    inputs = {"text_ids_s": ids, "text_mask_s": ids, "text_ids_t": ids,
              "text_mask_t": ids, "caption_ids": ids, "caption_mask": ids}
    if model_cfg.vision.kind == "temporal":
        inputs["vision"] = jnp.zeros((b, model_cfg.vision.max_frames,
                                      model_cfg.vision.frame_feat_dim))
        inputs["vision_mask"] = jnp.ones((b, model_cfg.vision.max_frames),
                                         bool)
    else:
        res = model_cfg.vision.image_res
        inputs["vision"] = jnp.zeros((b, res, res, 3))
    model = JaxLECCR(model_cfg)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             inputs))["params"]


def _jax_dim(spec, flax_path, port_ndim):
    """A JAX PartitionSpec as the sharded dim of the port's parameter."""
    spec = tuple(spec)
    if "model" not in spec:
        return None
    dim = spec.index("model")
    if flax_path[-1] == "kernel" and port_ndim == 2:
        return 1 - dim  # the port's Dense weight is the kernel transposed
    return dim


@pytest.mark.parametrize("world", [2, 4])
def test_layout_is_the_jax_layout(world):
    from leccr_tpu.config import ParallelConfig as JaxParallel
    from leccr_tpu.parallel.mesh import make_mesh, params_shardings

    mesh = make_mesh(JaxParallel(data=1, model=world),
                     devices=jax.devices()[:world])
    for name, jcfg, pcfg in _jax_models():
        shapes = _jax_shapes(jcfg.model)
        specs = params_shardings(mesh, shapes)
        model = LECCRModel(pcfg.model, device="cpu")
        paths = flax_paths(model)
        sharded = 0
        for pname, p in model.named_parameters():
            path = paths[pname]
            node_spec, node_shape = specs, shapes
            for part in path:
                node_spec, node_shape = node_spec[part], node_shape[part]
            want = _jax_dim(node_spec.spec, path, p.dim())
            got = partition_spec(path, p.shape, world)
            assert got == want, (name, pname, got, want)
            sharded += got is not None
        assert sharded > 0
        if name == "flagship":  # 130 FFN features: sharded at 2, not at 4
            path = paths["text_encoder.layers.0.intermediate.weight"]
            assert (partition_spec(path, (130, 64), world) is None) == (
                world == 4)
        # the replayed shards reassemble to the dense state bit for bit
        lock = _Lockstep(world)
        shards = [shard_model(copy.deepcopy(model),
                              ReplayModelGroup(r, world, lock))
                  for r in range(world)]
        merged = merge_replay(shards)
        for pname, value in model.named_parameters():
            assert torch.equal(merged[pname], value), (name, pname)


# ------------------------------------------------- the kernels' head offset

@pytest.mark.parametrize("heads,world,group", [
    (4, 2, "tiled"), (12, 4, "tiled"), (6, 2, "chunked"), (8, 4, "single")])
def test_masks_of_a_rank_are_the_dense_masks_slice(heads, world, group):
    """head_group(4) = 4 and head_group(12) = 6 span two ranks;
    chunk_head_group(6) = 2 spans ranks of 3 heads."""
    b, lq, lk, rate, seed = 2, 130, 140, 0.25, 123
    local = heads // world
    hg = {"tiled": fa.head_group(heads),
          "chunked": fa.chunk_head_group(heads)}.get(group)
    if hg is not None:
        assert hg % local or local % hg or group == "chunked"
        dense = fa.tile_keep_mask(seed, b, heads, lq, lk, rate, hg=hg)
    else:
        dense = fa.keep_mask(seed, b, heads, lq, lk, rate)
    for m in range(world):
        h0 = m * local
        if hg is not None:
            got = fa.tile_keep_mask(seed, b, local, lq, lk, rate, hg=hg,
                                    h0=h0)
        else:
            got = fa.keep_mask(seed, b, local, lq, lk, rate, h0=h0)
        assert torch.equal(got, dense[:, h0:h0 + local])


@pytest.mark.parametrize("regime", ["single", "chunked", "tiled"])
def test_flash_on_a_rank_heads_is_the_dense_call(regime, monkeypatch):
    """Plain versions on the CPU, dropout 0.2, a padded key: forward and
    backward of heads [h0, h0 + 2) at H = 6 (chunked: head group 2 across
    the ranks' 3 heads; tiled: head group 6 over both ranks)."""
    if regime != "single":
        monkeypatch.setattr(fa, "fits_vmem", lambda *a: False)
    if regime == "tiled":
        monkeypatch.setattr(fa, "fits_chunked", lambda *a, **k: False)
    gen = torch.Generator().manual_seed(0)
    b, heads, length, dh = 2, 6, 40, 16
    q, k, v = (torch.randn(b, heads, length, dh, generator=gen)
               .requires_grad_() for _ in range(3))
    pad = torch.zeros(b, length, dtype=torch.bool)
    pad[1, 30:] = True
    gy = torch.randn(b, heads, length, dh, generator=gen)
    out = fa.flash_tower_attention(q, k, v, pad, 77, 0.2)
    out.backward(gy)
    dense = (out.detach(), q.grad, k.grad, v.grad)
    world = 3
    local = heads // world
    for m in range(world):
        h0 = m * local
        part = [t.detach()[:, h0:h0 + local].clone().requires_grad_()
                for t in (q, k, v)]
        out = fa.flash_tower_attention(*part, pad, 77, 0.2, h0, heads)
        out.backward(gy[:, h0:h0 + local])
        for got, want in zip((out.detach(), *(t.grad for t in part)),
                             dense):
            torch.testing.assert_close(got, want[:, h0:h0 + local],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,heads,want,alone", [
    ((32, 16, 577, 64), 4, "chunked", "chunked"),  # ViT-L/14 @336
    ((8, 16, 2705, 64), 4, "tiled", "tiled"),      # ViT-L/14 @728
    ((128, 12, 145, 64), 6, "single", "single"),   # ViT-B/32 @384
    ((256, 12, 200, 64), 6, "chunked", "single")])  # mBERT, 200 tokens
def test_regime_of_a_rank_view_is_the_dense_regime(shape, heads, want,
                                                    alone):
    """Decided on the layer's H: at its own 6 heads a rank's view of the
    200-token mBERT layer would fit one block, and take another padding
    and another mask."""
    b, h, length, dh = shape
    dense = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    local = torch.empty((b, heads, length, dh), dtype=torch.bfloat16,
                        device="meta")
    assert fa.regime(dense, dense) == want
    assert fa.regime(local, local, num_heads=h) == want
    assert fa.regime(local, local) == alone


# ---------------------------------------------------------------- layouts

def test_layouts_the_world_cannot_hold_raise():
    check_layout(ParallelConfig(data=-1, model=2), 4)
    check_layout(ParallelConfig(data=2, model=2), 4)
    with pytest.raises(ValueError, match="parallel.model: 3 must divide "
                                         "the world, 4 processes"):
        check_layout(ParallelConfig(data=-1, model=3), 4)
    with pytest.raises(ValueError, match="world / model = 4 / 2 = 2"):
        check_layout(ParallelConfig(data=4, model=2), 4)
    with pytest.raises(ValueError, match="dcn_data=4"):
        check_layout(ParallelConfig(data=-1, model=2, dcn_data=4), 4)
    # FSDP builds: over two one-process data blocks it shards the model
    cfg = port_tiny_config(**{"parallel.fsdp": True,
                              "parallel.fsdp_min_size": 1})
    model = LECCRModel(cfg.model, device="cpu")
    make_train_step(cfg, model, 10, num_blocks=2)
    assert len(model.fsdp.dims) > 10
    with pytest.raises(ValueError, match="runs over processes"):
        cfg.parallel.model = 2
        make_train_step(cfg, LECCRModel(cfg.model, device="cpu"), 10,
                        num_blocks=2)
    cfg = port_tiny_config(**{"parallel.model": 2})
    with pytest.raises(ValueError, match="runs over processes"):
        make_train_step(cfg, LECCRModel(cfg.model, device="cpu"), 10,
                        num_blocks=2)


def test_export_takes_no_model_axis(tmp_path):
    """As the JAX package's serving and export, the port's run a
    `parallel.model > 1` config dense on one device."""
    from leccr_torch.config import load_config
    from leccr_torch.run import main

    cfg = load_config(str(ROOT / "configs" / "tiny_synth.yaml"))
    cfg.parallel.model = 2
    cfg.save(str(tmp_path / "config.json"))
    main(["--task", "export", "--config", str(tmp_path / "config.json"),
          "--export_path", str(tmp_path / "ref.pth"), "--device", "cpu"])
    assert (tmp_path / "ref.pth").stat().st_size > 0
