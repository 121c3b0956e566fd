"""FSDP (`parallel.fsdp`) in one process: the layout against the JAX
package's, and the one-process step over D stacked shards.

- The layout: the spec the port gives every parameter (`fsdp_spec` on its
  flax leaf) equals `params_shardings(mesh, params, fsdp=True,
  fsdp_min_size=…)`'s, spec for spec, for the tiny flagship, video and
  XLM-R models at data 2 and 4 × model 1 and 2, at the default floor and
  at 1; so does the port tensor's dim that `shard_fsdp` cuts, on the
  dense model and on a model sharded over the model axis; and the specs
  of tests/test_fsdp.py:29's leaves, the production word embeddings
  (which stay replicated when the data count does not divide the
  vocabulary), a square kernel (cut on its input features) and the patch
  kernel.
- `TrainStep(num_blocks=2)` under FSDP (`LocalDataGroup`: both ranks'
  shards stacked) equals the step without it bit for bit, in four cases:
  plain, remat, GradCache 2, and `ring_fused` with streaming losses; the
  parameters over the floor hold [2, *shard] and so do their Adam moments
  and the EMA; a shard's optimizer group is its dense parameter's.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from leccr_torch.config import tiny_test_config as port_tiny_config
from leccr_torch.models.leccr import LECCRModel
from leccr_torch.models.weights import flax_paths
from leccr_torch.parallel.fsdp import (
    FSDP_MIN_SIZE,
    LocalDataGroup,
    _flax_view,
    fsdp_layout,
    fsdp_params,
    fsdp_spec,
    model_spec,
    shard_fsdp,
)
from leccr_torch.parallel.tensor import (
    ReplayModelGroup,
    _Lockstep,
    gather_state,
    shard_model,
)
from leccr_torch.train.step import make_train_step
from test_torch_tensor_parallel import _jax_models, _jax_shapes
from test_torch_train import _batch, _torch_batch

FLOORS = [FSDP_MIN_SIZE, 1]


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _jax_specs(shapes, data, model, floor):
    from leccr_tpu.config import ParallelConfig as JaxParallel
    from leccr_tpu.parallel.mesh import make_mesh, params_shardings

    mesh = make_mesh(JaxParallel(data=data, model=model),
                     devices=jax.devices()[:data * model])
    return params_shardings(mesh, shapes, fsdp=True, fsdp_min_size=floor)


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return tree


@pytest.mark.parametrize("floor", FLOORS)
@pytest.mark.parametrize("data,model", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_layout_is_the_jax_layout(data, model, floor):
    for name, jcfg, pcfg in _jax_models():
        shapes = _jax_shapes(jcfg.model)
        specs = _jax_specs(shapes, data, model, floor)
        dense = LECCRModel(pcfg.model, device="cpu")
        paths = flax_paths(dense)
        patch = getattr(dense.vision_tower, "patch_size", 1)
        layout = fsdp_layout(dense, data, floor, model)
        cut = 0
        for pname, p in dense.named_parameters():
            path = paths[pname]
            want = _leaf(specs, path).spec
            shape, to_port = _flax_view(pname, path, p.shape, patch)
            assert shape == tuple(_leaf(shapes, path).shape), pname
            got = fsdp_spec(shape, model_spec(path, shape, model), data,
                            floor)
            assert _padded(got, len(shape)) == _padded(want, len(shape)), (
                name, pname, got, want)
            port_dim = (to_port(tuple(want).index("data"))
                        if "data" in tuple(want) else None)
            assert layout[pname] == port_dim, (name, pname)
            cut += port_dim is not None
        assert cut > 0 if floor == 1 else True
        if model > 1:  # on the ranks' slices the same dims are cut
            sharded = shard_model(copy.deepcopy(dense),
                                  ReplayModelGroup(1, model,
                                                   _Lockstep(model)))
            assert fsdp_layout(sharded, data, floor, model) == layout, name


LEAVES = {
    "enc": {"c_fc": {"kernel": (256, 1024), "bias": (1024,)},
            "out": {"kernel": (1024, 256)}},
    "embeddings": {"embedding": (4096, 64)},
    "odd": {"kernel": (514, 1026)},
    "word_embeddings": {"embedding": (119547, 768)},
    "xlmr_words": {"embedding": (250002, 1024)},
    "square": {"kernel": (768, 768)},
    "conv1": {"kernel": (32, 32, 3, 768)},
}


@pytest.mark.parametrize("data,model", [(4, 2), (4, 1), (2, 1), (2, 2)])
def test_leaf_specs_are_the_jax_specs(data, model):
    """tests/test_fsdp.py:29's leaves and the production trouble spots."""
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                          LEAVES, is_leaf=lambda x: isinstance(x, tuple))
    specs = _jax_specs(shapes, data, model, FSDP_MIN_SIZE)
    flat = jax.tree_util.tree_flatten_with_path(
        LEAVES, is_leaf=lambda x: isinstance(x, tuple))[0]
    for kp, shape in flat:
        path = tuple(k.key for k in kp)
        got = fsdp_spec(shape, model_spec(path, shape, model), data)
        want = _leaf(specs, path).spec
        assert _padded(got, len(shape)) == _padded(want, len(shape)), (
            path, got, want)
    # the vocabularies stay replicated over data unless data divides them
    assert fsdp_spec((119547, 768), (None, "model"), 4) == (None, "model")
    assert fsdp_spec((250002, 1024), (None, "model"), 2) == ("data", "model")
    # a square kernel is cut on its input features: the port's dim 1
    shape, to_port = _flax_view("square.weight", ("square", "kernel"),
                                (768, 768), 32)
    assert to_port(fsdp_spec(shape, (), 4).index("data")) == 1
    # the patch kernel on its output features: the port's dim 0
    shape, to_port = _flax_view("vision_tower.conv1.weight",
                                ("vision_tower", "conv1", "kernel"),
                                (768, 32 * 32 * 3), 32)
    assert shape == (32, 32, 3, 768)
    assert to_port(3) == 0 and to_port(0) == 1


STEP_CASES = {"plain": {}, "remat": {"model.remat": True},
              "grad_cache": {"train.grad_cache_microbatches": 2},
              "ring_fused": {"parallel.negatives": "ring_fused",
                             "parallel.stream_loss_block_rows": 2}}


def _steps(options, fsdp, steps=2):
    cfg = port_tiny_config(**{"parallel.fsdp": fsdp,
                              "parallel.fsdp_min_size": 1,
                              "train.ema_decay": 0.9, **options})
    model = LECCRModel(cfg.model, device="cpu", seed=3)
    step = make_train_step(cfg, model, total_steps=10, num_blocks=2)
    losses = [step(_torch_batch(_batch(cfg, seed=i)), i)
              for i in range(steps)]
    return losses, model, step


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_process_step_equals_the_step_without_fsdp(case):
    want_losses, dense, dense_step = _steps(STEP_CASES[case], False)
    losses, model, step = _steps(STEP_CASES[case], True)
    assert losses == want_losses
    assert len(fsdp_params(model)) > 10
    state = gather_state(model)
    for name, value in dense.state_dict().items():
        assert torch.equal(state[name], value), name
    # moments and EMA per shard, equal to the dense ones gathered
    names = {id(p): n for n, p in model.named_parameters()}
    dense_params = dict(dense.named_parameters())
    dims = model.fsdp.dims
    for p, st in step.optimizer.state.items():
        name = names[id(p)]
        want = dense_step.optimizer.state[dense_params[name]]
        for key, value in st.items():
            if key == "step":
                continue
            assert value.shape == p.shape, name
            if name in dims:
                assert p.shape[0] == 2
                value = torch.cat(value.unbind(0), dims[name])
            assert torch.equal(value, want[key]), (name, key)
    for p, ema, want in zip(step.params, step.ema, dense_step.ema):
        assert ema.shape == p.shape
        name = names[id(p)]
        if name in dims:
            ema = torch.cat(ema.unbind(0), dims[name])
        assert torch.equal(ema, want), name


def test_a_shard_keeps_its_parameter_group():
    cfg = port_tiny_config(**{"parallel.fsdp": True,
                              "parallel.fsdp_min_size": 1,
                              "train.optimizer.lr_mult_paths":
                                  ["crossattn", "queries"]})

    def groups(model, num_blocks):
        step = make_train_step(cfg, model, total_steps=10,
                               num_blocks=num_blocks)
        names = {id(p): n for n, p in model.named_parameters()}
        return {names[id(p)]: g["label"]
                for g in step.optimizer.param_groups for p in g["params"]}

    dense = groups(LECCRModel(cfg.model, device="cpu"), 1)
    model = LECCRModel(cfg.model, device="cpu")
    sharded = groups(model, 4)
    assert sharded == dense
    assert {g for g in dense.values()} >= {"base_decay", "base_no_decay",
                                           "mult_decay"}
    assert len(model.fsdp.dims) > 10
    # one data rank shards nothing, as in the JAX package
    model = LECCRModel(cfg.model, device="cpu")
    assert shard_fsdp(model, LocalDataGroup(1)) is model
    assert getattr(model, "fsdp", None) is None
