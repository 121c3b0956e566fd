"""Fully-sharded data parallelism, `parallel.fsdp` (ZeRO-3): the port of the
JAX package's FSDP layout (leccr_tpu/parallel/mesh.py:127-164).

**The layout** is JAX's, decided on each parameter's flax leaf (its global
shape and its dim order, `models.weights.flax_paths`), not on the port's
tensor: a leaf of at least `parallel.fsdp_min_size` elements (the global
leaf's, the dim the model axis cuts counted whole) has its largest free dim
split over the `data` ranks, where the data count divides it.  "Free": not
the dim `param_partition_spec` gives the model axis, at any model count
(1 included, where JAX's spec names "model" all the same).  Ties go to the
flax dim that comes first (a stable sort), so a square Dense kernel is cut
on its input features: the port's weight is the kernel transposed, and
that is its dim 1.  A word embedding whose vocabulary the data count does
not divide stays replicated (its hidden dim is the model axis's).  A shard
is the contiguous block of that dim in data-rank order, as a JAX
`NamedSharding` places it; on a model-sharded parameter it is the block of
the rank's model slice.

**Gather at use.**  Each rank keeps only its shard as the `nn.Parameter`,
under the parameter's own name (state_dict keys, `flax_paths` and the
optimizer's groups are the dense model's).  The module that owns it gets a
subclass whose attribute of that name is a property: every read
all-gathers the whole weight over the data group (`_Gather`), so the
forward, remat's recompute (`ops.dropout.checkpoint_block`) and both of
GradCache's forwards each gather again, and the gathered weight is freed
once nothing holds it.  The backward reduce-scatters the gradient: the
shard's `.grad` is its slice of the sum over the data ranks, the port's
rule for data-parallel gradients.  Reading such an attribute is a
collective: code outside the forward reads the shard as
`module._parameters[name]`.

**The groups.**  `ProcessDataGroup`: the data group of a `DataMesh`
(`dist.all_gather_into_tensor` / `dist.reduce_scatter_tensor`; NCCL on the
card, gloo on the CPU).  `LocalDataGroup`: D data ranks' shards in one
process, stacked as one parameter [D, *shard] (the rank-r shard is
[r]); its gather concatenates the D shards in rank order and its
reduce-scatter gives each shard its slice of the one gradient, so a
one-process `TrainStep(num_blocks=D)` under FSDP is the step without it
bit for bit (the gathered weight is the same tensor, AdamW is
elementwise).

    shard_fsdp(model, group, min_size)   # in place, after shard_model
    model.fsdp.gather_tensors(...)       # the TP-local dense tensors
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from leccr_torch.models.weights import flax_paths
from leccr_torch.parallel.mesh import flax_spec
from leccr_torch.parallel.tensor import _layouts

# the JAX package's default floor (leccr_tpu/parallel/mesh.py:127)
FSDP_MIN_SIZE = 1 << 16


# ------------------------------------------------------------ the layout

def model_spec(flax_path: Sequence[str], global_shape: Sequence[int],
               model: int) -> Tuple[Optional[str], ...]:
    """`param_partition_spec` of a flax leaf with `params_shardings`'
    divisibility rule: () when `model` does not divide the named dim."""
    spec = flax_spec(flax_path, global_shape)
    for size, axis in zip(global_shape, spec):
        if axis == "model" and size % model:
            return ()
    return spec


def fsdp_spec(global_shape: Sequence[int],
              model_spec: Sequence[Optional[str]], data: int,
              min_size: int = FSDP_MIN_SIZE) -> Tuple[Optional[str], ...]:
    """`params_shardings(fsdp=True)`'s spec of a flax leaf of
    `global_shape`: its `model_spec` (`model_spec()`) with "data" on the
    largest free dim that `data` divides, when the leaf has at least
    `min_size` elements."""
    spec = tuple(model_spec)
    if data <= 1 or math.prod(global_shape) < min_size:
        return spec
    dims = list(spec) + [None] * (len(global_shape) - len(spec))
    for d in sorted(range(len(global_shape)), key=lambda d: -global_shape[d]):
        if dims[d] is None and global_shape[d] % data == 0:
            dims[d] = "data"
            return tuple(dims)
    return spec


def _flax_view(name: str, flax_path: Sequence[str],
               port_shape: Sequence[int], patch: int):
    """(the flax leaf's shape, flax dim -> the port parameter's dim) of a
    port parameter at `port_shape`: a Dense weight is the kernel
    transposed; the patch conv's weight [out, kh·kw·in] is the kernel
    [kh, kw, in, out] flattened (kh outermost)."""
    if flax_path[-1] != "kernel":
        return tuple(port_shape), lambda d: d
    if name == "vision_tower.conv1.weight":
        out, flat = port_shape
        shape = (patch, patch, flat // (patch * patch), out)

        def conv_dim(d):
            if d == 3:
                return 0
            if d == 0:  # kh blocks are contiguous in the flattened dim
                return 1
            raise NotImplementedError(
                f"FSDP on dim {d} of the patch kernel {shape}")
        return shape, conv_dim
    return tuple(port_shape)[::-1], lambda d: len(port_shape) - 1 - d


def fsdp_layout(model: nn.Module, data: int, min_size: int = FSDP_MIN_SIZE,
                model_world: int = 1) -> Dict[str, Optional[int]]:
    """Each parameter name of a port model (dense, or sharded over
    `model_world` model ranks by `parallel.tensor.shard_model`) -> the dim
    of its port tensor split over `data` ranks, or None (replicated)."""
    paths = flax_paths(model)
    dense = {n: shape for n, (_, _, shape) in _layouts(model).items()}
    tower = getattr(model, "vision_tower", None)
    patch = getattr(tower, "patch_size", 1)
    out = {}
    for name, p in model.named_parameters():
        port_shape = dense.get(name, tuple(p.shape))
        shape, to_port = _flax_view(name, paths[name], port_shape, patch)
        spec = fsdp_spec(shape, model_spec(paths[name], shape, model_world),
                         data, min_size)
        out[name] = to_port(spec.index("data")) if "data" in spec else None
    return out


# ------------------------------------------------------------ the groups

class ProcessDataGroup:
    """The data group of a process: `world` data ranks, this one `rank`;
    `group` None is the default group."""

    local = False

    def __init__(self, rank: int, world: int,
                 group: Optional[dist.ProcessGroup] = None):
        self.rank, self.world, self.group = rank, world, group

    def cut(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous block of `full` on `dim` (a copy)."""
        n = full.shape[dim] // self.world
        return full.narrow(dim, self.rank * n, n).clone(
            memory_format=torch.contiguous_format)

    def _stacked(self, x: torch.Tensor) -> torch.Tensor:
        """[world, *x.shape]: the data ranks' x (flat buffers, as gloo's
        and NCCL's all-gather both take them)."""
        out = x.new_empty(self.world * x.numel())
        dist.all_gather_into_tensor(out, x.contiguous().view(-1),
                                    group=self.group)
        return out.view(self.world, *x.shape)

    def all_gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The data ranks' shards concatenated on `dim` in rank order."""
        full = list(shard.shape)
        full[dim] *= self.world
        return self._stacked(shard).movedim(0, dim).reshape(full)

    def reduce_scatter(self, grad: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block on `dim` of the sum over the data ranks of
        `grad`."""
        n = grad.shape[dim] // self.world
        parts = grad.unflatten(dim, (self.world, n)).movedim(dim, 0)
        out = grad.new_empty(parts.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1),
                                   parts.contiguous().view(-1),
                                   group=self.group)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the data ranks of x, in rank order (no gradient)."""
        parts = self._stacked(x)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc


class LocalDataGroup:
    """`world` data ranks' shards held by one process, stacked: a local
    tensor is [world, *shard], rank r's shard its [r]."""

    local = True

    def __init__(self, world: int):
        self.world = world

    def cut(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.stack(full.chunk(self.world, dim))

    def all_gather(self, shards: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(shards.unbind(0), dim)

    def reduce_scatter(self, grad: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.stack(grad.chunk(self.world, dim))




class _Gather(torch.autograd.Function):
    """The whole weight from the data ranks' shards; the backward is the
    shard's slice of the gradient summed over the ranks."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(shard, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad.contiguous(), ctx.dim), None, None


def _gathered(name: str):
    def get(self):
        return _Gather.apply(self._parameters[name], self._fsdp_group,
                             self._fsdp_dims[name])
    return property(get, doc=f"`{name}` gathered over the data ranks")


_CLASSES: Dict[tuple, type] = {}


def _gathering_class(cls: type, names: Tuple[str, ...]) -> type:
    """cls with a gathering property for each of `names`."""
    key = (cls, names)
    if key not in _CLASSES:
        _CLASSES[key] = type(cls.__name__, (cls,),
                             {n: _gathered(n) for n in names})
    return _CLASSES[key]


# ------------------------------------------------------------ the model

@dataclasses.dataclass
class FsdpState:
    """A model's FSDP: its data group and each sharded parameter's name ->
    its split dim (`model.fsdp`)."""

    group: object
    dims: Dict[str, int]
    min_size: int

    def gather_tensors(self, tensors: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """{name: a tensor shaped as the shard} -> the tensors whole (a
        collective over the data group for a process group); other names
        as they are."""
        with torch.no_grad():
            return {n: (self.group.all_gather(t.detach(), self.dims[n])
                        if n in self.dims else t)
                    for n, t in tensors.items()}

    def shard_tensors(self, tensors: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The inverse of `gather_tensors` (no collective)."""
        with torch.no_grad():
            return {n: (self.group.cut(t.detach(), self.dims[n])
                        if n in self.dims else t)
                    for n, t in tensors.items()}


def shard_fsdp(model: nn.Module, group, min_size: int = FSDP_MIN_SIZE
               ) -> nn.Module:
    """Shard `model` in place over `group`'s data ranks by the JAX layout
    (`fsdp_layout`; a model sharded over a model group by `shard_model`
    first is cut on its ranks' slices): each parameter so laid out is
    replaced by the rank's shard (all the ranks' shards, stacked, for a
    `LocalDataGroup`) and gathered at use.  A group of one rank leaves the
    model as it is.  Returns the model; `model.fsdp` is its `FsdpState`."""
    if group.world == 1:
        return model
    if getattr(model, "fsdp", None) is not None:
        raise ValueError("the model is FSDP-sharded already")
    names = [n for n, _ in model.named_parameters(remove_duplicate=False)]
    if len(names) != len(set(id(p) for p in model.parameters())):
        raise NotImplementedError("FSDP of a model with shared parameters")
    tp = getattr(model, "tp_group", None)
    dims = {n: d for n, d in fsdp_layout(
        model, group.world, min_size, 1 if tp is None else tp.world).items()
        if d is not None}
    owners: Dict[nn.Module, Dict[str, int]] = {}
    for name, dim in dims.items():
        prefix, _, leaf = name.rpartition(".")
        module = model.get_submodule(prefix)
        old = module._parameters[leaf]
        if old.shape[dim] % group.world:  # fsdp_spec divides the dim
            raise ValueError(f"{name}: dim {dim} of {tuple(old.shape)} does "
                             f"not split over {group.world} data ranks")
        module._parameters[leaf] = nn.Parameter(
            group.cut(old.detach(), dim), requires_grad=old.requires_grad)
        owners.setdefault(module, {})[leaf] = dim
    for module, leaves in owners.items():
        module._fsdp_group = group
        module._fsdp_dims = leaves
        module.__class__ = _gathering_class(type(module),
                                            tuple(sorted(leaves)))
    model.fsdp = FsdpState(group, dims, min_size)
    return model


def fsdp_params(model: nn.Module) -> List[nn.Parameter]:
    """The model's FSDP-sharded parameters, each rank's shard ([] when
    it is not sharded)."""
    state = getattr(model, "fsdp", None)
    if state is None:
        return []
    named = dict(model.named_parameters())
    return [named[n] for n in state.dims]
