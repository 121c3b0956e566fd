"""Tensor parallelism over a model group (the port of the JAX package's
`model` mesh axis, leccr_tpu/parallel/mesh.py:97-169).

The JAX package shards each Dense kernel by `param_partition_spec` and lets
GSPMD insert the activation collectives.  The port does it Megatron-style
(Shoeybi et al., arXiv 1909.08053) with explicit collectives over the model
group of a `parallel.mesh.DataMesh`, following the same layout layer by
layer (`parallel.mesh.partition_spec`):

- `ColumnParallelDense`: rank m holds its slice of the output features.
  The input is replicated and enters through `copy` (the identity; its
  backward sums the ranks' cotangents).  The bias stays whole and
  replicated, as in the JAX layout; each rank adds its slice, so its
  gradient is nonzero only there: `sum_column_bias_grads` sums it over
  the model group before the optimizer step.
- `RowParallelDense`: rank m holds its slice of the input features.  Its
  input is the rank's slice of a column-parallel output, or, where the
  producer is replicated (the caption branch's `out_proj`, whose
  q/k/v projections match no pattern), the replicated input cut by rank
  after `copy`.  The partial products are summed by `reduce` and the
  bias is added once.
- `ShardedEmbed`: the table sharded on its hidden dim; the rows come out
  gathered (`gather`, whose backward is the rank's slice).
- Attention runs on each rank's heads [h0, h0 + H/M): BERT's query, key
  and value slices are whole heads; CLIP's fused in_proj is cut per head
  in each of q, k and v.  The flash kernels take h0 and the layer's H
  (`ops.flash_attention`), so the regime and the dropout hash are the
  dense layer's.  A layer whose head count M does not divide stays dense
  (its out-projection then takes a replicated input), as JAX replicates a
  dim that M does not divide.

The port's choice for the sums: `reduce` gathers the ranks' partial
products (bf16 in training) and adds them in rank order in f32, rounding
once, so a sharded product lies within one bf16 rounding per partial of
the dense one and every rank gets the same bits; `copy`'s backward sums
the same way.

    shard_model(model, mesh)            # in place; the rank's shards
    state = gather_state(model, mesh)   # the dense state_dict
    outs, shards = replay_model_ranks(module, M, (x,))   # one process

`replay_model_ranks` runs the M ranks' shards of a module in one process,
in turn: each rank runs until its next collective, then the next rank;
the last one combines the parts (in rank order) for all.  The ranks'
graphs join at the collectives, so one backward through any rank's output
reaches every rank's shards.  It checks the layers on the CPU and times a
rank's layers on one card, as `parallel.ring.ring_infonce` replays the
ring.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from leccr_torch.ops.attention import Dense, Embed, MultiHeadAttention, _FFN


def _rank_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ parts in rank order, in f32 (not rounded back)."""
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc


# ------------------------------------------------------------ the groups

class ProcessModelGroup:
    """The model group of a process (`DataMesh.model_group`): `world`
    ranks, this one `rank`."""

    def __init__(self, rank: int, world: int,
                 group: Optional[dist.ProcessGroup]):
        self.rank, self.world, self.group = rank, world, group

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x summed in rank order in f32, in x's dtype (no
        gradient)."""
        return _rank_sum(self.all_gather(x)).to(x.dtype)


class _Copy(torch.autograd.Function):
    """f: the identity; the backward sums the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum(g), None


class _Reduce(torch.autograd.Function):
    """g: the ranks' partial sums added in rank order, in f32; the backward
    hands the cotangent to each rank's partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _rank_sum(group.all_gather(x))

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _Gather(torch.autograd.Function):
    """The ranks' x concatenated on the last dim; the backward is the
    rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.n = group.rank, x.shape[-1]
        return torch.cat(group.all_gather(x), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


class _Lockstep:
    """The turn-taking of `replay_model_ranks`' threads: one rank runs at
    a time, in rank order, from one collective to the next."""

    def __init__(self, world: int):
        self.world = world
        self.turn = 0
        self.parts: List[Any] = [None] * world
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.cv = threading.Condition()

    def _wait(self, rank: int) -> None:
        while self.turn != rank and self.error is None:
            self.cv.wait()
        if self.error is not None:
            raise RuntimeError("another replayed rank failed") from self.error

    def start(self, rank: int) -> None:
        with self.cv:
            self._wait(rank)

    def finish(self, rank: int) -> None:
        with self.cv:
            self.turn = (rank + 1) % self.world
            self.cv.notify_all()

    def fail(self, error: BaseException) -> None:
        with self.cv:
            if self.error is None:
                self.error = error
            self.cv.notify_all()

    def exchange(self, rank: int, x: Any, combine: Callable) -> Any:
        """Hand in x; when every rank has, `combine(parts)` (on the last
        rank's turn) is every rank's result."""
        with self.cv:
            self.parts[rank] = x
            if rank == self.world - 1:
                self.result = combine(self.parts)
                self.parts = [None] * self.world
            self.turn = (rank + 1) % self.world
            self.cv.notify_all()
            self._wait(rank)
            return self.result


class ReplayModelGroup:
    """Rank `rank` of `world` model ranks replayed in one process.  The
    collectives are plain differentiable ops on the ranks' tensors:
    `copy` is the identity (autograd sums the ranks' cotangents of a
    shared input), `reduce` the rank-order f32 sum, `gather` the
    concatenation."""

    def __init__(self, rank: int, world: int, lockstep: _Lockstep):
        self.rank, self.world, self.lockstep = rank, world, lockstep

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.lockstep.exchange(self.rank, x, _rank_sum)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.lockstep.exchange(self.rank, x,
                                      lambda parts: torch.cat(parts, dim=-1))


def model_group(mesh) -> Any:
    """The model group of `mesh`: a DataMesh (its model group), or a group
    object as is."""
    if hasattr(mesh, "model_group") and hasattr(mesh, "model_rank"):
        return ProcessModelGroup(mesh.model_rank, mesh.model_world,
                                 mesh.model_group)
    return mesh


# ------------------------------------------------------------ the layers

def _contiguous(n: int, rank: int, world: int) -> torch.Tensor:
    size = n // world
    return torch.arange(rank * size, (rank + 1) * size)


def _columns(n: int, rank: int, world: int, fused: int = 1) -> torch.Tensor:
    """Rank `rank`'s slice of each of `fused` stacked blocks of n / fused
    features (fused = 3: CLIP's in_proj, q, k and v, so the slices are the
    rank's heads in each)."""
    width = n // fused
    cols = _contiguous(width, rank, world)
    return torch.cat([cols + i * width for i in range(fused)])


class ColumnParallelDense(Dense):
    """The group rank's output features of a dense `Dense`: its slice of
    each of `fused` stacked blocks (see the module doc)."""

    def __init__(self, dense: Dense, group: Any, fused: int = 1):
        super().__init__(dense.in_features, dense.out_features // group.world,
                         bias=False, device="meta")
        self.compute_dtype = dense.compute_dtype
        self.group = group
        self.fused = fused
        self.full_features = dense.out_features
        self.register_buffer(
            "cols", _columns(dense.out_features, group.rank, group.world,
                             fused).to(dense.weight.device),
            persistent=False)
        self.weight = nn.Parameter(dense.weight.detach()[self.cols].clone(),
                                   requires_grad=dense.weight.requires_grad)
        if dense.bias is not None:
            self.bias = nn.Parameter(dense.bias.detach().clone(),
                                     requires_grad=dense.bias.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias[self.cols].to(dt)
        return F.linear(self.group.copy(x.to(dt)), self.weight.to(dt), bias)


class RowParallelDense(Dense):
    """Rank m's input features `rows` of a dense `Dense`; `input_sharded`:
    the input is already those features (a column-parallel output), else
    it is replicated and cut here (see the module doc)."""

    def __init__(self, dense: Dense, group: Any, input_sharded: bool):
        super().__init__(dense.in_features // group.world,
                         dense.out_features, bias=False, device="meta")
        self.compute_dtype = dense.compute_dtype
        self.group = group
        self.full_features = dense.in_features
        self.input_sharded = input_sharded
        self.register_buffer(
            "rows", _contiguous(dense.in_features, group.rank,
                                group.world).to(dense.weight.device),
            persistent=False)
        self.weight = nn.Parameter(
            dense.weight.detach()[:, self.rows].clone(),
            requires_grad=dense.weight.requires_grad)
        if dense.bias is not None:
            self.bias = nn.Parameter(dense.bias.detach().clone(),
                                     requires_grad=dense.bias.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        if not self.input_sharded:
            x = self.group.copy(x).index_select(-1, self.rows)
        out = self.group.reduce(F.linear(x, self.weight.to(dt)))
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(dt)


class ShardedEmbed(Embed):
    """Rank m's hidden features `cols` of an `Embed` table; the looked-up
    rows come out gathered, whole."""

    def __init__(self, embed: Embed, group: Any):
        super().__init__(embed.num_embeddings,
                         embed.embedding_dim // group.world, device="meta")
        self.compute_dtype = embed.compute_dtype
        self.group = group
        self.full_features = embed.embedding_dim
        self.register_buffer(
            "cols", _contiguous(embed.embedding_dim, group.rank,
                                group.world).to(embed.weight.device),
            persistent=False)
        self.weight = nn.Parameter(embed.weight.detach()[:, self.cols].clone(),
                                   requires_grad=embed.weight.requires_grad)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.group.gather(
            F.embedding(ids, self.weight).to(self.compute_dtype))


_SHARDED = (ColumnParallelDense, RowParallelDense, ShardedEmbed)


def shard_dense(dense: Dense, group: Any, dim: int,
                input_sharded: bool = False, fused: int = 1) -> Dense:
    """The group rank's shard of `dense`: dim 0 (output features) column-
    parallel (`fused` stacked blocks, each cut), dim 1 (input features)
    row-parallel (`input_sharded`: whether the input is the rank's
    slice already)."""
    if dim == 0:
        return ColumnParallelDense(dense, group, fused)
    return RowParallelDense(dense, group, input_sharded)


def _layout(mod: nn.Module, world: int
            ) -> Tuple[int, List[torch.Tensor], Tuple[int, ...]]:
    """A sharded layer's weight: (the sharded dim, every rank's indices on
    it, the dense shape)."""
    full = mod.full_features
    if isinstance(mod, ColumnParallelDense):
        return 0, [_columns(full, r, world, mod.fused)
                   for r in range(world)], (full, mod.in_features)
    index = [_contiguous(full, r, world) for r in range(world)]
    if isinstance(mod, RowParallelDense):
        return 1, index, (mod.out_features, full)
    return 1, index, (mod.num_embeddings, full)


# ------------------------------------------------------ the whole model

def _attention_classes():
    from leccr_torch.models.bert import _BertLayer, _BertSelfAttention
    from leccr_torch.models.clip import _CLIPAttention, _ResidualBlock

    return _CLIPAttention, _BertSelfAttention, _ResidualBlock, _BertLayer


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Replace, in place, each layer of `model` that the JAX layout shards
    over the model axis (`parallel.mesh.partition_spec`) by the group
    rank's shard, and set the attention layers' head spans.  mesh: a
    DataMesh, or a group (`ReplayModelGroup`).  Returns the model."""
    from leccr_torch.models.weights import flax_paths
    from leccr_torch.parallel.mesh import partition_spec

    group = model_group(mesh)
    world, m = group.world, group.rank
    if world == 1:
        return model
    if getattr(model, "tp_group", None) is not None:
        raise ValueError("the model is sharded already")
    clip_attn, bert_attn, clip_block, bert_layer = _attention_classes()
    paths = flax_paths(model)
    names = {id(p): n for n, p in model.named_parameters()}

    def spec(layer: nn.Module) -> Optional[int]:
        w = layer.weight
        return partition_spec(paths[names[id(w)]], w.shape, world)

    def column(parent, name, fused=1):
        layer = getattr(parent, name)
        setattr(parent, name, shard_dense(layer, group, 0, fused=fused))

    def row(parent, name, input_sharded):
        layer = getattr(parent, name)
        setattr(parent, name, shard_dense(layer, group, 1, input_sharded))

    def pair(parent, up, down):
        """A column-parallel `up` feeding a row-parallel `down`."""
        sharded = spec(getattr(parent, up)) == 0
        if sharded:
            column(parent, up)
        if spec(getattr(parent, down)) == 1:
            row(parent, down, input_sharded=sharded)
        return sharded

    kept = set()  # q/k/v projections a head count keeps dense
    for mod in list(model.modules()):
        if isinstance(mod, clip_attn):
            if mod.heads % world == 0 and spec(mod.in_proj) == 0:
                column(mod, "in_proj", fused=3)
                mod.head_span = (m * mod.heads // world, mod.heads // world)
                sharded = True
            else:
                kept.add(id(mod.in_proj.weight))
                sharded = False
            if spec(mod.out_proj) == 1:
                row(mod, "out_proj", input_sharded=sharded)
        elif isinstance(mod, bert_attn):
            qkv = ("query", "key", "value")
            if mod.num_heads % world == 0 and all(
                    spec(getattr(mod, n)) == 0 for n in qkv):
                for n in qkv:
                    column(mod, n)
                mod.head_span = (m * mod.num_heads // world,
                                 mod.num_heads // world)
                sharded = True
            else:
                kept.update(id(getattr(mod, n).weight) for n in qkv)
                sharded = False
            if spec(mod.out) == 1:
                row(mod, "out", input_sharded=sharded)
        elif isinstance(mod, MultiHeadAttention):
            # q/k/v_proj match no pattern: replicated; out_proj row-parallel
            if spec(mod.out_proj) == 1:
                row(mod, "out_proj", input_sharded=False)
        elif isinstance(mod, clip_block):
            pair(mod, "c_fc", "c_proj")
        elif isinstance(mod, bert_layer):
            pair(mod, "intermediate", "output")
        elif isinstance(mod, _FFN):
            if pair(mod, "linear1", "linear2"):
                mod.dropout_shard = (-1, m, world)
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is Embed and spec(child) == 1:
                setattr(parent, name, ShardedEmbed(child, group))
    sharded = {id(p) for p in sharded_params(model)}
    missing = [n for n, p in model.named_parameters()
               if n in paths
               and partition_spec(paths[n], p.shape, world) is not None
               and id(p) not in sharded | kept]
    if missing:
        raise NotImplementedError(f"no tensor-parallel layer for {missing}")
    model.tp_group = group
    return model


def _layouts(model: nn.Module) -> Dict[str, Tuple[int, List[torch.Tensor],
                                                  Tuple[int, ...]]]:
    """Each sharded weight's name -> `_layout`."""
    return {(f"{prefix}." if prefix else "") + "weight":
            _layout(mod, mod.group.world)
            for prefix, mod in model.named_modules()
            if isinstance(mod, _SHARDED)}


def _assemble(layout, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The dense tensor of a sharded weight from every rank's part."""
    dim, index, shape = layout
    full = torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device)
    for idx, part in zip(index, parts):
        full.index_copy_(dim, idx.to(full.device), part)
    return full


def gather_tensors(model: nn.Module, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor shaped as the rank's parameter} -> the same
    tensors at the dense shape (a collective over the data group under
    FSDP, `parallel.fsdp`, then over the model group: every rank calls it
    and gets them).  Unsharded names come back as they are."""
    fsdp = getattr(model, "fsdp", None)
    if fsdp is not None:  # the data ranks' shards first
        tensors = fsdp.gather_tensors(tensors)
    group = getattr(model, "tp_group", None)
    if group is None:
        return dict(tensors)
    layouts = _layouts(model)
    return {name: (_assemble(layouts[name], group.all_gather(t.detach()))
                   if name in layouts else t)
            for name, t in tensors.items()}


def shard_tensors(model: nn.Module, tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of `gather_tensors`: dense tensors -> the rank's
    slices, the model group's and then the data group's (no
    collective)."""
    group = getattr(model, "tp_group", None)
    out = dict(tensors)
    if group is not None:
        layouts = _layouts(model)
        for name, t in tensors.items():
            if name in layouts:
                dim, index, _ = layouts[name]
                out[name] = t.index_select(dim, index[group.rank].to(t.device))
    fsdp = getattr(model, "fsdp", None)
    return out if fsdp is None else fsdp.shard_tensors(out)


def merge_replay(shards: Sequence[nn.Module], grads: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """The dense parameters (or, `grads`, gradients) of a replay's shards
    (`replay_model_ranks`): each sharded weight assembled from the ranks'
    slices; a replicated parameter is rank 0's, and its gradient the
    rank-order sum of the ranks' (a backward through one rank's output
    reaches each rank's copy through that rank's own uses)."""
    layouts = _layouts(shards[0])
    per_rank = [dict(s.named_parameters()) for s in shards]
    out = {}
    for name in per_rank[0]:
        parts = [(p[name].grad if grads else p[name].detach())
                 for p in per_rank]
        if name in layouts:
            out[name] = _assemble(layouts[name], parts)
        elif grads:  # a rank's copy after its last collective gets none
            parts = [p for p in parts if p is not None]
            out[name] = _rank_sum(parts).to(parts[0].dtype)
        else:
            out[name] = parts[0]
    return out


def gather_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The dense state_dict of a sharded model (every rank calls it and
    gets it); the model's own state_dict when it is not sharded."""
    return gather_tensors(model, model.state_dict())


def load_dense_state(model: nn.Module, state: Dict[str, torch.Tensor]
                     ) -> None:
    """Load a dense state_dict into a (sharded) model: each rank takes its
    slices."""
    model.load_state_dict(shard_tensors(model, state))


def _param_names(model: nn.Module, optimizer: torch.optim.Optimizer
                 ) -> List[str]:
    """The names of the optimizer's parameters, in its state_dict's index
    order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_optimizer_state(model, optimizer, state, fn):
    """The optimizer state_dict `state` with each per-parameter tensor
    shaped like its parameter replaced by fn({name: tensor})[name]."""
    names = _param_names(model, optimizer)
    out = {"param_groups": state["param_groups"], "state": {}}
    for idx, entry in state["state"].items():
        name = names[idx]
        out["state"][idx] = {
            k: (fn({name: v})[name]
                if isinstance(v, torch.Tensor) and v.dim() > 0 else v)
            for k, v in entry.items()}
    return out


def gather_optimizer_state(model: nn.Module,
                           optimizer: torch.optim.Optimizer) -> Dict:
    """The optimizer's state_dict with every moment at its dense
    parameter's shape (a collective over the data and model groups), the
    format of a one-process run's."""
    state = optimizer.state_dict()
    if not is_sharded(model):
        return state
    return _map_optimizer_state(model, optimizer, state,
                                lambda t: gather_tensors(model, t))


def shard_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                          state: Dict) -> Dict:
    """A dense optimizer state_dict (`gather_optimizer_state`'s) cut to
    this rank's slices, for `optimizer.load_state_dict`."""
    if not is_sharded(model):
        return state
    return _map_optimizer_state(model, optimizer, state,
                                lambda t: shard_tensors(model, t))


def sum_column_bias_grads(model: nn.Module) -> None:
    """Sum each column-parallel bias's gradient over the model group, in
    place: each rank's is nonzero only on its slice, and the sum keeps
    the ranks' replicated biases equal."""
    group = getattr(model, "tp_group", None)
    if group is None:
        return
    for mod in model.modules():
        bias = mod._parameters.get("bias")  # the shard itself under FSDP
        if isinstance(mod, ColumnParallelDense) and bias is not None \
                and bias.grad is not None:
            bias.grad.copy_(group.sum(bias.grad))


def sharded_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters that hold a model slice (the others are replicated
    over the model group)."""
    return [mod._parameters["weight"] for mod in model.modules()
            if isinstance(mod, _SHARDED)]


def is_sharded(model: nn.Module) -> bool:
    """Whether the model holds slices: over the model group
    (`shard_model`) or the data group (`parallel.fsdp.shard_fsdp`)."""
    return (getattr(model, "tp_group", None) is not None
            or getattr(model, "fsdp", None) is not None)


# ------------------------------------------------------------ the replay

def replay_model_ranks(module: nn.Module, world: int,
                       inputs: Sequence[Any],
                       call: Optional[Callable] = None,
                       shard: Callable = shard_model
                       ) -> Tuple[List[Any], List[nn.Module]]:
    """Shard a copy of `module` for each of `world` model ranks
    (shard(copy, group), default `shard_model`; a lone layer takes
    `shard_dense` or `ShardedEmbed`) and run the ranks in one process, in
    lockstep (see the module doc).  call: call(shard, rank, *inputs)
    (default shard(*inputs)).  Returns (each rank's output, each rank's
    shard).  Gradient mode is the caller's; the ranks' graphs join at the
    collectives, so a replicated output's backward goes through one
    rank's output.  A block under remat cannot be replayed (its recompute
    would wait for the other ranks)."""
    lock = _Lockstep(world)
    shards = [shard(copy.deepcopy(module), ReplayModelGroup(r, world, lock))
              for r in range(world)]
    outs: List[Any] = [None] * world
    grad = torch.is_grad_enabled()
    device = next(module.parameters()).device

    def run(r: int) -> None:
        try:
            with torch.set_grad_enabled(grad):
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                lock.start(r)
                if call is None:
                    outs[r] = shards[r](*inputs)
                else:
                    outs[r] = call(shards[r], r, *inputs)
        except BaseException as e:
            lock.fail(e)  # the other ranks stop waiting; join re-raises it
            raise
        finally:
            lock.finish(r)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if lock.error is not None:
        raise lock.error
    return outs, shards
