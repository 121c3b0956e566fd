"""The process layout of data and tensor parallelism (the port of
`leccr_tpu/parallel/mesh.py`).

The JAX package runs one controller over a [data, model] device mesh; the
port runs one process per device, as the reference's NCCL DDP does.  A
`DataMesh` holds the world size, this process's rank, its device and the
process groups:

    mesh = DataMesh.from_env(cfg.parallel)          # torchrun's environment
    mesh = DataMesh.create(cfg.parallel, rank, world,
                           init_method="tcp://localhost:29500",
                           device="cpu")            # explicit, gloo

The backend is NCCL on the GPU (device cuda:LOCAL_RANK) and gloo only when
the caller asks for the CPU.  Rank order is the launcher's: torchrun
numbers the ranks node-major, so `parallel.dcn_data` > 1 (the number of
nodes the data axis spans) only checks that the world splits evenly over
them, as the JAX mesh does; NCCL picks the hierarchical reduce (NVLink
inside a node, the network across nodes) on its own.

The world is data × model processes, rank = d · model + m, as `make_mesh`
reshapes the devices to [data, model]: a model group is `model`
consecutive ranks (`model_group`), a data group the ranks of one model
rank, `model` apart (`group`).  `data_rank` / `data_world` are the batch
axis (the loaders, the gathered negatives, the ring, the random streams,
the gradient sum); `model_rank` / `model_world` the tensor-parallel axis
(`parallel/tensor.py`: which columns, rows and heads a rank holds).  With
`parallel.model` = 1 the data axis is the world and `group` the default
group, as before tensor parallelism.  `partition_spec` is JAX's
`param_partition_spec` with `params_shardings`' divisibility rule, on the
port's parameters.  FSDP (`parallel.fsdp`) cuts parameters over the data
group too: `parallel/fsdp.py`.

Each rank keeps its local rows: the JAX package's `host_local_to_global` /
`shard_batch` have no counterpart.

The collectives the trainer and the ring share:
- `all_gather_rows(x, mesh)`: the data ranks' x concatenated in data-rank
  order; the backward hands each rank its own rows' cotangent (the
  reference's AllGather, models/xvlm.py:50-70): each rank's gradient is its
  rows' share.
- `sum_grad(x, mesh)`: x as it is; the backward sums the data ranks'
  cotangents in rank order, so a replicated input (the temperature) gets
  the derivative of every rank's use.
- `rank_sum(x, mesh)`: the sum over data ranks of a tensor, in rank order
  (an all-gather and one local sum: the same bits on every rank, and the
  bits of the one-process replay).
- `all_reduce_grads(params, mesh)`: each gradient summed over the data
  group (FSDP's shards are not passed: their gradients arrive summed).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from leccr_torch.config import ParallelConfig

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class DataMesh:
    """One process of a data × model world: `world` processes, this one
    `rank` (d · model + m), computing on `device`; `group` is its data
    group (None: the default group, when model = 1) and `model_group` its
    model group (None when model = 1)."""

    world: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    model: int = 1
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_world(self) -> int:
        return self.world // self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_world(self) -> int:
        return self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def data_peer(self, data_rank: int) -> int:
        """The global rank of data rank `data_rank` at this model rank."""
        return (data_rank % self.data_world) * self.model + self.model_rank

    @classmethod
    def create(cls, cfg: Optional[ParallelConfig], rank: int, world: int,
               init_method: str = "env://", local_rank: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None
               ) -> "DataMesh":
        """Join (or reuse) the default process group as `rank` of `world`,
        and with `parallel.model` = M > 1 build the model groups (M
        consecutive ranks) and the data groups (stride M), on the default
        group's backend.  device: None = cuda:local_rank on NCCL
        (local_rank defaults to rank); "cpu" = gloo."""
        check_layout(cfg, world)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is outside a world of {world}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: the data-parallel path runs one process "
                    "per GPU unless the caller passes device='cpu'")
            device = torch.device("cuda", rank if local_rank is None
                                  else local_rank)
            torch.cuda.set_device(device)
        device = torch.device(device)
        backend = "nccl" if device.type == "cuda" else "gloo"
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=world,
                                    timeout=TIMEOUT)
        elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise ValueError(
                f"the process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {rank} of {world}")
        return cls(world=world, rank=rank, device=device).use_layout(cfg)

    def use_layout(self, cfg: Optional[ParallelConfig]) -> "DataMesh":
        """Take `cfg`'s layout over this world (a collective: every process
        calls it): with `parallel.model` = M > 1, build the model groups
        (M consecutive ranks) and the data groups (stride M), on the default
        group's backend.  A mesh that has the layout already stays as it
        is.  Returns the mesh."""
        check_layout(cfg, self.world)
        model = cfg.model if cfg is not None else 1
        if model == self.model:
            return self
        if self.model != 1:
            raise ValueError(f"the mesh is model {self.model} already, not "
                             f"{model}")
        self.model = model
        data = self.world // model
        # every process creates every group, in one order
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == self.data_rank:
                self.model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == self.model_rank:
                self.group = g
        return self

    @classmethod
    def from_env(cls, cfg: Optional[ParallelConfig] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> "DataMesh":
        """The mesh of torchrun's environment: RANK, WORLD_SIZE, LOCAL_RANK
        and MASTER_ADDR / MASTER_PORT."""
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"--multihost needs torchrun's environment; "
                               f"{', '.join(missing)} not set")
        rank = int(os.environ["RANK"])
        return cls.create(cfg, rank, int(os.environ["WORLD_SIZE"]),
                          local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                          device=device)

    def barrier(self) -> None:
        """Wait for every process of the world."""
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def destroy(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def check_layout(cfg: Optional[ParallelConfig], world: int) -> None:
    """`parallel.model` divides the world; `parallel.data` is -1 or world /
    model (the world when model = 1); `parallel.dcn_data` splits the data
    axis evenly (`make_mesh`'s checks, leccr_tpu/parallel/mesh.py:70-89)."""
    if cfg is None:
        return
    model = cfg.model
    if model < 1 or world % model:
        raise ValueError(f"parallel.model: {model} must divide the world, "
                         f"{world} processes")
    data = world // model
    if cfg.data not in (-1, data):
        if model == 1:
            raise ValueError(f"parallel.data: {cfg.data} must be -1 (the "
                             f"world) or the world, {world} processes")
        raise ValueError(f"parallel.data: {cfg.data} must be -1 or world / "
                         f"model = {world} / {model} = {data}")
    dcn = cfg.dcn_data
    if dcn > 1 and data % dcn:
        raise ValueError(f"data={data} must split evenly over "
                         f"dcn_data={dcn} slices")


# The tensor-parallel layout of the JAX package (leccr_tpu/parallel/mesh.py:
# 103-121, 153-157): Dense kernels of these parent modules are sharded on
# their output features (column-parallel) or input features (row-parallel);
# an embedding table on its hidden dim when it is even; everything else,
# and any dim the model count does not divide, is replicated.  The regexes
# match with .search, as JAX's do.
_COL_PARALLEL = re.compile(
    r"(c_fc|in_proj|intermediate|query|key|value|linear1)$")
_ROW_PARALLEL = re.compile(r"(c_proj|out_proj|output|out|linear2)$")


def flax_spec(flax_path: Sequence[str], shape: Sequence[int]
              ) -> Tuple[Optional[str], ...]:
    """`param_partition_spec` of a flax leaf: its spec as a tuple over the
    leaf's dims, "model" on the sharded dim ((None, "model"),
    ("model", None) or ())."""
    if len(shape) < 2:
        return ()
    parent = flax_path[-2] if len(flax_path) >= 2 else ""
    name = flax_path[-1]
    if name == "kernel" and len(shape) == 2:
        if _COL_PARALLEL.search(parent):
            return (None, "model")
        if _ROW_PARALLEL.search(parent):
            return ("model", None)
    if name == "embedding" and len(shape) == 2:
        return (None, "model") if shape[1] % 2 == 0 else ()
    return ()


def partition_spec(flax_path: Sequence[str], shape: Sequence[int],
                   model: int) -> Optional[int]:
    """Which dim of a port parameter is sharded over `model` ranks, or None
    (replicated).  flax_path: the parameter's flax path
    (`models.weights.flax_paths`); shape: the port parameter's shape (a
    Dense weight is the flax kernel transposed, [out, in]).  A sharded dim
    that `model` does not divide stays replicated, as `params_shardings`
    does."""
    if model <= 1:
        return None
    flax_shape = tuple(shape)
    transposed = flax_path[-1] == "kernel" and len(shape) == 2
    if transposed:
        flax_shape = flax_shape[::-1]
    spec = flax_spec(flax_path, flax_shape)
    if "model" not in spec:
        return None
    dim = spec.index("model")
    if flax_shape[dim] % model:
        return None
    return len(shape) - 1 - dim if transposed else dim


def _gather(x: torch.Tensor, mesh: DataMesh) -> List[torch.Tensor]:
    """Every data rank's x, in data-rank order."""
    parts = [torch.empty_like(x) for _ in range(mesh.data_world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return parts


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.rank = x.shape[0], mesh.data_rank
        return torch.cat(_gather(x, mesh))

    @staticmethod
    def backward(ctx, g):
        start = ctx.rank * ctx.rows
        return g[start:start + ctx.rows], None


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """[data_world · b, ...]: every data rank's x [b, ...] in rank order;
    the gradient to x is the rows' own slice of the cotangent."""
    if mesh.data_world == 1:
        return x
    return _AllGatherRows.apply(x, mesh)


def rank_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Σ over data ranks of x, summed in rank order (torch.stack(...).sum(0));
    differentiable as `all_gather_rows`."""
    return all_gather_rows(x[None], mesh).sum(0)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.stack(_gather(g, ctx.mesh)).sum(0), None


def sum_grad(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """x; its gradient is the sum over data ranks, in rank order, of each
    rank's cotangent."""
    if mesh.data_world == 1:
        return x
    return _SumGrad.apply(x, mesh)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x; its gradient is the cotangent times `scale`."""
    if scale == 1.0:
        return x
    return _ScaleGrad.apply(x, scale)


def all_reduce_grads(params, mesh: DataMesh,
                     bucket_bytes: int = 64 << 20) -> None:
    """Sum each parameter's .grad over the data group, in place, in buckets
    of about `bucket_bytes` (one flat all-reduce a bucket); every rank gets
    the same bits.  Every parameter must have a .grad."""
    if mesh.data_world == 1:
        return
    bucket, size = [], 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=mesh.group)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    for p in params:
        bucket.append(p.grad)
        size += p.grad.numel() * p.grad.element_size()
        if size >= bucket_bytes:
            flush()
            bucket, size = [], 0
    if bucket:
        flush()

