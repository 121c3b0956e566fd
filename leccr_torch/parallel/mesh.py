"""The data-parallel process group (the port of `leccr_tpu/parallel/mesh.py`
for its `data` axis).

The JAX package runs one controller over a device mesh; the port runs one
process per device, as the reference's NCCL DDP does.  A `DataMesh` holds
the world size, this process's rank, its device and the process group:

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

Each rank keeps its local rows: the JAX package's `host_local_to_global` /
`shard_batch` have no counterpart.  Tensor parallelism and FSDP
(`param_partition_spec`, `params_shardings`) are the next slice of the
port: `train.step.check_parallel` raises for them.

The collectives the trainer and the ring share:
- `all_gather_rows(x, mesh)`: the ranks' x concatenated in rank order; the
  backward hands each rank its own rows' cotangent (the reference's
  AllGather, models/xvlm.py:50-70): each rank's gradient is its rows' share.
- `sum_grad(x, mesh)`: x as it is; the backward sums the ranks' cotangents
  in rank order, so a replicated input (the temperature) gets the
  derivative of every rank's use.
- `rank_sum(x, mesh)`: the sum over ranks of a tensor, in rank order (an
  all-gather and one local sum: the same bits on every rank, and the bits
  of the one-process replay).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from leccr_torch.config import ParallelConfig

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class DataMesh:
    """One process of a data-parallel world: `world` processes, this one
    `rank`, computing on `device`, communicating over `group` (None: the
    default group)."""

    world: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @classmethod
    def create(cls, cfg: Optional[ParallelConfig], rank: int, world: int,
               init_method: str = "env://", local_rank: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None
               ) -> "DataMesh":
        """Join (or reuse) the default process group as `rank` of `world`.
        device: None = cuda:local_rank on NCCL (local_rank defaults to
        rank); "cpu" = gloo."""
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
        return cls(world=world, rank=rank, device=device)

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
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def destroy(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def check_layout(cfg: Optional[ParallelConfig], world: int) -> None:
    """`parallel.data` is -1 (the world) or the world; `parallel.dcn_data`
    splits it evenly (`make_mesh`'s checks, leccr_tpu/parallel/mesh.py:
    70-89)."""
    if cfg is None:
        return
    if cfg.data not in (-1, world):
        raise ValueError(f"parallel.data: {cfg.data} must be -1 (the world) "
                         f"or the world, {world} processes")
    dcn = cfg.dcn_data
    if dcn > 1 and world % dcn:
        raise ValueError(f"data={world} must split evenly over "
                         f"dcn_data={dcn} slices")


def _gather(x: torch.Tensor, mesh: DataMesh) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return parts


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.rank = x.shape[0], mesh.rank
        return torch.cat(_gather(x, mesh))

    @staticmethod
    def backward(ctx, g):
        start = ctx.rank * ctx.rows
        return g[start:start + ctx.rows], None


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """[world · b, ...]: every rank's x [b, ...] in rank order; the
    gradient to x is the rows' own slice of the cotangent."""
    if mesh.world == 1:
        return x
    return _AllGatherRows.apply(x, mesh)


def rank_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Σ over ranks of x, summed in rank order (torch.stack(...).sum(0));
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
    """x; its gradient is the sum over ranks, in rank order, of each
    rank's cotangent."""
    if mesh.world == 1:
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
    """Sum each parameter's .grad over the ranks, in place, in buckets of
    about `bucket_bytes` (one flat all-reduce a bucket); every rank gets
    the same bits.  Every parameter must have a .grad."""
    if mesh.world == 1:
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

