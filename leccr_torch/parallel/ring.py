"""Ring InfoNCE: the global-negative soft-label contrastive loss without the
global logits matrix (the port of `leccr_tpu/parallel/ring.py`).

Each rank keeps its [b, E] feature shards; the other side's shard travels
round the ring (send to rank + 1, receive from rank − 1, JAX's permutation
`(d, (d + 1) % world)`) and every rank folds the visiting block into a
streaming logsumexp with the positive sum and count per row.  The loss is
`models.losses.soft_label_contrastive_loss` of the gathered batch, soft
labels from duplicate ids with their global counts included.

    loss = ring_infonce_local(feat_a, feat_b, temp, idx, mesh, impl)  # P2P
    loss = ring_infonce(feat_a, feat_b, temp, idx, world, impl)       # replay

- impl="dense": each block is plain PyTorch (JAX's `_ring_half`); autograd
  runs through the rotations (`_Rotate`: its backward rotates the cotangent
  the other way, `ppermute`'s transpose).
- impl="fused": each block goes through `ops.infonce` (kernels 9 on the
  way forward, 10 and 11 on the way back on CUDA tensors; their plain
  versions on the CPU) inside a `torch.autograd.Function` with JAX's hand
  ring backward (`_ring_half_fused*`): the forward visits `world` blocks;
  the backward sends (k, ids, dk) round together, each rank adding its
  block's dk, so each dk is home after `world` steps; d_temp =
  −g·Σ(dq_raw·q)/temp².

`ring_infonce_local` runs inside a process group (`parallel.mesh.DataMesh`)
on local shards, round the data ranks of one model rank (the data group:
under tensor parallelism every model rank of a data rank runs the same
ring on the same rows).  Its value is the global loss, the same bits on every
rank, and each rank's gradient is the derivative of that loss by its own
inputs: its feature shards, and the temperature (replicated: the ranks'
cotangents are summed in rank order, as JAX's shard_map transpose psums
them).  With idx None the ids are rank · b + arange(b).

`ring_infonce` is the counterpart of JAX's global-array wrapper: it cuts
global [B, E] tensors into `world` shards and replays the ranks' schedules
in one process, rank r meeting shard (r − i) mod world at rotation i, every
merge and every gradient sum in the ring's own order.  The block code is
shared, so the replay equals the multi-process ring bit for bit on one kind
of device; it exists to check the ring's schedule and its hand backward at
the scale config's real blocks on one card, and it is what a one-process
`TrainStep(num_blocks=W)` takes for `negatives: ring | ring_fused`.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from leccr_torch.ops.infonce import infonce_bwd_raw, infonce_stats
from leccr_torch.parallel.mesh import DataMesh, rank_sum, sum_grad

IMPLS = ("dense", "fused")


def _rotate(tensors: Sequence[torch.Tensor], mesh: DataMesh,
            step: int = 1) -> List[torch.Tensor]:
    """Each rank's tensors sent to data rank + step and replaced by data
    rank − step's (one batch of point-to-point ops; the peers are named by
    their global ranks)."""
    if mesh.data_world == 1:
        return list(tensors)
    dst = mesh.data_peer(mesh.data_rank + step)
    src = mesh.data_peer(mesh.data_rank - step)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for tag, (t, o) in enumerate(zip(tensors, outs)):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, mesh.group,
                              tag))
        ops.append(dist.P2POp(dist.irecv, o, src, mesh.group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """A tensor to rank + 1; the cotangent goes back to rank − 1."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _rotate([x], mesh)[0]

    @staticmethod
    def backward(ctx, g):
        return _rotate([g], ctx.mesh, -1)[0], None


# ------------------------------------------------------------ dense blocks

def _dense_half(q: torch.Tensor, idx_q: torch.Tensor, inv_temp,
                blocks: Iterator[Tuple[torch.Tensor, torch.Tensor]]
                ) -> torch.Tensor:
    """Σ_rows [logsumexp_j l_ij − (1/c_i) Σ_{j: idx_j = idx_i} l_ij] of
    q's rows over every visiting (k shard, ids) block, l = q kᵀ · inv_temp
    (`_ring_half`'s block_stats, streamed in visiting order)."""
    b = q.shape[0]
    q = q.view_as(q)  # one entry node: q's block cotangents sum here first
    m = torch.full((b,), -torch.inf, dtype=q.dtype, device=q.device)
    s = torch.zeros(b, dtype=q.dtype, device=q.device)
    pos_sum = torch.zeros_like(s)
    pos_cnt = torch.zeros_like(s)
    for k, idx_k in blocks:
        logits = (q @ k.T) * inv_temp
        new_m = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - new_m) + torch.exp(
            logits - new_m[:, None]).sum(dim=1)
        m = new_m
        pos = (idx_q[:, None] == idx_k[None, :]).to(logits.dtype)
        pos_sum = pos_sum + (logits * pos).sum(dim=1)
        pos_cnt = pos_cnt + pos.sum(dim=1)
    lse = m + torch.log(s)
    return (lse - pos_sum / torch.clamp_min(pos_cnt, 1.0)).sum()


def _p2p_blocks(k, idx_k, mesh: DataMesh):
    """The blocks a rank meets: its own, then world − 1 rotations."""
    k = k.view_as(k)  # one entry node, as `_dense_half`'s q
    for i in range(mesh.data_world):
        yield k, idx_k
        if i < mesh.data_world - 1:
            k = _Rotate.apply(k, mesh)
            idx_k = _rotate([idx_k], mesh)[0]


def _replay_views(shards: List[torch.Tensor]) -> List[torch.Tensor]:
    """One rotation of the replay: rank r now holds what rank r − 1 held.
    A view per hop, so that autograd sums a shard's cotangents as the
    ring's backward does, hop by hop."""
    w = len(shards)
    return [shards[(r - 1) % w].view_as(shards[(r - 1) % w])
            for r in range(w)]


# ------------------------------------------------------------ fused blocks

def _fused_stats(q, idx_q, inv_temp, blocks):
    """(lse, pos_sum, pos_cnt) [b] of q over the visiting blocks, each
    block's statistics from `ops.infonce.infonce_stats`, merged with
    logaddexp and sums in visiting order."""
    b = q.shape[0]
    lse = torch.full((b,), -torch.inf, dtype=torch.float32, device=q.device)
    ps = torch.zeros(b, dtype=torch.float32, device=q.device)
    pc = torch.zeros_like(ps)
    for k, idx_k in blocks:
        lse_b, ps_b, pc_b = infonce_stats(q, k, idx_q, idx_k, inv_temp)
        lse, ps, pc = torch.logaddexp(lse, lse_b), ps + ps_b, pc + pc_b
    return lse, ps, pc


def _half_loss(lse, ps, pc) -> torch.Tensor:
    return (lse - ps / torch.clamp_min(pc, 1.0)).sum()


def _finish_grads(g, q, inv_temp, dq_raw, dk_raw):
    """(dq, dk, d_temp) from the raw sums: scale g / temp, and
    d_temp = −g·Σ(dq_raw·q)/temp² (Σ_i dq_raw_i·q_i = Σ_ij w_ij q_i·k_j)."""
    scale = g * inv_temp
    d_temp = -g * torch.sum(dq_raw * q) * inv_temp * inv_temp
    return dq_raw * scale, dk_raw * scale, d_temp


class _FusedHalf(torch.autograd.Function):
    """One rank's half of the fused ring (`_ring_half_fused`)."""

    @staticmethod
    def forward(ctx, q, k, idx_q, idx_k, temp, mesh):
        q, k = q.float(), k.float()
        inv_temp = 1.0 / temp
        blocks = _rotating(k, idx_k, mesh)
        lse, ps, pc = _fused_stats(q, idx_q, inv_temp, blocks)
        ctx.mesh = mesh
        ctx.save_for_backward(q, k, idx_q, idx_k, temp, lse, pc)
        return _half_loss(lse, ps, pc)

    @staticmethod
    def backward(ctx, g):
        q, k, idx_q, idx_k, temp, lse, pc = ctx.saved_tensors
        mesh = ctx.mesh
        inv_temp = 1.0 / temp
        dq_raw = torch.zeros_like(q)
        dk = torch.zeros_like(k)
        for i in range(mesh.data_world):
            dq_b, dk_b = infonce_bwd_raw(q, k, idx_q, idx_k, inv_temp, lse,
                                         pc)
            dq_raw = dq_raw + dq_b
            dk = dk + dk_b
            if i < mesh.data_world - 1:
                k, idx_k, dk = _rotate([k, idx_k, dk], mesh)
            else:  # the last hop brings each dk home
                dk = _rotate([dk], mesh)[0]
        dq, dk, d_temp = _finish_grads(g, q, inv_temp, dq_raw, dk)
        return dq, dk, None, None, d_temp, None


def _rotating(k, idx_k, mesh: DataMesh):
    """The blocks a rank meets in the fused forward, without autograd."""
    for i in range(mesh.data_world):
        yield k, idx_k
        if i < mesh.data_world - 1:
            k, idx_k = _rotate([k, idx_k], mesh)


class _ReplayFusedHalf(torch.autograd.Function):
    """Every rank's half of the fused ring, replayed in one process.
    q, k: the world's shards; temps [W]: each rank's temperature.  Returns
    [W], each rank's half loss."""

    @staticmethod
    def forward(ctx, q, k, idx, temps, world):
        qs = q.float().chunk(world)
        ks = k.float().chunk(world)
        ids = idx.chunk(world)
        stats = [_fused_stats(
            qs[r], ids[r], 1.0 / temps[r],
            ((ks[(r - i) % world], ids[(r - i) % world])
             for i in range(world))) for r in range(world)]
        ctx.world = world
        ctx.save_for_backward(q, k, idx, temps,
                              *[t for st in stats for t in (st[0], st[2])])
        return torch.stack([_half_loss(*st) for st in stats])

    @staticmethod
    def backward(ctx, g):
        q, k, idx, temps, *saved = ctx.saved_tensors
        w = ctx.world
        qs, ks, ids = q.float().chunk(w), k.float().chunk(w), idx.chunk(w)
        lse, pc = saved[0::2], saved[1::2]
        inv = [1.0 / temps[r] for r in range(w)]
        dq_raw = [torch.zeros_like(x) for x in qs]
        held = list(range(w))  # the shard rank r holds
        dk = [torch.zeros_like(x) for x in ks]  # accumulators, by holder
        for i in range(w):
            for r in range(w):
                s = held[r]
                dq_b, dk_b = infonce_bwd_raw(qs[r], ks[s], ids[r], ids[s],
                                             inv[r], lse[r], pc[r])
                dq_raw[r] = dq_raw[r] + dq_b
                dk[r] = dk[r] + dk_b
            held = [held[(r - 1) % w] for r in range(w)]
            dk = [dk[(r - 1) % w] for r in range(w)]
        grads = [_finish_grads(g[r], qs[r], inv[r], dq_raw[r], dk[r])
                 for r in range(w)]
        return (torch.cat([x[0] for x in grads]),
                torch.cat([x[1] for x in grads]), None,
                torch.stack([x[2] for x in grads]), None)


# ------------------------------------------------------------ entry points

def _check(impl: str, feat_a: torch.Tensor, feat_b: torch.Tensor) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}: one of {IMPLS}")
    if feat_a.shape != feat_b.shape or feat_a.dim() != 2:
        raise ValueError(f"feat_a and feat_b must be [b, E] alike: "
                         f"{tuple(feat_a.shape)}, {tuple(feat_b.shape)}")


def ring_infonce_local(feat_a: torch.Tensor, feat_b: torch.Tensor,
                       temp: torch.Tensor, idx: Optional[torch.Tensor],
                       mesh: DataMesh, impl: str = "dense") -> torch.Tensor:
    """Bidirectional soft-label InfoNCE of the data ranks' batch from this
    rank's shards feat_a, feat_b [b, E] and ids idx [b] (None: data_rank ·
    b + arange(b)), around the ring of `mesh`'s data group."""
    _check(impl, feat_a, feat_b)
    b = feat_a.shape[0]
    if idx is None:
        idx = mesh.data_rank * b + torch.arange(b, device=feat_a.device)
    temp = sum_grad(torch.as_tensor(temp, dtype=torch.float32,
                                    device=feat_a.device), mesh)
    if impl == "dense":
        inv_temp = 1.0 / temp
        loss_a = _dense_half(feat_a, idx, inv_temp,
                             _p2p_blocks(feat_b, idx, mesh))
        loss_b = _dense_half(feat_b, idx, inv_temp,
                             _p2p_blocks(feat_a, idx, mesh))
    else:
        loss_a = _FusedHalf.apply(feat_a, feat_b, idx, idx, temp, mesh)
        loss_b = _FusedHalf.apply(feat_b, feat_a, idx, idx, temp, mesh)
    return rank_sum(loss_a + loss_b, mesh) / (2.0 * b * mesh.data_world)


class _FanOut(torch.autograd.Function):
    """temp as `world` per-rank copies [W]; their cotangents summed in rank
    order (the replay of `parallel.mesh.sum_grad`)."""

    @staticmethod
    def forward(ctx, temp, world):
        return temp.expand(world).clone()

    @staticmethod
    def backward(ctx, g):
        return g.sum(0), None


def ring_infonce(feat_a: torch.Tensor, feat_b: torch.Tensor,
                 temp: torch.Tensor, idx: Optional[torch.Tensor] = None,
                 world: int = 1, impl: str = "dense") -> torch.Tensor:
    """`ring_infonce_local` over `world` ranks, replayed in one process from
    global feat_a, feat_b [B, E] and ids idx [B] (None: arange(B)); B must
    split into `world` equal shards."""
    _check(impl, feat_a, feat_b)
    n = feat_a.shape[0]
    if n % world:
        raise ValueError(f"batch {n} does not split into {world} shards")
    if idx is None:
        idx = torch.arange(n, device=feat_a.device)
    temps = _FanOut.apply(torch.as_tensor(temp, dtype=torch.float32,
                                          device=feat_a.device), world)
    if impl == "dense":
        qa, qb, ids = feat_a.chunk(world), feat_b.chunk(world), idx.chunk(world)
        inv = [1.0 / temps[r] for r in range(world)]
        halves = []
        for q_side, k_side in ((qa, qb), (qb, qa)):
            held = [x.view_as(x) for x in k_side]
            held_ids = list(ids)
            visits = [[] for _ in range(world)]
            for i in range(world):
                for r in range(world):
                    visits[r].append((held[r], held_ids[r]))
                if i < world - 1:
                    held = _replay_views(held)
                    held_ids = [held_ids[(r - 1) % world]
                                for r in range(world)]
            halves.append([_dense_half(q_side[r], ids[r], inv[r],
                                       iter(visits[r]))
                           for r in range(world)])
        per_rank = torch.stack([la + lb for la, lb in zip(*halves)])
    else:
        per_rank = (_ReplayFusedHalf.apply(feat_a, feat_b, idx, temps, world)
                    + _ReplayFusedHalf.apply(feat_b, feat_a, idx, temps,
                                             world))
    return per_rank.sum(0) / (2.0 * n)
