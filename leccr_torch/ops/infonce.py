"""Fused InfoNCE: the soft-label contrastive loss without its [M, N] logits.

The port of `leccr_tpu/ops/infonce.py`.  The loss needs three statistics
per q row,

    lse_i     = logsumexp_j((q_i · k_j) · inv_temp)
    pos_sum_i = Σ_{j: idx_k[j] == idx_q[i]} (q_i · k_j) · inv_temp
    pos_cnt_i = #{j: idx_k[j] == idx_q[i]}

and loss_i = lse_i − pos_sum_i / max(pos_cnt_i, 1) (the soft labels of
`models.losses.soft_label_contrastive_loss`).  Its gradient is
dq = (w k)·coef·inv_temp and dk = (wᵀ q)·coef·inv_temp with
w = softmax − labels, recomputed tile by tile from lse, as a flash backward
does.  Three hand-written CUDA kernels (`csrc/fused_infonce.cu`) compute
them: kernel 9 the statistics (`infonce_stats`), kernels 10 and 11 the
unscaled dq_raw = w k and dk_raw = wᵀ q (`infonce_bwd_dq`, `infonce_bwd_dk`,
both by `infonce_bwd_raw`).  Each kernel's grid is row tiles × S splits of
the streamed side (`split_plan`, from the shape and the card's SM count);
with S > 1 the blocks write per-split partials to a workspace and a second
small kernel merges them in split order (plain versions:
`merge_stats_partials`, `merge_bwd_partials`), so a call's result is the
same bits every time.

For CUDA tensors the wrappers launch the kernels (or raise); for CPU
tensors they run the plain PyTorch versions (`*_reference`), which stream
512 key columns at a time, so they also run at 32k rows.  Inputs are cast
to f32.  `inv_temp` may be a device tensor, which the kernels read from
device memory: the wrappers never read it back to the host.  Both entry
points take M ≠ N and idx_q ≠ idx_k (a ring block of the multi-device
loss calls them per block).

`stats_launches`, `dq_launches` and `dk_launches` count the launches of
kernels 9, 10 and 11 (one a call, the merge included); `last_grid` keeps
the (row tiles, splits) that each one's last launch ran.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import torch

from leccr_torch.ops import _build

_LIB = "fused_infonce"
BLOCK_K = 512  # key columns per step of the plain versions
SMEM_PER_BLOCK = 232448  # bytes of shared memory a Hopper block may use
# (own rows, streamed rows) of a block's tile and of one streamed tile:
# kernel 9 and kernels 10/11 (`infonce_tile` in csrc/fused_infonce.cu)
STATS_TILE = (128, 128)
BWD_TILE = (64, 64)

stats_launches = 0
dq_launches = 0
dk_launches = 0
last_grid: Dict[str, Tuple[int, int]] = {}

Scalar = Union[float, torch.Tensor]


def _pos(idx_q: torch.Tensor, idx_k: torch.Tensor) -> torch.Tensor:
    return idx_q[:, None] == idx_k[None, :]


def infonce_stats_reference(q, k, idx_q, idx_k, inv_temp: Scalar,
                            block_k: int = BLOCK_K
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of kernel 9 (`_stats_xla`): a running max and
    sum over blocks of `block_k` key columns.  Returns (lse, pos_sum,
    pos_cnt), f32 [M] each."""
    m = q.shape[0]
    mx = torch.full((m,), -torch.inf, device=q.device)
    s = torch.zeros(m, device=q.device)
    ps = torch.zeros(m, device=q.device)
    pc = torch.zeros(m, device=q.device)
    for j0 in range(0, k.shape[0], block_k):
        logits = (q @ k[j0:j0 + block_k].T) * inv_temp
        new_m = torch.maximum(mx, logits.amax(dim=1))
        s = s * torch.exp(mx - new_m) + torch.exp(
            logits - new_m[:, None]).sum(dim=1)
        mx = new_m
        pos = _pos(idx_q, idx_k[j0:j0 + block_k])
        ps = ps + torch.where(pos, logits, 0.0).sum(dim=1)
        pc = pc + pos.sum(dim=1)
    return mx + torch.log(s), ps, pc


def _weights(q, kb, idx_q, idx_kb, inv_temp, lse, inv_pc):
    """w = exp(l − lse) − pos / max(pos_cnt, 1) of q against a key block."""
    w = torch.exp((q @ kb.T) * inv_temp - lse[:, None])
    return w - _pos(idx_q, idx_kb) * inv_pc[:, None]


def infonce_bwd_dq_reference(q, k, idx_q, idx_k, inv_temp: Scalar, lse,
                             pos_cnt, block_k: int = BLOCK_K) -> torch.Tensor:
    """Plain PyTorch version of kernel 10 (`_bwd_raw_xla`'s w k, taken over
    blocks of `block_k` key columns): dq_raw [M, E]."""
    dq = torch.zeros_like(q)
    inv_pc = 1.0 / torch.clamp_min(pos_cnt, 1.0)
    for j0 in range(0, k.shape[0], block_k):
        kb = k[j0:j0 + block_k]
        dq = dq + _weights(q, kb, idx_q, idx_k[j0:j0 + block_k], inv_temp,
                           lse, inv_pc) @ kb
    return dq


def infonce_bwd_dk_reference(q, k, idx_q, idx_k, inv_temp: Scalar, lse,
                             pos_cnt, block_k: int = BLOCK_K) -> torch.Tensor:
    """Plain PyTorch version of kernel 11 (`_bwd_raw_xla`'s wᵀ q, one block
    of `block_k` key rows at a time): dk_raw [N, E]."""
    inv_pc = 1.0 / torch.clamp_min(pos_cnt, 1.0)
    return torch.cat([
        _weights(q, k[j0:j0 + block_k], idx_q, idx_k[j0:j0 + block_k],
                 inv_temp, lse, inv_pc).T @ q
        for j0 in range(0, k.shape[0], block_k)])


def split_plan(rows: int, cols: int, sm_count: int,
               tile: Tuple[int, int]) -> Tuple[int, int]:
    """(splits, tiles a split) of a kernel whose blocks own `tile[0]` of
    `rows` rows and stream `cols` rows in tiles of `tile[1]`: split s takes
    the tiles [s·tiles, (s + 1)·tiles), the last split the rest, so every
    streamed row falls in exactly one split and no split is empty.

    One split where the row tiles alone fill the card's `sm_count` SMs.
    Otherwise at least the splits that give ~2 blocks an SM (as far as the
    streamed tiles go), and among those the fewest that minimise waves ×
    tiles a block: each kernel holds one block an SM (its shared memory),
    so a grid of B blocks runs in ⌈B / sm_count⌉ waves, each as long as a
    block's walk over its tiles."""
    row_tiles = -(-rows // tile[0])
    col_tiles = -(-cols // tile[1])
    if row_tiles >= sm_count:
        return 1, col_tiles
    want = min(col_tiles, max(1, (2 * sm_count + row_tiles // 2) // row_tiles))
    best = None
    for per in range(col_tiles // want, 0, -1):  # ⌈col_tiles / per⌉ ≥ want
        splits = -(-col_tiles // per)
        cost = -(-row_tiles * splits // sm_count) * per
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def merge_stats_partials(partials: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain version of kernel 9's merge: partials [S, 4, M] of (max, sum,
    pos_sum, pos_cnt) over disjoint column splits, merged in split order
    (logaddexp; a split's empty state is max −inf with sum 0), the sums
    and counts added.  Returns (lse, pos_sum, pos_cnt), f32 [M] each."""
    mx = torch.full_like(partials[0, 0], -torch.inf)
    s = torch.zeros_like(mx)
    for om, os in partials[:, :2]:
        new = torch.maximum(mx, om)
        s = torch.where(new == -torch.inf, 0.0,
                        s * torch.exp(mx - new) + os * torch.exp(om - new))
        mx = new
    return mx + torch.log(s), partials[:, 2].sum(0), partials[:, 3].sum(0)


def merge_bwd_partials(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels 10/11's merge: the sum of partials
    [S, rows, E] in split order."""
    out = partials[0].clone()
    for p in partials[1:]:
        out += p
    return out


def _check(q, k, idx_q, idx_k) -> None:
    if q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"q [M, E] and k [N, E] must share E: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if q.shape[0] == 0 or k.shape[0] == 0:
        raise ValueError("infonce needs at least one q and one k row")
    if tuple(idx_q.shape) != q.shape[:1] or tuple(idx_k.shape) != k.shape[:1]:
        raise ValueError(f"idx_q [M] and idx_k [N] must match q and k: "
                         f"{tuple(idx_q.shape)}, {tuple(idx_k.shape)}")
    if not (q.device == k.device == idx_q.device == idx_k.device):
        raise ValueError("q, k and the ids must lie on one device")


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.infonce_stats.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.infonce_tile.argtypes = [i32, i32]
        lib.infonce_tile.restype = i32
        for which, tile in enumerate((STATS_TILE, BWD_TILE)):
            built = (lib.infonce_tile(which, 0), lib.infonce_tile(which, 1))
            if built != tile:
                raise RuntimeError(f"{_LIB} tiles {built} are not the "
                                   f"wrapper's {tile}")
        lib.infonce_stats.argtypes = [ptr] * 5 + [i32] * 5 + [ptr] * 5
        lib.infonce_bwd_dq.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 3
        lib.infonce_bwd_dk.argtypes = lib.infonce_bwd_dq.argtypes
        for fn in (lib.infonce_stats, lib.infonce_bwd_dq, lib.infonce_bwd_dk,
                   lib.infonce_max_dim):
            fn.restype = i32
        lib.infonce_smem_bytes.argtypes = [i32, i32]
        lib.infonce_smem_bytes.restype = ctypes.c_size_t
    return lib


def _operands(q, k, idx_q, idx_k, inv_temp):
    """The library, with q and k as 16-byte aligned contiguous f32, the ids
    as contiguous int32 and inv_temp as one f32 on the card, after checking
    what the kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"no fused InfoNCE kernel for {q.device}")
    lib = _lib()
    e = q.shape[1]
    if e % 4 or e > lib.infonce_max_dim():
        raise ValueError(f"the fused InfoNCE kernels take E a multiple of 4 "
                         f"up to {lib.infonce_max_dim()}, not {e}")
    for which in (0, 1):
        smem = lib.infonce_smem_bytes(which, e)
        if smem > SMEM_PER_BLOCK:
            raise ValueError(f"fused InfoNCE launch {which} at E={e} needs "
                             f"{smem} bytes of shared memory, more than the "
                             f"{SMEM_PER_BLOCK} a block may use")

    def aligned(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    invt = torch.as_tensor(inv_temp, dtype=torch.float32,
                           device=q.device).reshape(1).contiguous()
    return (lib, aligned(q), aligned(k),
            idx_q.to(torch.int32).contiguous(),
            idx_k.to(torch.int32).contiguous(), invt)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused InfoNCE {what} kernel launch failed: "
                           f"CUDA error {rc}")


def _grid(which: str, rows: int, cols: int, device, tile, part_shape):
    """(splits, tiles a split, workspace) of a launch: its split plan on
    this card, and the f32 partials [splits, *part_shape] (None at one
    split); records (row tiles, splits) in `last_grid`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits, tiles = split_plan(rows, cols, sms, tile)
    last_grid[which] = (-(-rows // tile[0]), splits)
    part = (torch.empty((splits, *part_shape), dtype=torch.float32,
                        device=device) if splits > 1 else None)
    return splits, tiles, part


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_stats(q, k, idx_q, idx_k, inv_temp):
    global stats_launches
    lib, q, k, iq, ik, invt = _operands(q, k, idx_q, idx_k, inv_temp)
    (m, e), n = q.shape, k.shape[0]
    out = torch.empty((3, m), dtype=torch.float32, device=q.device)
    splits, tiles, part = _grid("stats", m, n, q.device, STATS_TILE, (4, m))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.infonce_stats(q.data_ptr(), k.data_ptr(), iq.data_ptr(),
                               ik.data_ptr(), invt.data_ptr(), m, n, e,
                               splits, tiles, _ptr(part), out[0].data_ptr(),
                               out[1].data_ptr(), out[2].data_ptr(), stream)
    _raise_on(rc, "stats")
    stats_launches += 1
    return out[0], out[1], out[2]


def _launch_bwd(q, k, idx_q, idx_k, inv_temp, lse, pos_cnt, which: str):
    """Kernel 10 (which "dq": dq_raw [M, E]) or 11 ("dk": dk_raw [N, E])."""
    global dq_launches, dk_launches
    lib, q, k, iq, ik, invt = _operands(q, k, idx_q, idx_k, inv_temp)
    lse = lse.float().contiguous()
    pos_cnt = pos_cnt.float().contiguous()
    (m, e), n = q.shape, k.shape[0]
    out = torch.empty_like(q if which == "dq" else k)
    fn = lib.infonce_bwd_dq if which == "dq" else lib.infonce_bwd_dk
    own, other = (m, n) if which == "dq" else (n, m)
    splits, tiles, part = _grid(which, own, other, q.device, BWD_TILE,
                                (own, e))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), iq.data_ptr(), ik.data_ptr(),
                invt.data_ptr(), lse.data_ptr(), pos_cnt.data_ptr(), m, n, e,
                splits, tiles, _ptr(part), out.data_ptr(), stream)
    _raise_on(rc, which)
    if which == "dq":
        dq_launches += 1
    else:
        dk_launches += 1
    return out


def infonce_stats(q: torch.Tensor, k: torch.Tensor, idx_q: torch.Tensor,
                  idx_k: torch.Tensor, inv_temp: Scalar
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lse, pos_sum, pos_cnt), f32 [M] each, of q [M, E] against every
    row of k [N, E]: kernel 9 on CUDA tensors, its plain version on CPU
    tensors.  idx_q [M], idx_k [N]: integer ids (equal ids are positives);
    inv_temp: a float or a one-element tensor."""
    _check(q, k, idx_q, idx_k)
    q, k = q.float(), k.float()
    if q.device.type == "cpu":
        return infonce_stats_reference(q, k, idx_q, idx_k, inv_temp)
    return _launch_stats(q, k, idx_q, idx_k, inv_temp)


def _bwd(q, k, idx_q, idx_k, inv_temp, lse, pos_cnt, which: str):
    _check(q, k, idx_q, idx_k)
    q, k = q.float(), k.float()
    if lse.shape != q.shape[:1] or pos_cnt.shape != q.shape[:1]:
        raise ValueError(f"lse and pos_cnt must be [M] = {q.shape[0]}")
    if q.device.type == "cpu":
        plain = (infonce_bwd_dq_reference if which == "dq"
                 else infonce_bwd_dk_reference)
        return plain(q, k, idx_q, idx_k, inv_temp, lse.float(),
                     pos_cnt.float())
    return _launch_bwd(q, k, idx_q, idx_k, inv_temp, lse, pos_cnt, which)


def infonce_bwd_dq(q, k, idx_q, idx_k, inv_temp: Scalar, lse, pos_cnt
                   ) -> torch.Tensor:
    """dq_raw = w k [M, E]: kernel 10 on CUDA tensors, its plain version on
    CPU tensors.  Arguments as `infonce_bwd_raw`."""
    return _bwd(q, k, idx_q, idx_k, inv_temp, lse, pos_cnt, "dq")


def infonce_bwd_dk(q, k, idx_q, idx_k, inv_temp: Scalar, lse, pos_cnt
                   ) -> torch.Tensor:
    """dk_raw = wᵀ q [N, E]: kernel 11 on CUDA tensors, its plain version
    on CPU tensors.  Arguments as `infonce_bwd_raw`."""
    return _bwd(q, k, idx_q, idx_k, inv_temp, lse, pos_cnt, "dk")


def infonce_bwd_raw(q: torch.Tensor, k: torch.Tensor, idx_q: torch.Tensor,
                    idx_k: torch.Tensor, inv_temp: Scalar, lse: torch.Tensor,
                    pos_cnt: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled (dq_raw [M, E], dk_raw [N, E]) = (w k, wᵀ q) with
    w = softmax − labels, from `infonce_stats`' lse and pos_cnt: kernels 10
    and 11 on CUDA tensors, their plain versions on CPU tensors.  Callers
    apply the cotangent and the 1/temp scale."""
    return (infonce_bwd_dq(q, k, idx_q, idx_k, inv_temp, lse, pos_cnt),
            infonce_bwd_dk(q, k, idx_q, idx_k, inv_temp, lse, pos_cnt))


class _HalfLoss(torch.autograd.Function):
    """mean_i(lse_i − pos_sum_i / max(pos_cnt_i, 1)) of q against k, with
    the JAX `_half_loss`'s hand VJP (kernels 10/11 in the backward)."""

    @staticmethod
    def forward(ctx, q, k, idx_q, idx_k, temp):
        inv_temp = 1.0 / temp
        lse, ps, pc = infonce_stats(q, k, idx_q, idx_k, inv_temp)
        ctx.save_for_backward(q, k, idx_q, idx_k, temp, lse, pc)
        return torch.mean(lse - ps / torch.clamp_min(pc, 1.0))

    @staticmethod
    def backward(ctx, g):
        q, k, idx_q, idx_k, temp, lse, pc = ctx.saved_tensors
        inv_temp = 1.0 / temp
        coef = g / q.shape[0]  # d(mean) / d(row)
        dq_raw, dk_raw = infonce_bwd_raw(q, k, idx_q, idx_k, inv_temp, lse,
                                         pc)
        scale = coef * inv_temp
        # dq_raw_i · q_i = Σ_j w_ij (q_i · k_j): the temperature's cotangent
        # falls out of dq_raw (`_bwd_pallas`, infonce.py:360-370)
        d_temp = -coef * torch.sum(dq_raw * q) * inv_temp * inv_temp
        return dq_raw * scale, dk_raw * scale, None, None, d_temp


def infonce_loss(feat_a: torch.Tensor, feat_b: torch.Tensor,
                 temp: torch.Tensor, idx: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Bidirectional soft-label InfoNCE through the fused kernels: equals
    `models.losses.soft_label_contrastive_loss(feat_a, feat_b, temp, idx)`
    without the [B, B] logits.  feat_a, feat_b: [B, E]; temp: a scalar
    tensor; idx: [B] ids (None: every row its own id)."""
    a, b = feat_a.float(), feat_b.float()
    if idx is None:
        idx = torch.arange(a.shape[0], device=a.device)
    temp = torch.as_tensor(temp, dtype=torch.float32, device=a.device)
    la = _HalfLoss.apply(a, b, idx, idx, temp)
    lb = _HalfLoss.apply(b, a, idx, idx, temp)
    return (la + lb) / 2.0
