"""Flash tower attention (training) for the CLIP and BERT towers.

The port of `leccr_tpu/ops/flash_attention.py`'s three regimes:
hand-written CUDA kernels compute softmax(q kᵀ/√d + mask) with dropout on
the probabilities, times v, and its backward, keeping the scores,
probabilities and dropout mask on chip.  The forward saves the row
logsumexp; the backward recomputes the probabilities from it and
regenerates the dropout mask from the seed.

`flash_tower_attention` dispatches as the JAX function does (`_flash_fwd`,
see `regime`): shapes within `fits_vmem` take the single-block kernels 2
and 3 (`csrc/flash_tower_attention.cu`), longer ones within `fits_chunked`
the chunked kernels 4 and 5 (`csrc/flash_chunked_attention.cu`), and
longer ones still (past 2560 tokens in bf16 and 1408 in f32 at an even
head count and Dh = 64) the tiled kernels 6, 7 and 8
(`csrc/flash_tiled_attention.cu`).  The regimes differ on purpose, as in
the JAX package:

- single-block: padded keys score f32 min, so a fully padded row gives the
  mean of v; dropout hashes the counter `h·Lq·Lk + i·Lk + j`;
- chunked: keys stream in 128-key tiles with a running max, padded keys
  score −inf, so a fully padded row gives out 0, lse −inf and zero
  gradients; the unnormalised probabilities are rounded to the input
  dtype per key tile; dropout hashes per (head group, q tile, k tile)
  (`_tile_keep_from`); the backward takes delta = rowsum(g·out) from the
  rounded output.
- tiled: the chunked regime's arithmetic and rounding points, but the
  dropout hash's head group is `head_group(H)` (the largest divisor of H
  that is ≤ 8) instead of `chunk_head_group(H)` (2 or 1); its backward is
  a dq pass (kernel 7, which also writes delta) and a dk/dv pass (kernel
  8), each launched and counted on its own.

The hashes are the JAX package's interpret-mode ones, keyed by the
per-example seeds `seed + b · 0x9E3779B9` (int32 wrap) and finished by the
murmur3 finalizer, keep where the hash ≥ uint32(rate · 2³²), scaled by
1/(1−rate).  So the port's masks equal the JAX kernels' in interpret mode
bit for bit (the TPU's hardware bits are another stream, which nothing
reproduces).

Kernels 2/3 have two bodies (`single_block_variant`): Hopper ones
(wgmma and TMA, persistent; the backward one launch of one pass) for bf16
at Dh = 64 with TMA-eligible views and at most TC_MAX_KEYS keys, every
call of the train steps, and scalar f32 FMA for f32, other head dims,
unaligned views and longer keys.  The streamed forwards (kernels 4 and
6) and the tiled backward (kernels 7/8) likewise (`tiled_variant`): warp-specialised wgmma bodies fed
by TMA for bf16 at Dh = 64 with 16-byte aligned rows and outer strides,
the scalar bodies otherwise; the chunked backward (kernel 5) runs the same
wgmma passes as kernels 7/8 for the same views, at its own head group,
on their persistent schedule (`tiled_variant` of q, k, v, g and out).
The choice is made from the shapes before the launch; a launch that fails
raises and is never retried on the other body.

For CUDA tensors the wrappers launch the kernels (or raise); for CPU
tensors they run the plain PyTorch versions (`*_reference`), which do the
same f32 arithmetic with the same rounding points (the backwards are the
hand VJPs of the TPU kernels, not autograd through the forward).

Tensor parallelism (`parallel/tensor.py`): a rank holds heads
[h0, h0 + h) of a layer's H.  Every function here then takes
`head_offset=h0` and `num_heads=H`: the regime is decided on H (so a local
h of 4 keeps a ViT-L/14 @336 layer chunked), the masks hash the absolute
head h0 + h, and the streamed regimes' head group is that of H, which need
not divide h (it appears in the hash only; no grid or loop groups the
call's heads by it).  So rank m's output and gradients on its heads equal
those heads of the dense call.  With h0 = 0 and H = h every call is the
one it was.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from leccr_torch.ops import _build
from leccr_torch.ops.dropout import FlashSeed, staged

_LIB = "flash_tower_attention"
_CHUNK_LIB = "flash_chunked_attention"
_TILED_LIB = "flash_tiled_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = torch.finfo(torch.float32).min
WARPS = 8  # warps per scalar block; each owns one row at a time
ROWS = 64  # query rows of one scalar block's tile
TC_MAX_KEYS = 192  # keys whose scores the Hopper forward holds per row
SMEM_PER_BLOCK = 232448  # bytes of shared memory a Hopper block may use
# The grid of kernels 7/8's wgmma passes: persistent (a block per SM walking
# the 128-row items) or one block per item.  Fixed from both schedules'
# times at the high-resolution step's [8, 16, 2705, 64] on the H100
# (chip_smoke.py's tiled_phase, PERF.md); kernel 5 is always persistent.
TILED_BWD_PERSISTENT = True

# the JAX single-block kernel's VMEM budget (flash_attention.py:37)
_VMEM_BUDGET = 10 * 2 ** 20


def fits_vmem(h: int, lq: int, lk: int, d: int) -> bool:
    """Whether the JAX package takes its single-block kernels for this
    shape (a copy of `leccr_tpu.ops.flash_attention.fits_vmem`): up to 5
    live [H, Lq, Lk] f32 tiles plus 7 [H, L, D] operand tiles in 10 MiB."""
    tiles = 5 * h * lq * lk * 4
    qkv = 7 * h * max(lq, lk) * d * 4
    return tiles + qkv <= _VMEM_BUDGET


CHUNK = 128  # keys (and query rows) of one chunked tile: the JAX _CHUNK


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def chunk_head_group(h: int) -> int:
    """Heads per program of the JAX chunked kernels (a copy of
    `_chunk_head_group`): the dropout mask hashes the head group and the
    head within it."""
    return 2 if h % 2 == 0 else 1


def head_group(h: int) -> int:
    """Heads per program of the JAX tiled kernels (a copy of
    `_head_group`): the largest divisor of h that is ≤ 8 (16 → 8, 12 → 6,
    3 → 3).  The tiled dropout mask hashes the group and the head within
    it."""
    for hg in (8, 7, 6, 5, 4, 3, 2, 1):
        if h % hg == 0:
            return hg
    return 1


def _chunk_budget(h: int, lq: int, lk: int, d: int, itemsize: int) -> int:
    """A copy of the JAX package's calibrated chunked VMEM budget: the
    q, k, v, g, dk, dv blocks at the io dtype plus the f32 dq block, twice,
    and six f32 [hg, 128, 128] temporaries, five times."""
    hg = chunk_head_group(h)
    lqp, lkp = _round_up(lq, CHUNK), _round_up(lk, CHUNK)
    refs = (6 * itemsize + 4) * hg * max(lqp, lkp) * d
    temps = 6 * hg * CHUNK * CHUNK * 4
    return 5 * temps + 2 * refs


def fits_chunked(h: int, lq: int, lk: int, d: int,
                 itemsize: int = 2) -> bool:
    """Whether the JAX package takes its chunked kernels for a shape past
    `fits_vmem` (a copy of `leccr_tpu.ops.flash_attention.fits_chunked`):
    f32 (itemsize 4) reaches the limit at shorter lengths than bf16."""
    return _chunk_budget(h, lq, lk, d, itemsize) <= 14 * 2 ** 20


def _layer_heads(q: torch.Tensor, head_offset: int,
                 num_heads: Optional[int]) -> Tuple[int, int]:
    """(h0, H): the absolute index of q's first head and the layer's head
    count (q's own when `num_heads` is None), checked to hold q's heads."""
    h = q.shape[1]
    total = h if num_heads is None else int(num_heads)
    h0 = int(head_offset)
    if h0 < 0 or h0 + h > total:
        raise ValueError(f"heads [{h0}, {h0 + h}) are not among a layer's "
                         f"{total}")
    return h0, total


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²): split c in 16-bit halves so
    that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return _u32(x * lo + (_u32(x * hi) & 0xFFFF) * 65536)


def keep_mask(seed: int, b: int, h: int, lq: int, lk: int, rate: float,
              device=None, h0: int = 0) -> torch.Tensor:
    """The dropout factor [B, H, Lq, Lk] in {0, 1/(1-rate)} (f32): the hash
    both kernels compute inline, in plain PyTorch (uint32 arithmetic
    carried in int64).  h0: the absolute index of the first of the h
    heads (a tensor-parallel rank's slice of a layer's heads)."""
    ctr = torch.arange(h0 * lq * lk, (h0 + h) * lq * lk, dtype=torch.int64,
                       device=device)
    x = _u32(ctr[None, :] + _seed_terms(seed, b, device)[:, None])
    return _keep_factor(x, rate).view(b, h, lq, lk)


def _seed_terms(seed: int, b: int, device) -> torch.Tensor:
    """seed_b · 0x9E3779B9 (mod 2³²) of the per-example seeds seed_b =
    seed + b · 0x9E3779B9, as int64 [B]."""
    seeds = _u32(int(seed) + _mul_u32(
        torch.arange(b, dtype=torch.int64, device=device), 0x9E3779B9))
    return _mul_u32(seeds, 0x9E3779B9)


def _keep_factor(x: torch.Tensor, rate: float) -> torch.Tensor:
    """The murmur3 finalizer of uint32 counters x (carried in int64), then
    the dropout factor in {0, 1/(1-rate)} (f32)."""
    x = _mul_u32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul_u32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    keep = x >= int(rate * 4294967296.0)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return keep.to(torch.float32) * scale.to(x.device)


def tile_keep_mask(seed: int, b: int, h: int, lq: int, lk: int, rate: float,
                   device=None, hg: Optional[int] = None,
                   h0: int = 0) -> torch.Tensor:
    """The streamed kernels' dropout factor [B, H, Lq, Lk] in {0,
    1/(1-rate)} (f32): the JAX interpret-mode tile hash (`_tile_keep_from`)
    of element (b, h, i, j) in head group hi = h // hg (hh = h % hg), query
    tile i // 128 and key tile j // 128, computed in plain PyTorch.  hg:
    heads per group, `chunk_head_group(H)` (the chunked kernels, the
    default) or `head_group(H)` (the tiled ones) of the layer's H heads.
    h0: the absolute index of the first of the h heads; hg need not divide
    h."""
    if hg is None:
        hg = chunk_head_group(h)

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    heads, rows, cols = ar(h) + h0, ar(lq), ar(lk)
    ctr = ((heads % hg) * CHUNK * CHUNK)[:, None, None] + (
        (rows % CHUNK) * CHUNK)[None, :, None] + (cols % CHUNK)[None, None, :]
    tiles = (_mul_u32(heads // hg, 0x27D4EB2F)[:, None, None]
             + _mul_u32(rows // CHUNK, 0x85EBCA77)[None, :, None]
             + _mul_u32(cols // CHUNK, 0xC2B2AE3D)[None, None, :])
    x = _u32(_u32(ctr + tiles)[None]
             + _seed_terms(seed, b, device)[:, None, None, None])
    return _keep_factor(x, rate)


def _scores(q, k, padding_mask):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (1.0 / (q.shape[-1] ** 0.5))
    if padding_mask is not None:
        s = torch.where((padding_mask != 0)[:, None, None, :], _NEG, s)
    return s


def flash_tower_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    seed: int,
    dropout_rate: float = 0.0,
    head_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel.

    q: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh]; padding_mask: [B, Lk]
    (nonzero = padding) or None; head_offset: the absolute index of q's
    first head.  Returns (out [B, H, Lq, Dh] in q's dtype, lse [B, H, Lq]
    f32)."""
    s = _scores(q, k, padding_mask)
    smax = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - smax)
    denom = p.sum(dim=-1, keepdim=True)
    lse = (smax + torch.log(denom))[..., 0]
    p = p / denom
    if dropout_rate > 0.0:
        p = p * keep_mask(seed, *p.shape, dropout_rate, device=p.device,
                          h0=head_offset)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_tower_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    lse: torch.Tensor,
    g: torch.Tensor,
    seed: int,
    dropout_rate: float = 0.0,
    head_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: the TPU kernel's hand
    VJP (probabilities recomputed from lse, the mask regenerated, Σ dp∘p as
    the softmax correction).  Returns (dq, dk, dv) in the inputs' dtype."""
    dt = q.dtype
    s = _scores(q, k, padding_mask)
    p = torch.exp(s - lse[..., None])
    keep = None
    pd = p
    if dropout_rate > 0.0:
        keep = keep_mask(seed, *p.shape, dropout_rate, device=p.device,
                         h0=head_offset)
        pd = p * keep
    gf = g.float()
    dv = torch.matmul(pd.to(dt).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    if keep is not None:
        dp = dp * keep
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * (1.0 / (q.shape[-1] ** 0.5))).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _chunk_scores(q, k, padding_mask):
    """f32 scores with padded keys at −inf (the chunked regime)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (1.0 / (q.shape[-1] ** 0.5))
    if padding_mask is not None:
        s = torch.where((padding_mask != 0)[:, None, None, :], -math.inf, s)
    return s


def _streamed_fwd_reference(q, k, v, padding_mask, seed, dropout_rate, hg,
                            h0=0):
    """The streamed regimes' forward (kernels 4 and 6): a loop over 128-key
    tiles with a running max, the unnormalised probabilities rounded to v's
    dtype per tile, the dropout mask (head group hg, first head h0) applied
    after the running sum, −inf key padding.  A row with no key gets out 0
    and lse −inf."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    keep = (tile_keep_mask(seed, b, h, lq, lk, dropout_rate,
                           device=q.device, hg=hg, h0=h0)
            if dropout_rate > 0.0 else None)
    qf = q.float()
    m = torch.full((b, h, lq), -math.inf, device=q.device)
    ssum = torch.zeros((b, h, lq), device=q.device)
    o = torch.zeros((b, h, lq, d), device=q.device)
    for j0 in range(0, lk, CHUNK):
        cols = slice(j0, j0 + CHUNK)
        s = torch.matmul(qf, k[:, :, cols].float().transpose(-1, -2)) * scale
        if padding_mask is not None:
            s = torch.where((padding_mask[:, cols] != 0)[:, None, None, :],
                            -math.inf, s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - safe_m[..., None]),
                        0.0)
        ssum = ssum * alpha + p.sum(dim=-1)
        if keep is not None:
            p = p * keep[..., cols]
        o = o * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                v[:, :, cols].float())
        m = m_new
    safe = torch.where(ssum > 0, ssum, 1.0)
    out = (o / safe[..., None]).to(q.dtype)
    lse = torch.where(ssum > 0, m + torch.log(safe), -math.inf)
    return out, lse


def flash_chunked_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    seed: int,
    dropout_rate: float = 0.0,
    head_offset: int = 0,
    num_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the chunked forward kernel (kernel 4): the
    JAX `_chunk_fwd_kernel`'s loop over 128-key tiles with a running max,
    the unnormalised probabilities rounded to v's dtype per tile, the
    dropout mask applied after the running sum, −inf key padding.

    Shapes as `flash_tower_attention_fwd_reference`.  Returns (out
    [B, H, Lq, Dh] in q's dtype, lse [B, H, Lq] f32); a row with no key gets
    out 0 and lse −inf."""
    h0, total = _layer_heads(q, head_offset, num_heads)
    return _streamed_fwd_reference(q, k, v, padding_mask, seed, dropout_rate,
                                   chunk_head_group(total), h0)


def _streamed_grad_terms(q, k, v, padding_mask, lse, delta, g, seed,
                         dropout_rate, hg, h0=0):
    """The streamed regimes' backward terms per (query, key): p = exp(s −
    lse) (0 where s or lse is −inf), pd = p·keep and ds = p·(dp − delta)·
    scale with dp = (g·v)·keep, ds rounded to k's dtype.  Returns (pd, ds)
    in f32."""
    s = _chunk_scores(q, k, padding_mask)
    p = torch.where(torch.isfinite(s) & torch.isfinite(lse)[..., None],
                    torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    pd = p
    if dropout_rate > 0.0:
        keep = tile_keep_mask(seed, *p.shape, dropout_rate, device=p.device,
                              hg=hg, h0=h0)
        pd, dp = p * keep, dp * keep
    ds = p * (dp - delta[..., None]) * (1.0 / (q.shape[-1] ** 0.5))
    return pd, ds.to(k.dtype).float()


def _delta(out, g):
    """rowsum(g·out) in f32 from the forward's rounded output."""
    return (g.float() * out.float()).sum(dim=-1)


def flash_chunked_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    seed: int,
    dropout_rate: float = 0.0,
    head_offset: int = 0,
    num_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the chunked backward kernel (kernel 5): the
    JAX `_chunk_bwd_kernel`'s hand VJP with delta = rowsum(g·out) from the
    forward's rounded output, p = exp(s − lse) (0 where s or lse is −inf),
    pd rounded to g's dtype for dv, ds rounded to k's dtype, and dq, dk, dv
    summed in f32 and rounded once.  The TPU kernel's tiles change only the
    order of those f32 sums (the tile mask depends on the element, not the
    tiling), so this version takes whole rows.  Returns (dq, dk, dv)."""
    dt = q.dtype
    h0, total = _layer_heads(q, head_offset, num_heads)
    pd, ds = _streamed_grad_terms(q, k, v, padding_mask, lse, _delta(out, g),
                                  g, seed, dropout_rate,
                                  chunk_head_group(total), h0)
    dv = torch.matmul(pd.to(g.dtype).float().transpose(-1, -2), g.float())
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_tiled_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    seed: int,
    dropout_rate: float = 0.0,
    head_offset: int = 0,
    num_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the tiled forward kernel (kernel 6): the
    JAX `_tiled_fwd_kernel` over the (q tile, k tile) grid, its m, s and o
    scratch carried along the key axis: the chunked forward's arithmetic
    with the tile mask at `head_group(H)`.  The JAX caller pads both
    sequences to 128-multiples (`_flash_fwd:839-850`) with padded keys
    masked and padded query rows sliced off; a masked key scores −inf and
    adds nothing to any tile (p = 0, the max unchanged) and the mask hashes
    absolute indices, so this version takes the unpadded sequences.
    Returns (out [B, H, Lq, Dh] in q's dtype, lse [B, H, Lq] f32); a row
    with no key gets out 0 and lse −inf."""
    h0, total = _layer_heads(q, head_offset, num_heads)
    return _streamed_fwd_reference(q, k, v, padding_mask, seed, dropout_rate,
                                   head_group(total), h0)


def flash_tiled_attention_dq_reference(q, k, v, padding_mask, out, lse, g,
                                       seed: int, dropout_rate: float = 0.0,
                                       head_offset: int = 0,
                                       num_heads: Optional[int] = None):
    """Plain PyTorch version of the tiled dq kernel (kernel 7, JAX
    `_tiled_dq_kernel` with delta = rowsum(g·out) from `_flash_bwd:873`):
    ds rounded to k's dtype, dq summed in f32 over the key tiles and
    rounded once.  A padded query row of the JAX caller has g = 0, hence
    ds = 0.  Returns (dq in q's dtype, delta [B, H, Lq] f32)."""
    delta = _delta(out, g)
    h0, total = _layer_heads(q, head_offset, num_heads)
    _, ds = _streamed_grad_terms(q, k, v, padding_mask, lse, delta, g, seed,
                                 dropout_rate, head_group(total), h0)
    return torch.matmul(ds, k.float()).to(q.dtype), delta


def flash_tiled_attention_dkv_reference(q, k, v, padding_mask, lse, delta, g,
                                        seed: int, dropout_rate: float = 0.0,
                                        head_offset: int = 0,
                                        num_heads: Optional[int] = None):
    """Plain PyTorch version of the tiled dk/dv kernel (kernel 8, JAX
    `_tiled_dkv_kernel`): pd rounded to g's dtype for dv, ds to q's for dk,
    both summed in f32 over the query tiles and rounded once.  delta: kernel
    7's.  Returns (dk, dv) in k's dtype."""
    h0, total = _layer_heads(q, head_offset, num_heads)
    pd, ds = _streamed_grad_terms(q, k, v, padding_mask, lse, delta, g, seed,
                                  dropout_rate, head_group(total), h0)
    dv = torch.matmul(pd.to(g.dtype).float().transpose(-1, -2), g.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_tiled_attention_bwd_reference(q, k, v, padding_mask, out, lse, g,
                                        seed: int, dropout_rate: float = 0.0,
                                        head_offset: int = 0,
                                        num_heads: Optional[int] = None):
    """Plain PyTorch version of the tiled backward (kernels 7 then 8).
    Returns (dq, dk, dv)."""
    dq, delta = flash_tiled_attention_dq_reference(
        q, k, v, padding_mask, out, lse, g, seed, dropout_rate, head_offset,
        num_heads)
    dk, dv = flash_tiled_attention_dkv_reference(
        q, k, v, padding_mask, lse, delta, g, seed, dropout_rate,
        head_offset, num_heads)
    return dq, dk, dv


def _check(q, k, v, padding_mask, dropout_rate) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, Dh]")
    b, h, lq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[2] == 0:
        raise ValueError("no keys to attend over (Lk == 0)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("q, k, v must share one dtype, float32 or bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last (feature) dim")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if padding_mask is not None:
        if tuple(padding_mask.shape) != (b, k.shape[2]):
            raise ValueError(f"padding_mask must be [B, Lk] = "
                             f"{(b, k.shape[2])}, got "
                             f"{tuple(padding_mask.shape)}")
        if padding_mask.device != q.device:
            raise ValueError("padding_mask must lie on q's device")


def regime(q: torch.Tensor, k: torch.Tensor,
           num_heads: Optional[int] = None) -> str:
    """The JAX dispatch (`_flash_fwd`, `_flash_bwd`): "single" within
    `fits_vmem` (kernels 2/3), "chunked" within `fits_chunked` at q's
    element size (kernels 4/5), "tiled" past both (kernels 6–8).  Both
    budgets key on max(Lq, Lk) rounded up to 128.  num_heads: the layer's
    head count H when q holds a slice of its heads (decided on H)."""
    _, h, lq, dh = q.shape
    if num_heads is not None:
        h = int(num_heads)
    lk = k.shape[2]
    if fits_vmem(h, lq, lk, dh):
        return "single"
    if fits_chunked(h, lq, lk, dh, q.element_size()):
        return "chunked"
    return "tiled"


def single_block_variant(q: torch.Tensor, k: torch.Tensor,
                         *others: torch.Tensor) -> str:
    """Which body kernels 2/3 run a call on, from the shapes alone:
    "wgmma" (the Hopper kernels) for bf16 at Dh = 64 when q, k and
    `others` (v; g for the backward) are all `tma_eligible` and Lk ≤
    TC_MAX_KEYS (every train-step call: 168 keys is the longest
    self-attention within `fits_vmem` at 12 heads; queries stream, so Lq is
    free); "scalar" otherwise (f32, whose 1e-5 tolerance TF32 would break,
    other head dims, views TMA cannot read and longer keys, where the
    scalar kernels raise if their shared memory does not fit)."""
    dh = q.shape[-1]
    lk = k.shape[2]
    if q.dtype != torch.bfloat16 or dh != 64 or lk > TC_MAX_KEYS:
        return "scalar"
    if not all(tma_eligible(t) for t in (q, k, *others)):
        return "scalar"
    return "wgmma"


_TMA_MAX_STRIDE = 2 ** 40  # bytes: a TMA map's outer strides stay below


def tma_eligible(t: torch.Tensor) -> bool:
    """Whether a [B, H, L, Dh] tensor's rows can be a TMA map's boxes:
    a 16-byte aligned base, a unit feature stride, Dh spanning whole
    16-byte words, and positive outer strides that are 16-byte multiples
    below 2⁴⁰ bytes."""
    item = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and t.shape[-1] * item % 16 == 0
            and all(0 < st * item < _TMA_MAX_STRIDE and st * item % 16 == 0
                    for st in t.stride()[:3]))


def tiled_variant(q: torch.Tensor, k: torch.Tensor,
                  *others: torch.Tensor) -> str:
    """Which body the streamed forwards (kernels 4 and 6) and the streamed
    backwards (kernel 5, kernels 7/8) run a call on, from the shapes alone:
    "wgmma" for bf16 at Dh = 64 when q, k and `others` (v for a forward;
    v, g and out for kernel 5 and kernel 7, whose delta reads out by TMA;
    v, g for kernel 8) are all `tma_eligible` (every call of the
    long-sequence and high-resolution steps), "scalar" otherwise (f32,
    other head dims, unaligned views)."""
    if q.dtype != torch.bfloat16 or q.shape[-1] != 64:
        return "scalar"
    return ("wgmma" if all(tma_eligible(t) for t in (q, k, *others))
            else "scalar")


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.fta_forward.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        f32 = ctypes.c_float
        # score scale, seed slot, threshold, keep scale, dropout, h0
        drop = [f32, ptr, u32, f32, i32, i32]
        tail = drop + [i32, i32, i32, ptr]
        lib.fta_forward.argtypes = [ptr] * 6 + [i32] * 6 + [ptr] + tail
        lib.fta_backward.argtypes = [ptr] * 10 + [i32] * 6 + [ptr] + tail
        wgmma_tail = [i32] * 4 + [ptr] + drop + [ptr]
        lib.fta_wgmma_forward.argtypes = [ptr] * 6 + wgmma_tail
        lib.fta_wgmma_backward.argtypes = [ptr] * 9 + wgmma_tail
        for fn in (lib.fta_forward, lib.fta_backward, lib.fta_wgmma_forward,
                   lib.fta_wgmma_backward):
            fn.restype = i32
        lib.fta_smem_bytes.argtypes = [i32] * 5
        lib.fta_smem_bytes.restype = ctypes.c_size_t
        lib.fta_wgmma_smem_bytes.argtypes = [i32] * 2
        lib.fta_wgmma_smem_bytes.restype = ctypes.c_size_t
        lib.fta_supported_dim.argtypes = [i32]
        lib.fta_supported_dim.restype = i32
    return lib


def _heads_last(b, l, h, dh, like) -> torch.Tensor:
    """An empty [B, H, L, Dh] view of [B, L, H, Dh] storage: merging the
    heads afterwards (transpose(1, 2).reshape) is then free."""
    return torch.empty((b, l, h, dh), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _aligned(tensors, item) -> bool:
    """16-byte loads need 16-byte aligned rows spanning whole words."""
    return all(t.data_ptr() % 16 == 0
               and all(st * item % 16 == 0 for st in t.stride()[:3])
               for t in tensors) and tensors[0].shape[-1] * item % 16 == 0


def _dropout_args(seed, rate, h0=0):
    """The kernels' dropout arguments: the seed as uint32, the keep
    threshold uint32(rate · 2³²), the f32 scale 1/(1−rate), whether
    dropout is on, and the absolute index h0 of the call's first head."""
    return (int(seed) & 0xFFFFFFFF, int(rate * 4294967296.0),
            float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)),
            int(rate > 0.0), int(h0))


def _streamed_dropout_args(seed, rate, h0=0):
    """`_dropout_args` of kernels 4-8, which take the seed by value, so a
    CUDA graph would replay the captured one: a call with dropout on
    counts in `flash_tower_attention.by_value_seed_launches` (the train
    step keeps such a step eager), and raises during a capture."""
    if rate > 0.0:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("kernels 4-8 take their dropout seed by "
                               "value: not capturable in a CUDA graph")
        flash_tower_attention.by_value_seed_launches += 1
    return _dropout_args(seed, rate, h0)


def _prepare(q, k, seed, rate, launches, h0=0):
    """The loaded library, the score scale and the dropout arguments of a
    call, after checking the head dim and the shared memory of each of the
    scalar kernels' `launches` (0: forward, 1: backward dq pass, 2:
    backward dk/dv pass; none on the "wgmma" variant, whose shared memory
    fits a block at every key count it takes: csrc/flash_single_layout.h
    asserts it).  Kernels 2/3 read the seed from its device slot: `seed`
    is `ops.dropout.staged` where dropout is on, and the caller holds it
    until the launch is enqueued (a slot freed before would be handed to
    the call's own outputs); the first dropout argument is the slot's
    address, null where dropout is off."""
    lib = _lib()
    _, _, lq, dh = q.shape
    lk = k.shape[2]
    if not lib.fta_supported_dim(dh):
        raise ValueError(f"flash_tower_attention kernels are compiled for "
                         f"Dh in (16, 32, 64, 128), not {dh}")
    for which in launches:
        smem = lib.fta_smem_bytes(which, lq, lk, dh, WARPS)
        if smem > SMEM_PER_BLOCK:
            raise ValueError(
                f"flash_tower_attention stages two [L, Dh] operands of one "
                f"head in shared memory: launch {which} at Lq={lq}, "
                f"Lk={lk}, Dh={dh} needs {smem} bytes, more than the "
                f"{SMEM_PER_BLOCK} a block may use")
    _, threshold, keep, on, h0 = _dropout_args(seed, rate, h0)
    slot = seed.slot.data_ptr() if on else None
    return lib, 1.0 / (dh ** 0.5), (slot, threshold, keep, on, h0)


def _mask_bytes(padding_mask):
    """The kernels read one byte per key (nonzero = padding)."""
    if padding_mask is None:
        return None
    return (padding_mask if padding_mask.dtype == torch.bool
            else padding_mask != 0).contiguous()


def _views(**tensors) -> str:
    """Shape, element strides and base alignment of each view, for the
    message of a launch that failed (codes -10 and -11 are the TMA map
    encoder's: not found, refused)."""
    return ", ".join(f"{n} {tuple(t.shape)} strides {t.stride()} "
                     f"base % 16 = {t.data_ptr() % 16}"
                     for n, t in tensors.items())


def _launch_fwd(q, k, v, mask, seed, rate, heads=(0, None)):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if rate > 0.0:
        seed = staged(seed, q.device)  # held past the launch
    variant = single_block_variant(q, k, v)
    lib, scale, drop = _prepare(q, k, seed, rate,
                                () if variant == "wgmma" else (0,), heads[0])
    out = _heads_last(b, lq, h, dh, q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "wgmma":
            rc = lib.fta_wgmma_forward(*head, b, h, lq, lk, strides, scale,
                                       *drop, stream)
        else:
            vec = _aligned((k, v), q.element_size())
            rc = lib.fta_forward(*head, _DTYPES[q.dtype], b, h, lq, lk, dh,
                                 strides, scale, *drop, ROWS, WARPS,
                                 int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"flash_tower_attention forward kernel launch "
                           f"({variant}) failed: CUDA error {rc}; "
                           f"{_views(q=q, k=k, v=v)}")
    flash_tower_attention.fwd_launches += 1
    if variant == "wgmma":
        flash_tower_attention.tc_fwd_launches += 1
    return out, lse


def _launch_bwd(q, k, v, mask, lse, g, seed, rate, heads=(0, None)):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if g.stride(-1) != 1:
        g = g.contiguous()
    if rate > 0.0:
        seed = staged(seed, q.device)  # held past the launch
    variant = single_block_variant(q, k, v, g)
    wgmma = variant == "wgmma"
    lib, scale, drop = _prepare(q, k, seed, rate, () if wgmma else (1, 2),
                                heads[0])
    dq = _heads_last(b, lq, h, dh, q)
    dk = _heads_last(b, lk, h, dh, k)
    dv = _heads_last(b, lk, h, dh, v)
    strides = (ctypes.c_longlong * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3])
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if wgmma:
            rc = lib.fta_wgmma_backward(*head, b, h, lq, lk, strides, scale,
                                        *drop, stream)
        else:
            # delta: the scalar dq pass's scratch for its dk/dv pass
            delta = torch.empty((b, h, lq), dtype=torch.float32,
                                device=q.device)
            vec = _aligned((q, k, v, g), q.element_size())
            rc = lib.fta_backward(*head, delta.data_ptr(), _DTYPES[q.dtype],
                                  b, h, lq, lk, dh, strides, scale, *drop,
                                  ROWS, WARPS, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"flash_tower_attention backward kernel launch "
                           f"({variant}) failed: CUDA error {rc}; "
                           f"{_views(q=q, k=k, v=v, g=g)}")
    flash_tower_attention.bwd_launches += 1
    if wgmma:
        flash_tower_attention.tc_bwd_launches += 1
    return dq, dk, dv


def _device_check(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no flash_tower_attention kernel for {t.device}")


def _check_single_block(q, k, num_heads=None) -> None:
    """Kernels 2/3 take only the shapes within `fits_vmem` (at the layer's
    head count): past it the JAX package takes its chunked kernels, whose
    padding and dropout mask differ."""
    _, h, lq, dh = q.shape
    if num_heads is not None:
        h = int(num_heads)
    if not fits_vmem(h, lq, k.shape[2], dh):
        raise ValueError(
            f"flash_tower_attention_fwd/_bwd (kernels 2/3) at H={h}, "
            f"Lq={lq}, Lk={k.shape[2]}, Dh={dh} is past fits_vmem: call "
            "flash_tower_attention, which takes the chunked kernels 4/5 there")


def _check_grad_inputs(q, lse, g) -> None:
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must match q: {tuple(g.shape)} {g.dtype} vs "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, Lq] f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


# The four runners below take checked inputs and a bool padding mask (from
# `_mask_bytes`): CPU tensors run the plain version, CUDA ones the kernel.
# `heads` = (head_offset, num_heads), checked by `_layer_heads`.
def _single_fwd(q, k, v, mask, seed, rate, heads=(0, None)):
    if q.device.type == "cpu":
        return flash_tower_attention_fwd_reference(q, k, v, mask, seed, rate,
                                                   heads[0])
    _device_check(q)
    return _launch_fwd(q, k, v, mask, seed, rate, heads)


def _single_bwd(q, k, v, mask, lse, g, seed, rate, heads=(0, None)):
    if q.device.type == "cpu":
        return flash_tower_attention_bwd_reference(q, k, v, mask, lse, g,
                                                   seed, rate, heads[0])
    _device_check(q)
    return _launch_bwd(q, k, v, mask, lse, g, seed, rate, heads)


def flash_tower_attention_fwd(q, k, v, padding_mask, seed: int,
                              dropout_rate: float = 0.0,
                              head_offset: int = 0,
                              num_heads: Optional[int] = None):
    """The forward kernel (kernel 2) on CUDA tensors, its plain version on
    CPU tensors: (out [B, H, Lq, Dh] in [B, Lq, H, Dh] storage, lse
    [B, H, Lq] f32).  Arguments as `flash_tower_attention`; shapes within
    `fits_vmem` only."""
    _check(q, k, v, padding_mask, dropout_rate)
    heads = _layer_heads(q, head_offset, num_heads)
    _check_single_block(q, k, heads[1])
    return _single_fwd(q, k, v, _mask_bytes(padding_mask), seed,
                       dropout_rate, heads)


def flash_tower_attention_bwd(q, k, v, padding_mask, lse, g, seed: int,
                              dropout_rate: float = 0.0,
                              head_offset: int = 0,
                              num_heads: Optional[int] = None):
    """The backward kernel (kernel 3: one launch on the Hopper variant, two
    on the scalar one) on CUDA tensors, its
    plain version on CPU tensors: (dq, dk, dv), each [B, H, L, Dh] in
    [B, L, H, Dh] storage.  g: d(out), any strides with a unit last one."""
    _check(q, k, v, padding_mask, dropout_rate)
    heads = _layer_heads(q, head_offset, num_heads)
    _check_single_block(q, k, heads[1])
    _check_grad_inputs(q, lse, g)
    return _single_bwd(q, k, v, _mask_bytes(padding_mask), lse.contiguous(),
                       g, seed, dropout_rate, heads)


def _chunk_lib() -> ctypes.CDLL:
    lib = _build.load(_CHUNK_LIB)
    if lib.fca_chunk_forward.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        tail = [ptr, ctypes.c_float, u32, u32, ctypes.c_float, i32, i32,
                i32, ptr]
        # ..., dropout, h0, vec, wgmma, stream
        lib.fca_chunk_forward.argtypes = ([ptr] * 6 + [i32] * 7 + tail[:-1]
                                          + [i32, ptr])
        lib.fca_chunk_backward.argtypes = ([ptr] * 11 + [i32] * 7 + tail[:-1]
                                           + [i32, ptr])
        lib.fca_chunk_forward.restype = i32
        lib.fca_chunk_backward.restype = i32
        lib.fca_chunk_smem_bytes.argtypes = [i32] * 3
        lib.fca_chunk_smem_bytes.restype = ctypes.c_size_t
        lib.fca_chunk_supported_dim.argtypes = [i32]
        lib.fca_chunk_supported_dim.restype = i32
    return lib


def _chunk_prepare(q, seed, rate, launches, wgmma, h0=0):
    """As `_prepare`, for the chunked kernels, whose shared memory depends
    on the head dim and `wgmma` (the launches on their wgmma variant)."""
    lib = _chunk_lib()
    dh = q.shape[-1]
    if not lib.fca_chunk_supported_dim(dh):
        raise ValueError(f"flash_chunked_attention kernels are compiled for "
                         f"Dh in (16, 32, 64, 128), not {dh}")
    for which in launches:
        smem = lib.fca_chunk_smem_bytes(which, dh, int(wgmma))
        if smem > SMEM_PER_BLOCK:
            raise ValueError(f"flash_chunked_attention launch {which} at "
                             f"Dh={dh} needs {smem} bytes of shared memory, "
                             f"more than the {SMEM_PER_BLOCK} a block may use")
    return lib, 1.0 / (dh ** 0.5), _streamed_dropout_args(seed, rate, h0)


def _launch_chunk_fwd(q, k, v, mask, seed, rate, heads=(0, None)):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    vec = _aligned((q, k, v), q.element_size())
    wgmma = tiled_variant(q, k, v) == "wgmma"
    h0, total = _layer_heads(q, *heads)
    lib, scale, drop = _chunk_prepare(q, seed, rate, (0,), wgmma, h0)
    out = _heads_last(b, lq, h, dh, q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    _kernel_call(lib.fca_chunk_forward, "flash_chunked_attention forward", q,
                 k, v, mask, out, lse, _DTYPES[q.dtype], b, h, lq, lk, dh,
                 chunk_head_group(total), strides, scale, *drop, int(vec),
                 int(wgmma))
    flash_tower_attention.chunk_fwd_launches += 1
    if wgmma:
        flash_tower_attention.chunk_fwd_wgmma_launches += 1
    return out, lse


def _launch_chunk_bwd(q, k, v, mask, out, lse, g, seed, rate,
                      heads=(0, None)):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if g.stride(-1) != 1:
        g = g.contiguous()
    vec = _aligned((q, k, v, g), q.element_size())
    wgmma = tiled_variant(q, k, v, g, out) == "wgmma"
    h0, total = _layer_heads(q, *heads)
    lib, scale, drop = _chunk_prepare(q, seed, rate, (1, 2), wgmma, h0)
    dq = _heads_last(b, lq, h, dh, q)
    dk = _heads_last(b, lk, h, dh, k)
    dv = _heads_last(b, lk, h, dh, v)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *g.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3])
    _kernel_call(lib.fca_chunk_backward, "flash_chunked_attention backward",
                 q, k, v, mask, out, lse, g, dq, dk, dv, delta,
                 _DTYPES[q.dtype], b, h, lq, lk, dh, chunk_head_group(total),
                 strides, scale, *drop, int(vec), int(wgmma))
    flash_tower_attention.chunk_bwd_launches += 1
    if wgmma:
        flash_tower_attention.chunk_bwd_wgmma_launches += 1
    return dq, dk, dv


def _chunk_fwd(q, k, v, mask, seed, rate, heads=(0, None)):
    if q.device.type == "cpu":
        return flash_chunked_attention_fwd_reference(q, k, v, mask, seed, rate,
                                                     *heads)
    _device_check(q)
    return _launch_chunk_fwd(q, k, v, mask, seed, rate, heads)


def _chunk_bwd(q, k, v, mask, out, lse, g, seed, rate, heads=(0, None)):
    if q.device.type == "cpu":
        return flash_chunked_attention_bwd_reference(q, k, v, mask, out, lse,
                                                     g, seed, rate, *heads)
    _device_check(q)
    return _launch_chunk_bwd(q, k, v, mask, out, lse, g, seed, rate, heads)


def flash_chunked_attention_fwd(q, k, v, padding_mask, seed: int,
                                dropout_rate: float = 0.0,
                                head_offset: int = 0,
                                num_heads: Optional[int] = None):
    """The chunked forward kernel (kernel 4) on CUDA tensors, its plain
    version on CPU tensors: (out [B, H, Lq, Dh] in [B, Lq, H, Dh] storage,
    lse [B, H, Lq] f32).  Arguments as `flash_tower_attention`; any length
    (the kernel streams 128-key tiles)."""
    _check(q, k, v, padding_mask, dropout_rate)
    return _chunk_fwd(q, k, v, _mask_bytes(padding_mask), seed, dropout_rate,
                      _layer_heads(q, head_offset, num_heads))


def flash_chunked_attention_bwd(q, k, v, padding_mask, out, lse, g,
                                seed: int, dropout_rate: float = 0.0,
                                head_offset: int = 0,
                                num_heads: Optional[int] = None):
    """The chunked backward kernel (kernel 5, two launches) on CUDA
    tensors, its plain version on CPU tensors: (dq, dk, dv), each
    [B, H, L, Dh] in [B, L, H, Dh] storage.  out, lse: the forward's
    results; g: d(out), any strides with a unit last one."""
    _check(q, k, v, padding_mask, dropout_rate)
    _check_grad_inputs(q, lse, g)
    _check_out(q, out)
    return _chunk_bwd(q, k, v, _mask_bytes(padding_mask), out,
                      lse.contiguous(), g, seed, dropout_rate,
                      _layer_heads(q, head_offset, num_heads))


def _tiled_lib() -> ctypes.CDLL:
    lib = _build.load(_TILED_LIB)
    if lib.ftl_forward.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        # ..., dropout, h0, vec, wgmma, stream; the backward passes: ...,
        # vec, wgmma, persistent, stream
        tail = [ptr, ctypes.c_float, u32, u32, ctypes.c_float, i32, i32, i32,
                i32, ptr]
        bwd_tail = tail[:-1] + [i32, ptr]
        lib.ftl_forward.argtypes = [ptr] * 6 + [i32] * 7 + tail
        lib.ftl_dq.argtypes = [ptr] * 9 + [i32] * 7 + bwd_tail
        lib.ftl_dkv.argtypes = [ptr] * 9 + [i32] * 7 + bwd_tail
        lib.ftl_forward.restype = lib.ftl_dq.restype = i32
        lib.ftl_dkv.restype = i32
        lib.ftl_smem_bytes.argtypes = [i32] * 3
        lib.ftl_smem_bytes.restype = ctypes.c_size_t
        lib.ftl_supported_dim.argtypes = [i32]
        lib.ftl_supported_dim.restype = i32
    return lib


def _tiled_prepare(q, seed, rate, which, wgmma, h0=0):
    """The loaded library, the score scale and the dropout arguments of one
    tiled launch (0: kernel 6, 1: kernel 7, 2: kernel 8), after checking the
    head dim and the launch's shared memory (`wgmma`: on its wgmma
    variant)."""
    lib = _tiled_lib()
    dh = q.shape[-1]
    if not lib.ftl_supported_dim(dh):
        raise ValueError(f"flash_tiled_attention kernels are compiled for "
                         f"Dh in (16, 32, 64, 128), not {dh}")
    smem = lib.ftl_smem_bytes(which, dh, int(wgmma))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"flash_tiled_attention launch {which} at Dh={dh} "
                         f"needs {smem} bytes of shared memory, more than "
                         f"the {SMEM_PER_BLOCK} a block may use")
    return lib, 1.0 / (dh ** 0.5), _streamed_dropout_args(seed, rate, h0)


# the streamed libraries' own (negative) return codes
_STREAMED_ERRORS = {
    -1: "head dim not compiled",
    -2: "the wgmma variant takes bf16 at Dh = 64 only",
    -10: "cuTensorMapEncodeTiled not found in libcuda",
    -11: "cuTensorMapEncodeTiled refused a TMA map (strides or alignment)"}


def _kernel_call(fn, what, *args):
    """fn(*args, stream) on the current stream of args[0]'s device, each
    tensor passed as its data pointer (None as a null one); raises on a
    nonzero return code."""
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        why = _STREAMED_ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{what} kernel launch failed: {why}")


def _launch_tiled_fwd(q, k, v, mask, seed, rate, heads=(0, None)):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    vec = _aligned((q, k, v), q.element_size())
    wgmma = tiled_variant(q, k, v) == "wgmma"
    h0, total = _layer_heads(q, *heads)
    lib, scale, drop = _tiled_prepare(q, seed, rate, 0, wgmma, h0)
    out = _heads_last(b, lq, h, dh, q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    _kernel_call(lib.ftl_forward, "flash_tiled_attention forward", q, k, v,
                 mask, out, lse, _DTYPES[q.dtype], b, h, lq, lk, dh,
                 head_group(total), strides, scale, *drop, int(vec),
                 int(wgmma))
    flash_tower_attention.tiled_fwd_launches += 1
    if wgmma:
        flash_tower_attention.tiled_fwd_wgmma_launches += 1
    return out, lse


def _launch_tiled_dq(q, k, v, mask, out, lse, g, seed, rate,
                     persistent=None, heads=(0, None)):
    """Kernel 7; `persistent` (None: TILED_BWD_PERSISTENT) picks the wgmma
    passes' grid, which chip_smoke.py times both ways."""
    if persistent is None:
        persistent = TILED_BWD_PERSISTENT
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    vec = _aligned((q, k, v, g), q.element_size())
    wgmma = tiled_variant(q, k, v, g, out) == "wgmma"
    h0, total = _layer_heads(q, *heads)
    lib, scale, drop = _tiled_prepare(q, seed, rate, 1, wgmma, h0)
    dq = _heads_last(b, lq, h, dh, q)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *g.stride()[:3], *dq.stride()[:3])
    _kernel_call(lib.ftl_dq, "flash_tiled_attention dq", q, k, v, mask, out,
                 lse, g, dq, delta, _DTYPES[q.dtype], b, h, lq, lk, dh,
                 head_group(total), strides, scale, *drop, int(vec),
                 int(wgmma), int(persistent))
    flash_tower_attention.tiled_dq_launches += 1
    if wgmma:
        flash_tower_attention.tiled_dq_wgmma_launches += 1
    return dq, delta


def _launch_tiled_dkv(q, k, v, mask, lse, delta, g, seed, rate,
                      persistent=None, heads=(0, None)):
    """Kernel 8; `persistent` as `_launch_tiled_dq`'s."""
    if persistent is None:
        persistent = TILED_BWD_PERSISTENT
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    vec = _aligned((q, k, v, g), q.element_size())
    wgmma = tiled_variant(q, k, v, g) == "wgmma"
    h0, total = _layer_heads(q, *heads)
    lib, scale, drop = _tiled_prepare(q, seed, rate, 2, wgmma, h0)
    dk = _heads_last(b, lk, h, dh, k)
    dv = _heads_last(b, lk, h, dh, v)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3])
    _kernel_call(lib.ftl_dkv, "flash_tiled_attention dk/dv", q, k, v, mask,
                 lse, delta, g, dk, dv, _DTYPES[q.dtype], b, h, lq, lk, dh,
                 head_group(total), strides, scale, *drop, int(vec),
                 int(wgmma), int(persistent))
    flash_tower_attention.tiled_dkv_launches += 1
    if wgmma:
        flash_tower_attention.tiled_dkv_wgmma_launches += 1
    return dk, dv


def _tiled_fwd(q, k, v, mask, seed, rate, heads=(0, None)):
    if q.device.type == "cpu":
        return flash_tiled_attention_fwd_reference(q, k, v, mask, seed, rate,
                                                   *heads)
    _device_check(q)
    return _launch_tiled_fwd(q, k, v, mask, seed, rate, heads)


def _tiled_dq(q, k, v, mask, out, lse, g, seed, rate, heads=(0, None)):
    if q.device.type == "cpu":
        return flash_tiled_attention_dq_reference(q, k, v, mask, out, lse, g,
                                                  seed, rate, *heads)
    _device_check(q)
    return _launch_tiled_dq(q, k, v, mask, out, lse, g, seed, rate,
                            heads=heads)


def _tiled_dkv(q, k, v, mask, lse, delta, g, seed, rate, heads=(0, None)):
    if q.device.type == "cpu":
        return flash_tiled_attention_dkv_reference(q, k, v, mask, lse, delta,
                                                   g, seed, rate, *heads)
    _device_check(q)
    return _launch_tiled_dkv(q, k, v, mask, lse, delta, g, seed, rate,
                             heads=heads)


def _tiled_bwd(q, k, v, mask, out, lse, g, seed, rate, heads=(0, None)):
    if g.stride(-1) != 1:
        g = g.contiguous()
    dq, delta = _tiled_dq(q, k, v, mask, out, lse, g, seed, rate, heads)
    dk, dv = _tiled_dkv(q, k, v, mask, lse, delta, g, seed, rate, heads)
    return dq, dk, dv


def _check_out(q, out) -> None:
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(f"out must match q: {tuple(out.shape)} {out.dtype} "
                         f"vs {tuple(q.shape)} {q.dtype}")
    if out.stride(-1) != 1:
        raise ValueError("out needs a contiguous last (feature) dim")


def flash_tiled_attention_fwd(q, k, v, padding_mask, seed: int,
                              dropout_rate: float = 0.0,
                              head_offset: int = 0,
                              num_heads: Optional[int] = None):
    """The tiled forward kernel (kernel 6) on CUDA tensors, its plain
    version on CPU tensors: (out [B, H, Lq, Dh] in [B, Lq, H, Dh] storage,
    lse [B, H, Lq] f32).  Arguments as `flash_tower_attention`; any
    length."""
    _check(q, k, v, padding_mask, dropout_rate)
    return _tiled_fwd(q, k, v, _mask_bytes(padding_mask), seed, dropout_rate,
                      _layer_heads(q, head_offset, num_heads))


def flash_tiled_attention_dq(q, k, v, padding_mask, out, lse, g, seed: int,
                             dropout_rate: float = 0.0,
                             head_offset: int = 0,
                             num_heads: Optional[int] = None):
    """The tiled dq kernel (kernel 7) on CUDA tensors, its plain version on
    CPU tensors: (dq [B, H, Lq, Dh] in [B, Lq, H, Dh] storage, delta
    [B, H, Lq] f32 = rowsum(g·out), which kernel 8 takes).  out, lse: the
    forward's results; g: d(out) with a unit last stride."""
    _check(q, k, v, padding_mask, dropout_rate)
    _check_grad_inputs(q, lse, g)
    _check_out(q, out)
    if g.stride(-1) != 1:
        raise ValueError("g needs a contiguous last (feature) dim")
    return _tiled_dq(q, k, v, _mask_bytes(padding_mask), out,
                     lse.contiguous(), g, seed, dropout_rate,
                     _layer_heads(q, head_offset, num_heads))


def flash_tiled_attention_dkv(q, k, v, padding_mask, lse, delta, g,
                              seed: int, dropout_rate: float = 0.0,
                              head_offset: int = 0,
                              num_heads: Optional[int] = None):
    """The tiled dk/dv kernel (kernel 8) on CUDA tensors, its plain version
    on CPU tensors: (dk, dv), each [B, H, Lk, Dh] in [B, Lk, H, Dh]
    storage.  delta: kernel 7's [B, H, Lq] f32."""
    _check(q, k, v, padding_mask, dropout_rate)
    _check_grad_inputs(q, lse, g)
    if delta.shape != lse.shape or delta.dtype != torch.float32:
        raise ValueError(f"delta must be [B, H, Lq] f32, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    if g.stride(-1) != 1:
        raise ValueError("g needs a contiguous last (feature) dim")
    return _tiled_dkv(q, k, v, _mask_bytes(padding_mask), lse.contiguous(),
                      delta.contiguous(), g, seed, dropout_rate,
                      _layer_heads(q, head_offset, num_heads))


def flash_tiled_attention_bwd(q, k, v, padding_mask, out, lse, g, seed: int,
                              dropout_rate: float = 0.0,
                              head_offset: int = 0,
                              num_heads: Optional[int] = None):
    """The tiled backward (kernel 7, then kernel 8) on CUDA tensors, the
    plain versions on CPU tensors: (dq, dk, dv), each [B, H, L, Dh] in
    [B, L, H, Dh] storage.  g: any strides with a unit last one."""
    _check(q, k, v, padding_mask, dropout_rate)
    _check_grad_inputs(q, lse, g)
    _check_out(q, out)
    return _tiled_bwd(q, k, v, _mask_bytes(padding_mask), out,
                      lse.contiguous(), g, seed, dropout_rate,
                      _layer_heads(q, head_offset, num_heads))


# per regime: the forward runner and the backward runner; the streamed
# regimes' backward takes delta = rowsum(g·out), so they keep the output as
# the JAX residual does (flash_attention.py:852-855)
_RUNNERS = {"single": (_single_fwd, _single_bwd),
            "chunked": (_chunk_fwd, _chunk_bwd),
            "tiled": (_tiled_fwd, _tiled_bwd)}


class _FlashTowerAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, seed, rate, kind, heads):
        if kind == "single" and rate > 0.0 and q.device.type == "cuda":
            seed = staged(seed, q.device)  # the backward reads this slot
        ctx.seed, ctx.rate, ctx.kind, ctx.heads = seed, rate, kind, heads
        out, lse = _RUNNERS[kind][0](q, k, v, mask, seed, rate, heads)
        if kind == "single":
            ctx.save_for_backward(q, k, v, mask, lse)
        else:
            ctx.save_for_backward(q, k, v, mask, lse, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, lse, *out = ctx.saved_tensors
        grads = _RUNNERS[ctx.kind][1](q, k, v, mask, *out, lse, g, ctx.seed,
                                      ctx.rate, ctx.heads)
        return (*grads, None, None, None, None, None)


def flash_tower_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    seed: int,
    dropout_rate: float = 0.0,
    head_offset: int = 0,
    num_heads: Optional[int] = None,
) -> torch.Tensor:
    """softmax((q kᵀ)/√d + mask) with dropout, times v: fused tower
    attention with a fused backward.

    q: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh] (bf16 or f32, feature dim
    contiguous, any outer strides); padding_mask: [B, Lk] (nonzero/True =
    padding) or None; seed: a Python int (the int32 layer seed; ignored at
    rate 0), or a `FlashSeed` whose device slot kernels 2/3 read.  Returns
    [B, H, Lq, Dh] in q's dtype, in [B, Lq, H, Dh] storage.  Shapes within
    `fits_vmem` take kernels 2/3, longer ones within `fits_chunked` kernels
    4/5, longer ones still kernels 6–8 (see `regime`).  head_offset / num_heads: q holds heads [head_offset,
    head_offset + h) of a layer's num_heads (a tensor-parallel rank's
    heads; the default is all of them): the regime, the head group and the
    mask are the layer's, so the result is those heads of the whole
    layer's call.  Without a gradient to take (torch.no_grad, or no input that
    requires grad) it runs the forward alone and saves nothing.
    `flash_tower_attention.fwd_launches` / `.bwd_launches` count the
    launches of kernels 2/3 (`.tc_fwd_launches` / `.tc_bwd_launches` those
    of them on the Hopper variant, "wgmma"), `.chunk_fwd_launches` /
    `.chunk_bwd_launches` those of kernels 4/5 (a backward's two launches
    count once; `.chunk_fwd_wgmma_launches` / `.chunk_bwd_wgmma_launches`
    those of kernels 4 and 5 on the wgmma variant), and `.tiled_fwd_launches` / `.tiled_dq_launches` /
    `.tiled_dkv_launches` those of kernels 6, 7 and 8
    (`.tiled_fwd_wgmma_launches` / `.tiled_dq_wgmma_launches` /
    `.tiled_dkv_wgmma_launches` those of them on the wgmma variant)."""
    _check(q, k, v, padding_mask, dropout_rate)
    mask = _mask_bytes(padding_mask)
    seed = seed if isinstance(seed, FlashSeed) else int(seed)
    rate = float(dropout_rate)
    heads = _layer_heads(q, head_offset, num_heads)
    kind = regime(q, k, heads[1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashTowerAttention.apply(q, k, v, mask, seed, rate, kind,
                                          heads)
    return _RUNNERS[kind][0](q, k, v, mask, seed, rate, heads)[0]


flash_tower_attention.fwd_launches = 0
flash_tower_attention.bwd_launches = 0
flash_tower_attention.tc_fwd_launches = 0
flash_tower_attention.tc_bwd_launches = 0
flash_tower_attention.chunk_fwd_launches = 0
flash_tower_attention.chunk_bwd_launches = 0
flash_tower_attention.tiled_fwd_launches = 0
flash_tower_attention.tiled_dq_launches = 0
flash_tower_attention.tiled_dkv_launches = 0
flash_tower_attention.chunk_fwd_wgmma_launches = 0
flash_tower_attention.chunk_bwd_wgmma_launches = 0
flash_tower_attention.tiled_fwd_wgmma_launches = 0
flash_tower_attention.tiled_dq_wgmma_launches = 0
flash_tower_attention.tiled_dkv_wgmma_launches = 0
flash_tower_attention.by_value_seed_launches = 0
