"""Flash tower attention (training) for the CLIP and BERT towers.

The port of the single-block path of `leccr_tpu/ops/flash_attention.py`:
two hand-written CUDA kernels (`csrc/flash_tower_attention.cu`) compute
softmax(q kᵀ/√d + mask) with dropout on the probabilities, times v, and its
backward, keeping the [L, L] scores, probabilities and dropout mask on
chip.  The forward saves the row logsumexp; the backward recomputes the
probabilities from it and regenerates the dropout mask from the seed.

Dropout is the JAX package's interpret-mode hash: per-example seeds
`seed + b · 0x9E3779B9` (int32 wrap), counter `h·Lq·Lk + i·Lk + j`, murmur3
finalizer, keep where the hash ≥ uint32(rate · 2³²), scaled by 1/(1−rate).
So the port's masks equal the JAX kernel's in interpret mode bit for bit
(the TPU's hardware bits are another stream, which nothing reproduces).

`flash_tower_attention` is the entry point, a `torch.autograd.Function`:
for CUDA tensors it launches the kernels (or raises), for CPU tensors it
runs the plain PyTorch versions `flash_tower_attention_fwd_reference` and
`flash_tower_attention_bwd_reference`, which do the same f32 arithmetic
with the same rounding points (the backward is the hand VJP of the TPU
kernel, not autograd through the forward).  Shapes the JAX package sends
to its chunked or tiled kernels raise `NotImplementedError` on every
device: their dropout masks differ, and they are a later slice's work.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from leccr_torch.ops import _build

_LIB = "flash_tower_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = torch.finfo(torch.float32).min
WARPS = 8  # warps per block; each owns one row at a time
ROWS = 64  # rows of one block's tile
SMEM_PER_BLOCK = 232448  # bytes of shared memory a Hopper block may use

# the JAX single-block kernel's VMEM budget (flash_attention.py:37)
_VMEM_BUDGET = 10 * 2 ** 20


def fits_vmem(h: int, lq: int, lk: int, d: int) -> bool:
    """Whether the JAX package takes its single-block kernels for this
    shape (a copy of `leccr_tpu.ops.flash_attention.fits_vmem`): up to 5
    live [H, Lq, Lk] f32 tiles plus 7 [H, L, D] operand tiles in 10 MiB."""
    tiles = 5 * h * lq * lk * 4
    qkv = 7 * h * max(lq, lk) * d * 4
    return tiles + qkv <= _VMEM_BUDGET


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²): split c in 16-bit halves so
    that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return _u32(x * lo + (_u32(x * hi) & 0xFFFF) * 65536)


def keep_mask(seed: int, b: int, h: int, lq: int, lk: int, rate: float,
              device=None) -> torch.Tensor:
    """The dropout factor [B, H, Lq, Lk] in {0, 1/(1-rate)} (f32): the hash
    both kernels compute inline, in plain PyTorch (uint32 arithmetic
    carried in int64)."""
    ctr = torch.arange(h * lq * lk, dtype=torch.int64, device=device)
    seeds = _u32(int(seed) + _mul_u32(
        torch.arange(b, dtype=torch.int64, device=device), 0x9E3779B9))
    x = _u32(ctr[None, :] + _mul_u32(seeds, 0x9E3779B9)[:, None])
    x = _mul_u32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul_u32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    keep = x >= int(rate * 4294967296.0)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return (keep.to(torch.float32) * scale.to(device)).view(b, h, lq, lk)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel.

    q: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh]; padding_mask: [B, Lk]
    (nonzero = padding) or None.  Returns (out [B, H, Lq, Dh] in q's dtype,
    lse [B, H, Lq] f32)."""
    s = _scores(q, k, padding_mask)
    smax = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - smax)
    denom = p.sum(dim=-1, keepdim=True)
    lse = (smax + torch.log(denom))[..., 0]
    p = p / denom
    if dropout_rate > 0.0:
        p = p * keep_mask(seed, *p.shape, dropout_rate, device=p.device)
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
        keep = keep_mask(seed, *p.shape, dropout_rate, device=p.device)
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
    if not fits_vmem(h, lq, k.shape[2], dh):
        raise NotImplementedError(
            f"flash_tower_attention at H={h}, Lq={lq}, Lk={k.shape[2]}, "
            f"Dh={dh} takes the JAX package's chunked or tiled kernels "
            "(flash_attention.py:429-692), whose dropout masks differ; they "
            "come with the long-sequence slice of the port")


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.fta_forward.argtypes is None:
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        f32 = ctypes.c_float
        tail = [f32, u32, u32, f32, i32, i32, i32, i32, ptr]
        lib.fta_forward.argtypes = [ptr] * 6 + [i32] * 6 + [ptr] + tail
        lib.fta_backward.argtypes = [ptr] * 10 + [i32] * 6 + [ptr] + tail
        lib.fta_forward.restype = lib.fta_backward.restype = i32
        lib.fta_smem_bytes.argtypes = [i32] * 5
        lib.fta_smem_bytes.restype = ctypes.c_size_t
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


def _prepare(q, k, seed, rate, launches):
    """The loaded library, the score scale and the dropout arguments of a
    call, after checking the head dim and the shared memory of each launch
    (0: forward, 1: backward dq pass, 2: backward dk/dv pass)."""
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
    drop = (int(seed) & 0xFFFFFFFF, int(rate * 4294967296.0),
            float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)),
            int(rate > 0.0))
    return lib, 1.0 / (dh ** 0.5), drop


def _mask_bytes(padding_mask):
    """The kernels read one byte per key (nonzero = padding)."""
    if padding_mask is None:
        return None
    return (padding_mask if padding_mask.dtype == torch.bool
            else padding_mask != 0).contiguous()


def _launch_fwd(q, k, v, mask, seed, rate):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    lib, scale, drop = _prepare(q, k, seed, rate, (0,))
    out = _heads_last(b, lq, h, dh, q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    vec = _aligned((k, v), q.element_size())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fta_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], b, h, lq, lk, dh, strides,
            scale, *drop, ROWS, WARPS, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"flash_tower_attention forward kernel launch "
                           f"failed: CUDA error {rc}")
    flash_tower_attention.fwd_launches += 1
    return out, lse


def _launch_bwd(q, k, v, mask, lse, g, seed, rate):
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if g.stride(-1) != 1:
        g = g.contiguous()
    lib, scale, drop = _prepare(q, k, seed, rate, (1, 2))
    dq = _heads_last(b, lq, h, dh, q)
    dk = _heads_last(b, lk, h, dh, k)
    dv = _heads_last(b, lk, h, dh, v)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3])
    vec = _aligned((q, k, v, g), q.element_size())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fta_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), _DTYPES[q.dtype], b, h, lq, lk, dh, strides,
            scale, *drop, ROWS, WARPS, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"flash_tower_attention backward kernel launch "
                           f"failed: CUDA error {rc}")
    flash_tower_attention.bwd_launches += 1
    return dq, dk, dv


def _device_check(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no flash_tower_attention kernel for {t.device}")


def flash_tower_attention_fwd(q, k, v, padding_mask, seed: int,
                              dropout_rate: float = 0.0):
    """The forward kernel (kernel 2) on CUDA tensors, its plain version on
    CPU tensors: (out [B, H, Lq, Dh] in [B, Lq, H, Dh] storage, lse
    [B, H, Lq] f32).  Arguments as `flash_tower_attention`."""
    _check(q, k, v, padding_mask, dropout_rate)
    mask = _mask_bytes(padding_mask)
    if q.device.type == "cpu":
        return flash_tower_attention_fwd_reference(q, k, v, mask, seed,
                                                   dropout_rate)
    _device_check(q)
    return _launch_fwd(q, k, v, mask, seed, dropout_rate)


def flash_tower_attention_bwd(q, k, v, padding_mask, lse, g, seed: int,
                              dropout_rate: float = 0.0):
    """The backward kernel (kernel 3, two launches) on CUDA tensors, its
    plain version on CPU tensors: (dq, dk, dv), each [B, H, L, Dh] in
    [B, L, H, Dh] storage.  g: d(out), any strides with a unit last one."""
    _check(q, k, v, padding_mask, dropout_rate)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must match q: {tuple(g.shape)} {g.dtype} vs "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, Lq] f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    lse = lse.contiguous()
    mask = _mask_bytes(padding_mask)
    if q.device.type == "cpu":
        return flash_tower_attention_bwd_reference(q, k, v, mask, lse, g,
                                                   seed, dropout_rate)
    _device_check(q)
    return _launch_bwd(q, k, v, mask, lse, g, seed, dropout_rate)


class _FlashTowerAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, seed, rate):
        out, lse = flash_tower_attention_fwd(q, k, v, mask, seed, rate)
        ctx.save_for_backward(q, k, v, mask, lse)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, lse = ctx.saved_tensors
        grads = flash_tower_attention_bwd(q, k, v, mask, lse, g, ctx.seed,
                                          ctx.rate)
        return (*grads, None, None, None)


def flash_tower_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    seed: int,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """softmax((q kᵀ)/√d + mask) with dropout, times v: fused tower
    attention with a fused backward.

    q: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh] (bf16 or f32, feature dim
    contiguous, any outer strides); padding_mask: [B, Lk] (nonzero/True =
    padding) or None; seed: a Python int (the int32 layer seed; ignored at
    rate 0).  Returns [B, H, Lq, Dh] in q's dtype, in [B, Lq, H, Dh]
    storage.  Without a gradient to take (torch.no_grad, or no input that
    requires grad) it runs the forward alone and saves nothing.
    `flash_tower_attention.fwd_launches` / `.bwd_launches` count the
    kernels' launches (a backward's two launches count once)."""
    mask = _mask_bytes(padding_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashTowerAttention.apply(q, k, v, mask, int(seed),
                                          float(dropout_rate))
    return flash_tower_attention_fwd(q, k, v, mask, int(seed),
                                     float(dropout_rate))[0]


flash_tower_attention.fwd_launches = 0
flash_tower_attention.bwd_launches = 0
