"""Fused cross-attention for the caption-interaction branch (eval/serving).

The port of `leccr_tpu/ops/pallas_attention.py`: one hand-written CUDA
kernel (`csrc/fused_cross_attention.cu`) computes softmax(q kᵀ/√d + mask) v
with every score and probability kept on chip, in f32 whatever the input
dtype, with padded keys set to f32 min (so an all-padded row gives the mean
of v, never NaN).  It has four bodies, picked from the shapes alone
(`fused_body`): few queries (Lq ≤ 16: the slots attending the caption or
vision tokens), few keys (Lk ≤ 16: the vision tokens attending the slots),
key tiles (128 < Dh ≤ 512: the video model's 4096-wide interaction at 8
heads; keys streamed in tiles with an online softmax, so no block holds a
whole head's K and V) and one for every other shape or view.

`fused_cross_attention` is the wrapper: for CUDA tensors it launches the
kernel (or raises), for CPU tensors it runs the plain PyTorch version
`fused_cross_attention_reference`, which does the same f32 arithmetic.  It
is forward-only, like the TPU kernel: differentiating through it raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from leccr_torch.ops import _build

_LIB = "fused_cross_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_PER_BLOCK = 232448  # bytes of shared memory a Hopper block may use
FEW = 16  # the few-queries body takes Lq <= FEW, the few-keys body Lk <= FEW
BODIES = ("general", "few_queries", "few_keys", "key_tiles")  # body ids
KEY_TILES_MAX_DH = 512  # the key-tiles body: a feature pair a thread


def fused_body(lq: int, lk: int, dh: int, item: int, aligned: bool) -> str:
    """Which body of the kernel a call runs, from the shapes alone: the
    two small bodies take rows that load 16 bytes at a time (`aligned`:
    16-byte aligned rows) in 4, 8 or 16 such chunks (Dh·item = 64, 128 or
    256 bytes) — "few_keys" for Lk ≤ FEW, else "few_queries" for Lq ≤ FEW
    and Dh ≤ 128; such rows at 128 < Dh ≤ 512 take "key_tiles"; every
    other call takes "general".  At the image model's embed_images shapes
    (Lq, Lk) = (4, 200) and (4, 145) take few_queries, (145, 4) few_keys;
    every call of the video model's (Dh = 512) takes key_tiles."""
    whole = aligned and dh * item % 16 == 0
    chunks = dh * item // 16 if whole else 0
    if chunks in (4, 8, 16) and lk <= FEW:
        return "few_keys"
    if chunks in (4, 8, 16) and lq <= FEW and dh <= 128:
        return "few_queries"
    if whole and 128 < dh <= KEY_TILES_MAX_DH:
        return "key_tiles"
    return "general"


def fused_cross_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same f32 math.

    q: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh]; padding_mask: [B, Lk]
    (nonzero/True = padding) or None.  Returns [B, H, Lq, Dh] in q's dtype.
    """
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (1.0 / (q.shape[-1] ** 0.5))
    if padding_mask is not None:
        pad = (padding_mask != 0)[:, None, None, :]
        scores = torch.where(pad, torch.finfo(torch.float32).min, scores)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def _check(q, k, v, padding_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, Dh]")
    b, h, _, dh = q.shape
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
    if padding_mask is not None:
        if tuple(padding_mask.shape) != (b, k.shape[2]):
            raise ValueError(f"padding_mask must be [B, Lk] = "
                             f"{(b, k.shape[2])}, got "
                             f"{tuple(padding_mask.shape)}")
        if padding_mask.device != q.device:
            raise ValueError("padding_mask must lie on q's device")
        if padding_mask.is_floating_point() or padding_mask.is_complex():
            raise TypeError("padding_mask must be bool or integer")


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.fca_forward.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fca_forward.argtypes = [ptr] * 5 + [i32] * 6 + [
            ptr, ctypes.c_float, i32, i32, ptr]  # ..., vec, body, stream
        lib.fca_forward.restype = i32
        lib.fca_smem_bytes.argtypes = [i32] * 5
        lib.fca_smem_bytes.restype = ctypes.c_size_t
    return lib


def _launch(q, k, v, padding_mask) -> torch.Tensor:
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    # [B, Lq, H, Dh] storage seen as [B, H, Lq, Dh]: merging the heads
    # afterwards (transpose(1, 2).reshape) is then free
    out = torch.empty((b, lq, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    lib = _lib()
    # 16-byte loads need 16-byte aligned rows spanning whole 16-byte words
    item = q.element_size()
    vec = all(t.data_ptr() % 16 == 0
              and all(st * item % 16 == 0 for st in t.stride()[:3])
              for t in (q, k, v)) and dh * item % 16 == 0
    body = fused_body(lq, lk, dh, item, vec)
    smem = lib.fca_smem_bytes(BODIES.index(body), lq, lk, dh,
                              _DTYPES[q.dtype])
    if smem > SMEM_PER_BLOCK:  # only the general body grows with Lk
        raise ValueError(
            f"fused_cross_attention stages K and V of one head in shared "
            f"memory: the {body} body at Lq={lq}, Lk={lk}, Dh={dh} needs "
            f"{smem} bytes, more than the {SMEM_PER_BLOCK} a block may use")
    mask = None
    if padding_mask is not None:  # the kernel reads one byte per key
        mask = (padding_mask if padding_mask.dtype == torch.bool
                else padding_mask != 0).contiguous()
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fca_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, lq, lk, dh, strides,
            1.0 / (dh ** 0.5), int(vec), BODIES.index(body), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_cross_attention kernel launch failed: CUDA error {rc}")
    fused_cross_attention.launches_by_body[body] += 1
    fused_cross_attention.launches += 1
    return out


class _FusedCrossAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, padding_mask):
        if q.device.type == "cpu":
            return fused_cross_attention_reference(q, k, v, padding_mask)
        if q.device.type != "cuda":
            raise ValueError(f"no fused_cross_attention for {q.device}")
        return _launch(q, k, v, padding_mask)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "fused_cross_attention is eval/serving-only and has no backward")


def fused_cross_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax((q kᵀ)/√d + mask) v as one fused kernel.

    q: [B, H, Lq, Dh]; k, v: [B, H, Lk, Dh] (bf16 or f32, feature dim
    contiguous); padding_mask: [B, Lk] (nonzero/True = padding) or None.
    Returns [B, H, Lq, Dh] in q's dtype.  `fused_cross_attention.launches`
    counts the kernel's launches, `.launches_by_body` those of each body
    (`fused_body`; they sum to `.launches`).
    """
    _check(q, k, v, padding_mask)
    return _FusedCrossAttention.apply(q, k, v, padding_mask)


fused_cross_attention.launches = 0
fused_cross_attention.launches_by_body = dict.fromkeys(BODIES, 0)
