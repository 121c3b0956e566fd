"""Grouped GEMM over the experts a mixture-of-experts layer holds (kernel
12, `csrc/grouped_gemm.cu`; no TPU kernel: the JAX package has no MoE
tower).

The routed slots, sorted by expert, are one [M, *] matrix whose rows
[offsets[g], offsets[g + 1]) belong to expert g; each group meets its own
weight of a stack [G, N, K] (nn.Linear's [out, in]):

    grouped_gemm(x, w, offsets)      y[r]  = x[r] · w[g]ᵀ   [M, K] -> [M, N]
    grouped_gemm_dx(dy, w, offsets)  dx[r] = dy[r] · w[g]   [M, N] -> [M, K]
    grouped_gemm_dw(dy, x, offsets)  dw[g] = dy_gᵀ · x_g    -> [G, N, K] f32

`offsets` is int32 [G + 1] on the operands' device, offsets[0] = 0,
non-decreasing, at most M: the kernel reads it there, so no group size
comes back to the host.  Rows of y and dx past offsets[G] are left as
they are (the kernel does not write them; the plain versions leave zeros),
and an empty group's dw is 0.

For CUDA tensors the wrappers launch the kernel (bf16 operands, N and K
multiples of 128) or raise; for CPU tensors they run the plain PyTorch
versions (`*_reference`), which loop over the groups on the host and
compute in f32.  `fwd_launches`, `dx_launches` and `dw_launches` count
the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from leccr_torch.ops import _build

_LIB = "grouped_gemm"

fwd_launches = 0
dx_launches = 0
dw_launches = 0


def _groups(offsets: torch.Tensor):
    bounds = offsets.tolist()
    return list(zip(bounds[:-1], bounds[1:]))


def grouped_gemm_reference(x, w, offsets) -> torch.Tensor:
    """Plain version of `grouped_gemm`: y [M, N] in x's dtype."""
    y = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                    device=x.device)
    for g, (lo, hi) in enumerate(_groups(offsets)):
        y[lo:hi] = x[lo:hi].float() @ w[g].float().T
    return y.to(x.dtype)


def grouped_gemm_dx_reference(dy, w, offsets) -> torch.Tensor:
    """Plain version of `grouped_gemm_dx`: dx [M, K] in dy's dtype."""
    dx = torch.zeros(dy.shape[0], w.shape[2], dtype=torch.float32,
                     device=dy.device)
    for g, (lo, hi) in enumerate(_groups(offsets)):
        dx[lo:hi] = dy[lo:hi].float() @ w[g].float()
    return dx.to(dy.dtype)


def grouped_gemm_dw_reference(dy, x, offsets) -> torch.Tensor:
    """Plain version of `grouped_gemm_dw`: dw [G, N, K] in f32."""
    bounds = _groups(offsets)
    dw = torch.zeros(len(bounds), dy.shape[1], x.shape[1],
                     dtype=torch.float32, device=dy.device)
    for g, (lo, hi) in enumerate(bounds):
        dw[g] = dy[lo:hi].float().T @ x[lo:hi].float()
    return dw


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if lib.gg_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.gg_fwd, lib.gg_dx, lib.gg_dw):
            fn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            fn.restype = i32
    return lib


def _check(a, b, offsets, what: str):
    """The operands as the kernel takes them: bf16, contiguous, 16-byte
    aligned, on one card, N and K multiples of 128, int32 offsets."""
    if a.device.type != "cuda":
        raise ValueError(f"no grouped GEMM kernel for {a.device}")
    if not (a.device == b.device == offsets.device):
        raise ValueError(f"grouped GEMM {what}: operands on more than one "
                         "device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"grouped GEMM {what} takes bf16, not {a.dtype} "
                         f"and {b.dtype}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise ValueError("offsets must be int32 [G + 1]")

    def aligned(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    return aligned(a), aligned(b), offsets.contiguous()


def _widths(n: int, k: int, what: str) -> None:
    if n % 128 or k % 128:
        raise ValueError(f"grouped GEMM {what} takes N and K multiples of "
                         f"128, not {n} and {k}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"grouped GEMM {what} kernel launch failed: "
                           f"code {rc}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """y [M, N] = x [M, K] · w[g]ᵀ over each group's rows; w [G, N, K]."""
    global fwd_launches
    if x.device.type == "cpu":
        return grouped_gemm_reference(x, w, offsets)
    x, w, offsets = _check(x, w, offsets, "forward")
    g, n, k = w.shape
    _widths(n, k, "forward")
    y = torch.empty(x.shape[0], n, dtype=x.dtype, device=x.device)
    rc = _lib().gg_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                       offsets.data_ptr(), g, x.shape[0], n, k,
                       _stream(x.device))
    _raise_on(rc, "forward")
    fwd_launches += 1
    return y


def grouped_gemm_dx(dy: torch.Tensor, w: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """dx [M, K] = dy [M, N] · w[g] over each group's rows."""
    global dx_launches
    if dy.device.type == "cpu":
        return grouped_gemm_dx_reference(dy, w, offsets)
    dy, w, offsets = _check(dy, w, offsets, "dx")
    g, n, k = w.shape
    _widths(n, k, "dx")
    dx = torch.empty(dy.shape[0], k, dtype=dy.dtype, device=dy.device)
    rc = _lib().gg_dx(dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
                      offsets.data_ptr(), g, dy.shape[0], n, k,
                      _stream(dy.device))
    _raise_on(rc, "dx")
    dx_launches += 1
    return dx


def grouped_gemm_dw(dy: torch.Tensor, x: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """dw [G, N, K] (f32) = dy_gᵀ · x_g over each group's rows."""
    global dw_launches
    if dy.device.type == "cpu":
        return grouped_gemm_dw_reference(dy, x, offsets)
    dy, x, offsets = _check(dy, x, offsets, "dw")
    n, k = dy.shape[1], x.shape[1]
    _widths(n, k, "dw")
    g = offsets.shape[0] - 1
    dw = torch.empty(g, n, k, dtype=torch.float32, device=dy.device)
    rc = _lib().gg_dw(dy.data_ptr(), x.data_ptr(), dw.data_ptr(),
                      offsets.data_ptr(), g, dy.shape[0], n, k,
                      _stream(dy.device))
    _raise_on(rc, "dw")
    dw_launches += 1
    return dw
