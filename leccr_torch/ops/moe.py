"""Routing of a mixture-of-experts layer over the experts it holds, in
static shapes on the device.

    r = route(scores, valid, top_k, held, offset)
    y = routed_experts(x, r, gate_w, up_w, down_w)

`route` takes the router's probabilities [T, E] (f32) and the tokens'
valid mask [T]: the greedy top-k choices of every token over all E
experts, then the T·k slots sorted by the expert they go to, among the
`held` experts from `offset` on (an expert-parallel rank's share).  Slots
of other experts and of padded tokens sort past the last group and are not
computed.  The group sizes are counted by `scatter_add` into a fixed
[held + 1] buffer and their offsets taken on the device: nothing here reads
a value back to the host, so a step that routes makes no host sync and a
CUDA graph of it replays the routing of whatever batch it gets.

`routed_experts` is the layer's routed part, Σ_j w_tj · E_{e_tj}(x_t) over
each token's held choices, with every expert a SwiGLU,
E(x) = W_down(silu(W_gate x) ⊙ W_up x), on stacks [held, out, in] of f32
masters cast to x's dtype at use.  The slots' rows are gathered, the three
products run as grouped GEMMs (`ops.grouped_gemm`, kernel 12 on the card),
and each token sums its slots in f32 in the fixed order of its choices.
Its backward recomputes the experts' activations from x rather than keep
them (a slot matrix is T·k rows, most of them not computed): the routed
part holds no activation of its own between forward and backward, at the
price of the three forward products again.  Every sum over a token's
slots is a gather and a sum in a fixed order, so the bits do not depend on
the order of atomics.

`balance_loss` is DeepSeek-V2's sequence-wise auxiliary loss over the
valid tokens.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from leccr_torch.ops.grouped_gemm import (
    grouped_gemm,
    grouped_gemm_dw,
    grouped_gemm_dx,
)


class ExpertStack(nn.Module):
    """The SwiGLU weights of `experts` experts as f32 stacks [E, out, in]:
    `gate_proj` and `up_proj` [E, inner, dim], `down_proj` [E, dim, inner]."""

    def __init__(self, experts: int, dim: int, inner: int):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(experts, inner, dim))
        self.up_proj = nn.Parameter(torch.empty(experts, inner, dim))
        self.down_proj = nn.Parameter(torch.empty(experts, dim, inner))


class Routing(NamedTuple):
    """One call's routing: `weights` and `experts` [T, k] (the greedy top-k
    of every token, over all experts), `held` [T, k] (a choice this layer
    computes), `order` [T·k] (slot ids, token-major, sorted by held expert
    with the others last; stable), `inv` [T·k] (each slot's place in
    `order`), `counts` [held + 1] (slots of each held expert, then of the
    rest) and `offsets` [held + 1] int32 (the held groups' bounds)."""

    weights: torch.Tensor
    experts: torch.Tensor
    held: torch.Tensor
    order: torch.Tensor
    inv: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor


def route(scores: torch.Tensor, valid: torch.Tensor, top_k: int, held: int,
          offset: int = 0) -> Routing:
    """The routing of tokens with router probabilities `scores` [T, E] and
    valid mask `valid` [T] bool over the experts [offset, offset + held)."""
    weights, experts = torch.topk(scores, top_k, dim=-1)
    local = experts - offset
    mine = (local >= 0) & (local < held) & valid[:, None]
    key = torch.where(mine, local, held).flatten()
    order = torch.sort(key, stable=True).indices
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    counts = torch.zeros(held + 1, dtype=torch.int64, device=key.device
                         ).scatter_add_(0, key, torch.ones_like(key))
    offsets = torch.cat([counts.new_zeros(1), counts[:held].cumsum(0)]
                        ).to(torch.int32)
    return Routing(weights, experts, mine, order, inv, counts, offsets)


def balance_loss(scores: torch.Tensor, experts: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V2's sequence-wise balance loss Σ_i f_i P_i, the mean over
    the sequences, counted over valid tokens only: f_i = E / (k n) ·
    |{t : i ∈ T_t}| and P_i = (1/n) Σ_t s_{t,i} for a sequence of n valid
    tokens.  scores [B, L, E] f32, experts [B, L, k], valid [B, L] bool."""
    b, l, e = scores.shape
    k = experts.shape[-1]
    v = valid.to(scores.dtype)
    n = v.sum(1).clamp_min(1.0)
    chosen = torch.zeros(b, e, dtype=scores.dtype, device=scores.device
                         ).scatter_add_(1, experts.reshape(b, l * k),
                                        v.repeat_interleave(k, dim=1))
    f = chosen * (e / k) / n[:, None]
    p = (scores * v[..., None]).sum(1) / n[:, None]
    return (f * p).sum(1).mean()


def _experts(xs, gate_w, up_w, down_w, offsets):
    """The experts' SwiGLU on the sorted slot rows xs: (gate, up, act, out)."""
    g = grouped_gemm(xs, gate_w, offsets)
    u = grouped_gemm(xs, up_w, offsets)
    a = F.silu(g) * u
    return g, u, a, grouped_gemm(a, down_w, offsets)


def _slots(rows: torch.Tensor, inv: torch.Tensor, held: torch.Tensor
           ) -> torch.Tensor:
    """Sorted slot rows back in token order [T, k, D], f32, 0 where a
    choice is not held (rows past the last group are never read)."""
    t, k = held.shape
    out = rows.index_select(0, inv).view(t, k, -1).float()
    return torch.where(held[..., None], out, 0.0)


class _RoutedExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gate_w, up_w, down_w, order, inv, held, offsets):
        dt = x.dtype
        k = held.shape[1]
        src = torch.div(order, k, rounding_mode="floor")
        wg, wu, wd = (p.to(dt) for p in (gate_w, up_w, down_w))
        xs = x.index_select(0, src)
        _, _, _, o = _experts(xs, wg, wu, wd, offsets)
        y = (_slots(o, inv, held) * w[..., None]).sum(1)
        ctx.save_for_backward(x, w, gate_w, up_w, down_w, order, inv, held,
                              offsets)
        return y.to(dt)

    @staticmethod
    def backward(ctx, dy):
        x, w, gate_w, up_w, down_w, order, inv, held, offsets = \
            ctx.saved_tensors
        dt = x.dtype
        t, k = held.shape
        src = torch.div(order, k, rounding_mode="floor")
        wg, wu, wd = (p.to(dt) for p in (gate_w, up_w, down_w))
        xs = x.index_select(0, src)
        g, u, a, o = _experts(xs, wg, wu, wd, offsets)
        dyf = dy.float()
        dw = (_slots(o, inv, held) * dyf[:, None, :]).sum(-1)
        w_sorted = torch.where(held, w, 0.0).flatten().index_select(0, order)
        do = (dyf.index_select(0, src) * w_sorted[:, None]).to(dt)
        da = grouped_gemm_dx(do, wd, offsets).float()
        d_down = grouped_gemm_dw(do, a, offsets)
        gf, uf = g.float(), u.float()
        sig = torch.sigmoid(gf)
        dg = (da * uf * sig * (1.0 + gf * (1.0 - sig))).to(dt)
        du = (da * gf * sig).to(dt)
        d_gate = grouped_gemm_dw(dg, xs, offsets)
        d_up = grouped_gemm_dw(du, xs, offsets)
        dxs = (grouped_gemm_dx(dg, wg, offsets).float()
               + grouped_gemm_dx(du, wu, offsets).float())
        dx = _slots(dxs, inv, held).sum(1).to(dt)
        return dx, dw, d_gate, d_up, d_down, None, None, None, None


def routed_experts(x: torch.Tensor, r: Routing, gate_w: torch.Tensor,
                   up_w: torch.Tensor, down_w: torch.Tensor) -> torch.Tensor:
    """Σ over each token's held choices of w · SwiGLU_e(x), [T, D] in x's
    dtype; gate_w / up_w [held, I, D], down_w [held, D, I]."""
    return _RoutedExperts.apply(x, r.weights, gate_w, up_w, down_w, r.order,
                                r.inv, r.held, r.offsets)
