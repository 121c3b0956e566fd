"""Operations and bytes of a train step whose text tower is DeepSeek-V2's
(`text.kind: deepseek_v2`), and of the launches of kernel 12, the grouped
GEMM over the experts held (`leccr_torch.ops.grouped_gemm`).

The rules of `benchmark.roofline`: two operations per multiply-add, each
input byte read once and each output byte written once, a launch's bound
the larger of bytes / HBM rate and operations / peak.  The routed experts'
work depends on the data: it is counted at the slots the held experts
computed (`routed`), as the program's step recorded them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from benchmark import roofline
from benchmark.reference.deepseek_v2 import Tower


def tower_forward_flops(t: Tower, seqs: int, length: int,
                        routed_slots: float) -> float:
    """Matmul FLOPs of the tower's forward over `seqs` rows of `length`
    tokens (padding included: the tower computes it), the routed experts
    at `routed_slots` slots over all its MoE layers."""
    tokens = seqs * length
    q_dim = t.nope + t.rope
    mla = (2 * t.hidden * t.heads * q_dim
           + 2 * t.hidden * (t.kv_rank + t.rope)
           + 2 * t.kv_rank * t.heads * (t.nope + t.v_dim)
           + 2 * t.heads * t.v_dim * t.hidden
           + 2 * length * t.heads * (q_dim + t.v_dim))
    dense = 6 * t.hidden * t.inter
    moe = 2 * t.hidden * t.experts + 6 * t.hidden * t.moe_inter * t.shared
    per_token = (t.layers * mla + t.dense_first * dense
                 + t.moe_layers * moe)
    return tokens * per_token + routed_slots * 6 * t.hidden * t.moe_inter


def train_step_flops(arch, tower: Tower, batch: int, text_len: int,
                     caption_len: int, text_slots: float,
                     caption_slots: float) -> float:
    """Model FLOPs of one train step: forward and backward (2× the
    forward) of everything that takes a gradient, the caption call's
    forward alone; the routed experts' recompute in the backward not
    counted."""
    grad_part = (roofline.vision_forward_flops(arch, batch)
                 + tower_forward_flops(tower, 2 * batch, text_len,
                                       text_slots)
                 + 2 * 2 * batch * arch.text_hidden * arch.embed_dim
                 + roofline.interaction_flops(arch, batch, caption_len,
                                              train=True))
    captions = tower_forward_flops(tower, batch, caption_len, caption_slots)
    return 3 * grad_part + captions


def gemm_launch(op: str, rows: int, n: int, k: int, groups: int
                ) -> Tuple[float, str]:
    """Bound of one grouped GEMM launch over `rows` routed rows and a
    [groups, n, k] weight stack: "fwd" reads x [rows, k] and the stack,
    writes y [rows, n]; "dx" reads dy [rows, n] and the stack, writes
    dx [rows, k]; "dw" reads dy and x and writes dw [groups, n, k] in f32;
    2·rows·n·k operations each."""
    stack = groups * n * k
    n_bytes = {"fwd": 2 * (rows * k + stack + rows * n),
               "dx": 2 * (rows * n + stack + rows * k),
               "dw": 2 * (rows * n + rows * k) + 4 * stack}[op]
    return roofline.bound_ms(n_bytes, 2.0 * rows * n * k)


def step_launches(t: Tower, text_slots: Sequence[int],
                  caption_slots: Sequence[int]) -> List[tuple]:
    """The grouped GEMM launches of one train step as (op, rows, n, k,
    groups), from each MoE layer's slots of the text call (forward, then
    the backward: the three forward products again, dx and dw of the down
    product, dw and dx of gate and up) and of the caption call (forward)."""
    h, i, g = t.hidden, t.moe_inter, t.held
    fwd = [("fwd", i, h), ("fwd", i, h), ("fwd", h, i)]
    bwd = fwd + [("dx", h, i), ("dw", h, i), ("dw", i, h), ("dw", i, h),
                 ("dx", i, h), ("dx", i, h)]
    out = []
    for rows in text_slots:
        out += [(op, rows, n, k, g) for op, n, k in fwd + bwd]
    for rows in caption_slots:
        out += [(op, rows, n, k, g) for op, n, k in fwd]
    return out


def launch_counts(launches: Sequence[tuple]) -> Dict[str, int]:
    """{"fwd", "dx", "dw": launches}."""
    out = {"fwd": 0, "dx": 0, "dw": 0}
    for op, *_ in launches:
        out[op] += 1
    return out
