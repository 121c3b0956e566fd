"""leccr_torch.ops.

The kernels' launch counters live beside their wrappers: the attributes
of `flash_attention.flash_tower_attention` and
`fused_cross_attention.fused_cross_attention` whose names end in
"launches", the latter's `launches_by_body`, and the module-level
`*_launches` of `infonce` and `grouped_gemm`.  `launch_counts` reads them
all and `add_launch_counts` adds to them, for a caller that launches
kernels without their wrappers (a CUDA graph's replay) or counted launches
that never ran (its capture)."""

from __future__ import annotations

from typing import Dict, Tuple


def _holders() -> Dict[str, dict]:
    """{holder: the dict that holds its counters}."""
    from leccr_torch.ops import grouped_gemm, infonce
    from leccr_torch.ops.flash_attention import flash_tower_attention
    from leccr_torch.ops.fused_cross_attention import fused_cross_attention

    return {"flash_tower_attention": vars(flash_tower_attention),
            "fused_cross_attention": vars(fused_cross_attention),
            "launches_by_body": fused_cross_attention.launches_by_body,
            "infonce": vars(infonce),
            "grouped_gemm": vars(grouped_gemm)}


def launch_counts() -> Dict[Tuple[str, str], int]:
    """{(holder, counter): launches} of every kernel launch counter."""
    return {(holder, name): v
            for holder, d in _holders().items() for name, v in d.items()
            if (holder == "launches_by_body" or name.endswith("launches"))
            and type(v) is int}


def add_launch_counts(counts: Dict[Tuple[str, str], int]) -> None:
    """Add `counts` ({(holder, counter): launches}, negative to take
    back) to the counters."""
    holders = _holders()
    for (holder, name), v in counts.items():
        holders[holder][name] += v
