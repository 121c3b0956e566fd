"""Kernel 12 (`ops.grouped_gemm`, the MoE tower's grouped GEMM): the bound
of the traced steps' launches at their shapes (`roofline_moe.
step_launches`, from the slots each step routed to the held experts)
over their device time, in %.  None where the traced launches, or those
the kernel's counters counted in the slice, are not the shapes' count."""

from benchmark import roofline, roofline_moe
from benchmark.metrics._common import mismatch
from benchmark.metrics._moe import routed_slots
from benchmark.reference.deepseek_v2 import Tower


def read(run):
    trace = run.trace
    slots = routed_slots(run)
    if trace is None or slots is None or "grouped_gemm_counted" not in trace:
        return None
    tower = Tower.of(run.driver.meta["config"]["model"]["text"])
    launches = [x for s in slots for x in roofline_moe.step_launches(
        tower, s["text"], s["caption"])]
    seen = {"counted": trace["grouped_gemm_counted"],
            "traced": trace["grouped_gemm_traced"]}
    if set(seen.values()) != {len(launches)}:
        mismatch("grouped GEMM", seen, {"shapes": len(launches)})
        return None
    bounds = [roofline_moe.gemm_launch(*x)[0] for x in launches]
    return roofline.share(bounds,
                          1e3 * trace["families"].get("grouped_gemm", 0.0))
