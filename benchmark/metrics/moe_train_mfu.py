"""The share of the H100's bf16 peak of a train step whose text tower has
MoE layers: model FLOPs of the traced steps (`roofline_moe.
train_step_flops` at each step's widths, the routed experts at the slots
the step routed to the held experts, from the `train.step` span) over
the traced wall time × 989 TFLOP/s, in %."""

from benchmark import roofline, roofline_moe
from benchmark.metrics._moe import routed_slots
from benchmark.reference.deepseek_v2 import Tower


def read(run):
    trace = run.trace
    slots = routed_slots(run)
    if trace is None or trace["window_s"] <= 0 or slots is None:
        return None
    tower = Tower.of(run.driver.meta["config"]["model"]["text"])
    flops = sum(roofline_moe.train_step_flops(
        run.arch, tower, w["batch"], w["text"], w["caption"],
        sum(s["text"]), sum(s["caption"]))
        for w, s in zip(trace["widths"], slots))
    return 100.0 * flops / (trace["window_s"]
                            * roofline.PEAK_FLOPS["bfloat16"])
