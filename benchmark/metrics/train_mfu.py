"""The train step's share of the H100's bf16 peak: model FLOPs of the
traced steps (forward and backward, remat's recompute not counted, from
`roofline.train_step_flops` at each step's widths) over the traced wall
time × 989 TFLOP/s, in %."""

from benchmark import roofline


def read(run):
    trace = run.trace
    if trace is None or trace["window_s"] <= 0:
        return None
    flops = sum(roofline.train_step_flops(run.arch, w["batch"], w["text"],
                                          w["caption"])
                for w in trace["widths"])
    return 100.0 * flops / (trace["window_s"]
                            * roofline.PEAK_FLOPS["bfloat16"])
