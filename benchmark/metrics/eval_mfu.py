"""The eval's share of the H100's bf16 peak: model FLOPs of one complete
eval (`roofline.eval_flops`: image side, text tower, score matrix, real
rows only) over the traced eval's wall time × 989 TFLOP/s, in %."""

from benchmark import roofline


def read(run):
    trace = run.trace
    if trace is None or trace["window_s"] <= 0:
        return None
    split = run.driver.split
    flops = roofline.eval_flops(
        run.arch, split["images"].shape[0], split["caption_ids"].shape[1],
        split["text_ids"].shape[0], split["text_ids"].shape[1])
    return 100.0 * flops / (trace["window_s"]
                            * roofline.PEAK_FLOPS["bfloat16"])
