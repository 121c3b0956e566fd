"""Kernel 1 (`ops.fused_cross_attention`): the bound of the traced eval's
launches at their shapes over their device time, in %."""

import math

from benchmark import roofline
from benchmark.metrics._common import mismatch


def read(run):
    trace = run.trace
    if trace is None:
        return None
    split, ib = run.driver.split, run.cfg.train.batch_size_test
    rows = roofline.eval_fca_launches(
        run.arch, ib, split["caption_ids"].shape[1],
        math.ceil(split["images"].shape[0] / ib))
    expected = sum(n for _, n in rows)
    if trace["launches"]["fca"] != expected:
        mismatch("kernel 1", {"fca": trace["launches"]["fca"]},
                  {"fca": expected})
        return None
    bounds = [n * roofline.fca_launch(*shape)[0] for shape, n in rows]
    return roofline.share(bounds, 1e3 * roofline.family_ms(
        trace["families"], "fca"))
