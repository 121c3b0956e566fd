"""Kernels 2/3 (`ops.flash_attention`, single block): the bound of the
traced steps' launches at their shapes over their device time, in %."""

from benchmark.metrics._common import train_flash_roofline


def read(run):
    return train_flash_roofline(run, "single")
