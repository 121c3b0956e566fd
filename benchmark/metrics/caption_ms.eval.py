"""Device ms one eval spends in `model.caption`, the caption encoder: the
spans' start-to-end stream time, summed over the first traced eval."""

from benchmark.metrics._spans import eval_ms


def read(run):
    return eval_ms(run, "model.caption")
