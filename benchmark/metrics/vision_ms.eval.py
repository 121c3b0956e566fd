"""Device ms one eval spends in `model.vision`, the vision tower: the spans'
start-to-end stream time, summed over the first traced eval."""

from benchmark.metrics._spans import eval_ms


def read(run):
    return eval_ms(run, "model.vision")
