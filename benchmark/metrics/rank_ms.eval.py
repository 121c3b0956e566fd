"""Device ms one eval spends in `eval.rank`, the ranker: scores, ranks, the
copy to the host: the spans' start-to-end stream time, summed over the
first traced eval."""

from benchmark.metrics._spans import eval_ms


def read(run):
    return eval_ms(run, "eval.rank")
