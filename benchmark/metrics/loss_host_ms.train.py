"""Host ms a train step spends in `train.loss`: the span's host stamps,
summed over the step's spans of that name, the mean over the first traced
slice's steps."""

from benchmark.metrics._spans import train_phase_ms


def read(run):
    return train_phase_ms(run, "train.loss", "host")
