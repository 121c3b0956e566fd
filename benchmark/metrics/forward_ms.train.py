"""Device ms a train step spends in `train.forward`: the span's start marker
to its end marker on the stream (waits on the host included), summed over
the step's spans of that name, the mean over the first traced slice's
steps."""

from benchmark.metrics._spans import train_phase_ms


def read(run):
    return train_phase_ms(run, "train.forward", "device")
