"""Device-to-host synchronisations inside `train.step` a step (the
program's `host_syncs` counter), the mean over the first traced slice's
steps."""

from benchmark.metrics._spans import train_host_syncs


def read(run):
    return train_host_syncs(run)
