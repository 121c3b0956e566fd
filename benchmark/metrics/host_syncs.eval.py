"""Device-to-host synchronisations inside the first traced eval's spans
(the program's `host_syncs` counter)."""

from benchmark.metrics._spans import eval_host_syncs


def read(run):
    return eval_host_syncs(run)
