"""The device's idle share of the traced slice of a train cell: the share
of its wall time with no operation on the device, from one timeline."""

from benchmark.metrics._common import idle_share


def read(run):
    return idle_share(run)
