"""Host ms a train step takes to return from `TrainStep.run` (no sync):
the mean over the window's steps outside the traced slice."""


def read(run):
    times = getattr(run.driver, "enqueue_s", None)
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
