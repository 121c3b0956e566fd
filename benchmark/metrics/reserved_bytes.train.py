"""Device memory that CUDA's caching allocator holds in a train step, a
CUDA graph's pool included (`memory_peak_bytes`, which counts live tensors
alone, does not see a pool's blocks between replays): the most any of
the first traced slice's steps held when its `train.step` closed, in
bytes.  None where the program's spans keep no such reading."""

from benchmark.metrics._spans import train_steps


def read(run):
    steps = train_steps(run)
    if steps is None:
        return None
    held = [getattr(s, "reserved_bytes", None) for u in steps for s in u
            if s.parent is None]
    if not held or any(v is None for v in held):
        return None
    return max(held)
