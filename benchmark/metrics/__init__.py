"""One reader a per-layer metric, `<metric>.py` with `read(run)`: the
metric's value from the traced run, or None where it finds nothing."""
