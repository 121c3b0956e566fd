"""The benchmark's plain reference: the LECCR model, its training step and
its retrieval metrics in float32 PyTorch and NumPy, independent of the
program under test."""
