"""The benchmark of leccr_torch on one H100: `python3 -m benchmark.run`."""
