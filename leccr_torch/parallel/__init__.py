"""leccr_torch.parallel: data parallelism over processes."""
