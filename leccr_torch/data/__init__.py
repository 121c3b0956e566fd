"""leccr_torch.data."""
