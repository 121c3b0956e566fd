"""leccr_torch.utils."""
