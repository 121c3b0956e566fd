"""leccr_torch.eval."""
