"""leccr_torch.ops."""
