"""leccr_torch.models."""
