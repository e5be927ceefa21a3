"""rovr_torch.data."""
