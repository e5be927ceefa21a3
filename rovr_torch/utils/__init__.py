"""rovr_torch.utils."""
