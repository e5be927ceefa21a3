"""rovr_torch.models."""
