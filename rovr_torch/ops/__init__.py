"""rovr_torch.ops."""
