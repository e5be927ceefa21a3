"""rovr_torch.train."""
