"""rovr_torch.parallel: data parallelism over torch.distributed."""
