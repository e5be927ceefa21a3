"""rovr_torch.parallel: the (data, model) mesh over torch.distributed: data,
tensor, pipeline and expert parallelism, ring attention, the dry run."""
