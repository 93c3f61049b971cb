"""Multi-GPU training: the env axis split over torch.distributed ranks
(counterpart of mjlab_tpu/parallel)."""
