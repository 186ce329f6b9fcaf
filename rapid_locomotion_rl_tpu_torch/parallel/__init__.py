"""Data parallelism over torch.distributed: the env axis split over ranks,
params replicated."""
