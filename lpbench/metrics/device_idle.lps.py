"""%: share of the profiled slice with no CUDA activity (torch.profiler)."""
from lpbench.readers import device_idle as read  # noqa: F401
