"""%: the kernel's bytes over its device time a call in the profiled
slice, at the HBM peak."""
from lpbench.readers import roofline

KERNEL = "rgb_kernel"


def read(run):
    return roofline(run, run.kernel_bytes, KERNEL)
