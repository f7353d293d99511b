"""%: a whole call's bytes over its device time (every kernel, copy and
memset of the profiled slice, per call) at the HBM peak."""
from lpbench.readers import roofline


def read(run):
    return roofline(run, run.solve_bytes, None)
