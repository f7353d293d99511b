"""%: a crowd step's build bytes (``lpbench/crowd_peaks.py``: the agents'
state read once, their LPs written once) over the device time of the work
launched inside its ``crowd.build`` range (the profiler's launch
correlation), per step of the profiled slice, at the HBM peak."""
from lpbench import crowd_peaks, peaks


def read(run):
    c = run.counters.get("crowd") or {}
    if not c.get("build_device_s") or not c.get("build_ranges"):
        return None
    nbytes = crowd_peaks.build_bytes(c["agents"], c["rows"] / c["steps"],
                                     run.config["dtype"])
    return peaks.roofline_share(nbytes,
                                c["build_device_s"] / c["build_ranges"])
