"""ms: mean over the profiled slice's served crowd steps of the host time
in their ``crowd.submit`` (the LPs to the host, ``submit_many``, ``flush``)
and ``crowd.wait`` (the futures' answers back onto the device) spans (the
program's spans)."""
from lpbench.crowd_trace import mean_ms


def read(run):
    if run.traffic.get("path") != "served":
        return None
    return mean_ms(run, ("crowd.submit", "crowd.wait"))
