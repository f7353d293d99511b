"""ms: mean over the profiled slice's crowd steps of the host time in
their ``crowd.build`` span (the neighbour grid and the ORCA rows; the
program's spans)."""
from lpbench.crowd_trace import mean_ms


def read(run):
    return mean_ms(run, ("crowd.build",))
