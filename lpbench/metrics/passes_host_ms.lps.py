"""ms: mean over the profiled slice's solve spans of the host time in
their cast, normalize, shuffle, pack, pad and objective stages (the
program's spans)."""
from lpbench.spans import PASSES, per_solve_ms


def read(run):
    return per_solve_ms(run, PASSES)
