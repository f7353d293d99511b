"""ms: mean over the profiled slice's solve spans of the host time in
their solve.launch stage, the custom op's dispatch included (the
program's spans)."""
from lpbench.spans import per_solve_ms


def read(run):
    return per_solve_ms(run, ("solve.launch",))
