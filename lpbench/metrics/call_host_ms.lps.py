"""ms: host time in Solver.solve a call, before the sync (harness clock,
the window of the traced run)."""
from lpbench.readers import call_host_ms as read  # noqa: F401
