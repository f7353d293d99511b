"""LPs: LPs a flush over the window, from the scheduler's ServeMetrics
counters (n_solved / n_flushes)."""
from lpbench.readers import flush_lps as read  # noqa: F401
