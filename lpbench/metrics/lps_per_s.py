"""LPs/s: LPs answered in the window over its length (host clock)."""
from lpbench.readers import lps_per_s as read  # noqa: F401
