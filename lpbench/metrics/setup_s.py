"""s: process start to the first measured request (host clock)."""
from lpbench.readers import setup_s as read  # noqa: F401
