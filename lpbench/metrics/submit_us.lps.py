"""us: mean host time in BatchScheduler.submit over the window's requests
(harness clock)."""
from lpbench.readers import submit_us as read  # noqa: F401
