"""ms: median due-to-answer latency of the requests due in the window."""
import functools

from lpbench.readers import latency_ms

read = functools.partial(latency_ms, q=50.0)
