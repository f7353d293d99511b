"""ms: 99th percentile due-to-answer latency of the requests due in the
window; one never answered counts as infinite."""
import functools

from lpbench.readers import latency_ms

read = functools.partial(latency_ms, q=99.0)
