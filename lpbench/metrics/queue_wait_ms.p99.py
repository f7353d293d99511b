"""ms: 99th percentile over the profiled slice's requests submitted at
least five max_wait_s before it ended of their queue.wait span, submit to
the flush's assembly start (the program's spans)."""
from lpbench.spans import p99, queue_wait_ms


def read(run):
    return p99(queue_wait_ms(run))
