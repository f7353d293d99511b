"""ms: 99th percentile over the same requests as queue_wait_ms.p99 of
the end of their request span less the end of their queue.wait span (the
program's spans)."""
from lpbench.spans import p99, post_wait_ms


def read(run):
    return p99(post_wait_ms(run))
