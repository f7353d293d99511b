"""ms: 99th percentile over the profiled slice's flushes of device.solve's
enqueue_ms, copy-in start to copy-out end between CUDA events on the
flush's stream, which waits on the host's launches (the program's
spans)."""
from lpbench.spans import flush_enqueue_ms, p99


def read(run):
    return p99(flush_enqueue_ms(run))
