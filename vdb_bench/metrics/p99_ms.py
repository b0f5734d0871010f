"""``p99_ms``: the 99th percentile latency of every request attempted in
the window, from its due time (open loop) or its send (closed loop) to its
answer; a refused or failed request ranks last (``readers.latency_ms``)."""

from vdb_bench.readers import latency_ms


def read(run):
    return latency_ms(run, 0.99)
