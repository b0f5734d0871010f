"""``p50_ms``: the median latency of every request attempted in the
window, from its due time (open loop) to its answer; a refused or failed
request ranks last (``readers.latency_ms``)."""

from vdb_bench.readers import latency_ms


def read(run):
    return latency_ms(run, 0.5)
