"""Host ms a dispatched search spends in ``models/ivf_flat``'s upload,
coarse-probe and finalize ranges, from the traced windows."""

from vdb_bench.readers import search_host_ms


def read(run):
    return search_host_ms(run)
