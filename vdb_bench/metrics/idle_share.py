"""The device's idle share over the traced windows."""

from vdb_bench.readers import idle_share


def read(run):
    return idle_share(run)
