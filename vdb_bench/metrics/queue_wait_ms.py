"""``queue_wait_ms``: median ms a request waited in the coalescer before
its batch was dispatched (the engine's ``queue_wait`` stage, its windows
reset at the window's start; in a traced run, over the untraced lead)."""

from vdb_bench.readers import queue_wait_ms


def read(run):
    return queue_wait_ms(run)
