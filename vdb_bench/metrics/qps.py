"""``qps``: queries answered inside the window over its seconds."""

from vdb_bench import traffic


def read(run):
    c = run.cols
    inside = (c["status"] == traffic.OK) & (c["t_done"] <= run.t_close)
    return float(c["got"][inside].sum()) / run.seconds
