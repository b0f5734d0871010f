"""Host ms a dispatched search spends in ``models/ivf_pq``'s upload,
coarse-probe or shortlist (the replay of the captured coarse probe, K2 and
top-R) and finalize ranges (the finalize holds the copy back, its wait for
the card and the id map), over the ranges that start inside the traced
windows, a search counted by its upload range. Nothing where the windows
hold no such search."""

SEARCH_RANGES = ("ivf_pq.upload", "ivf_pq.coarse_probe", "ivf_pq.shortlist",
                 "ivf_pq.finalize")
BATCH_RANGE = "ivf_pq.upload"


def read(run):
    total = batches = 0.0
    for w in run.windows:
        lo, hi = w["span_us"]
        for t0, t1, name in w["ranges"]:
            if name in SEARCH_RANGES and lo <= t0 < hi:
                total += t1 - t0
                batches += name == BATCH_RANGE
    return total / 1e3 / batches if batches else None
