"""``arena_gb``: the index's device bytes as it accounts them
(``memory_stats()["total_bytes"]``: arena, norms, counts, centroids)."""


def read(run):
    return run.arena_bytes / 1e9
