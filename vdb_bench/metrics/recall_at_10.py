"""``recall_at_10``: the mean over every answered query of the window of
its share of the exact fp32 top-10 (``check.py``)."""


def read(run):
    return run.verdict["recall"] if run.verdict["answered_queries"] else None
