"""``window_cap_share``: the share of the coalescer's drains whose window
did not run until its deadline, because the batch's cap was queued before
it opened or while it was open: 1 − the engine's ``window_deadline`` stage
count over its ``window_wait`` count (one sample a drain; its windows reset
at the window's start; in a traced run, over the untraced lead). Nothing
where the engine records neither ``window_deadline`` nor ``window_cap``,
as an engine that ends a window only at ``max_n`` items records neither."""


def read(run):
    wait = run.stages.get("window_wait")
    if not wait or not {"window_deadline", "window_cap"} & run.stages.keys():
        return None
    deadline = run.stages.get("window_deadline", {"count": 0})
    return 1.0 - deadline["count"] / wait["count"]
