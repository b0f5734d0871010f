"""``window_wait_ms``: median ms the coalescer's drain waited out the
coalescing window after a drain's first request (the engine's
``window_wait`` stage: one sample a drain, 0.0 where the drain found its
cap queued; its windows reset at the window's start; in a traced run, over
the untraced lead). Nothing where the engine records no such stage."""


def read(run):
    stage = run.stages.get("window_wait")
    return stage["p50"] if stage else None
