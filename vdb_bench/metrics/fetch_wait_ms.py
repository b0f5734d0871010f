"""``fetch_wait_ms``: median ms the search module's finalize waited for its
batch's device work before copying the answer back (the engine's
``fetch_wait`` stage, one sample a search; its windows reset at the
window's start; in a traced run, over the untraced lead). Nothing where the
engine records no such stage."""


def read(run):
    stage = run.stages.get("fetch_wait")
    return stage["p50"] if stage else None
