"""``handoff_wait_ms``: median ms the coalescer's drain waited to hand a
dispatched batch to the finalize thread, which was still finishing the
batch before (the engine's ``handoff_wait`` stage, one sample a batch; its
windows reset at the window's start; in a traced run, over the untraced
lead). Nothing where the engine records no such stage."""


def read(run):
    stage = run.stages.get("handoff_wait")
    return stage["p50"] if stage else None
