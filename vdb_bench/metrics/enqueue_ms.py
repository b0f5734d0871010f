"""``enqueue_ms``: median host ms of a search's enqueue, from the entry of
the index's ``search_async`` to its return (the engine's ``enqueue`` stage,
one sample a search; its windows reset at the window's start; in a traced
run, over the untraced lead). An enqueue that waits for the card reads the
card's work of the batches before it here. Nothing where the engine records
no such stage."""


def read(run):
    stage = run.stages.get("enqueue")
    return stage["p50"] if stage else None
