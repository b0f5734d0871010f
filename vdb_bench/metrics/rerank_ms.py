"""``rerank_ms``: median device ms of an IVF-PQ search's exact rerank (the
engine's ``rerank`` stage: CUDA events on the search's stream around the
gather of the shortlist's raw rows, their fp32 distances and the top-k,
read by the finalize after its wait; one sample a search; its windows
reset at the window's start; in a traced run, over the untraced lead).
Nothing where the engine records no such stage."""


def read(run):
    stage = run.stages.get("rerank")
    return stage["p50"] if stage else None
