"""``rerank_rows``: mean candidates an IVF-PQ search's exact rerank read a
query (the engine's ``rerank_rows`` samples, one a search: the
shortlist's real candidates over its queries): the depth served, the
index's ``rerank_k`` or the probed slots where fewer. Nothing where the
engine records no such count."""


def read(run):
    stage = run.stages.get("rerank_rows")
    return stage["mean"] if stage else None
