"""The judgement of a run: every answer of the window against the plain
reference.

An answer is one request's ``(d [m, k], ids [m, k])`` as ``finish_search``
returned it. Four numbers are compared, each with its limit from the
configuration file (``limits``):

- ``missing`` (limit 0): queries of the window that got no answer row: a
  request that failed inside the program (not a refusal by admission,
  which is an answer, counted in ``failed`` and as a missed latency), a
  short answer, or callers still waiting a minute past the close;
- ``malformed`` (limit 0): answer rows with an id outside the corpus (the
  empty-slot sentinel included), an id twice, or distances not ascending;
- ``dist_err``: the widest gap between a returned distance and the exact
  squared distance from the query to the row of the returned id (fp64, from
  the corpus as generated), as a share of ``|q|²`` (the scale of the
  rounding of ``|q|² − 2 q·x + |x|²``). It holds the distance arithmetic
  and the id map: a wrong id reads the distance of another row;
- ``recall_at_10``: the mean over every answered query of the share of its
  exact fp32 top-k (``reference/exact.exact_topk``) among its ids, at
  least the configuration's limit. The corpus spreads each query's exact
  top-k over all the lists its search probes (``corpus.py``), so this holds
  the build (k-means, list assignment), the coarse probe and the scan's
  top-k over every probed list: a list left out, or read wrong, costs
  about ``1 / nprobe`` of it.
"""

from __future__ import annotations

import numpy as np
import torch

from vdb_bench import traffic
from vdb_bench.reference import exact

AT_MOST = ("missing", "malformed", "dist_err")


def judge(cols: dict, pool_dev, truth_i, corpus, cfg: dict,
          ended: bool) -> dict:
    """The verdict on a window's requests (``traffic.Log.columns``)."""
    n = corpus.n
    k = truth_i.shape[1]
    per_request = cols["rows"].shape[1]
    status, got = cols["status"], cols["got"]
    ok = status == traffic.OK
    missing = ((0 if ended else 1)
               + int((status == traffic.ERROR).sum()) * per_request
               + int((per_request - got[ok]).sum()))
    answered = np.arange(per_request)[None, :] < got[ok][:, None]
    rows = cols["rows"][ok][answered]
    ids = cols["ids"][ok][answered]
    dists = cols["d"][ok][answered].astype(np.float64)
    bad = ids >= np.uint64(n)
    srt = np.sort(ids, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    unsorted = (np.diff(dists, axis=1) < 0).any(1)
    malformed = int((bad.any(1) | dup | unsorted).sum())

    dev = pool_dev.device
    ids_i = torch.from_numpy(np.where(bad, 0, ids).astype(np.int64)).to(dev)
    q_rows = torch.from_numpy(rows.astype(np.int64)).to(dev)
    q_index = q_rows.repeat_interleave(k)
    d_ref = exact.pair_distances(pool_dev, q_index, ids_i.reshape(-1),
                                 corpus.chunks())
    q = pool_dev.double()
    q_sq = (q * q).sum(1)[q_index]
    gap = (torch.from_numpy(dists.reshape(-1)).to(dev) - d_ref).abs() / q_sq
    fine = torch.from_numpy(~bad.reshape(-1)).to(dev)
    dist_err = float(gap[fine].max()) if bool(fine.any()) else float("inf")
    hits = (ids_i[:, :, None] == truth_i[q_rows][:, None, :]).any(2)
    hits &= ~torch.from_numpy(bad).to(dev)
    recall = float(hits.float().sum(1).mean() / k) if len(rows) else 0.0

    lim = cfg["limits"]
    checks = {"missing": [missing, lim["missing"]],
              "malformed": [malformed, lim["malformed"]],
              "dist_err": [dist_err, lim["dist_err"]],
              "recall_at_10": [recall, lim["recall_at_10"]]}
    correct = (all(checks[c][0] <= checks[c][1] for c in AT_MOST)
               and recall >= lim["recall_at_10"])
    return {"correct": bool(correct), "checks": checks, "recall": recall,
            "answered_queries": int(len(rows))}
