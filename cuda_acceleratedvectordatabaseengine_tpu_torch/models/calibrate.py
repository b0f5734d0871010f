"""Probe-coverage calibration (PyTorch port of
``cuda_acceleratedvectordatabaseengine_tpu/models/calibrate.py``).

Coverage(P) = the fraction of exact top-``k`` neighbours whose inverted list
is among a query's first ``P`` coarse probes: the quantization-independent
part of recall. The smallest ``nprobe`` meeting a coverage target is the
cheapest operating point that can reach that recall on the caller's data.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.normalize import (
    l2_normalize,
)


def sample_stored_rows(arena, sample: int, seed: int = 0) -> np.ndarray:
    """``sample`` dequantized stored rows of a ``PackedListArena`` as
    stand-in queries (slightly optimistic for coverage: a stored row sits at
    the heart of its own list)."""
    rng = np.random.default_rng(seed)
    counts_h = arena.counts.cpu().numpy()
    lists_h = np.flatnonzero(counts_h > 0)
    lists_s = rng.choice(lists_h, size=sample)
    slots_s = (rng.random(sample) * counts_h[lists_s]).astype(np.int64)
    dev = arena.device
    li = torch.from_numpy(lists_s).to(dev)
    si = torch.from_numpy(slots_s).to(dev)
    rows = arena.arena[li, si].float()
    if arena.arena_scale is not None:
        rows = rows * arena.arena_scale[li, si][:, None]
    if arena.anchors is not None:
        rows = rows + arena.anchors[li]
    return rows.cpu().numpy()


def true_lists(ids_table: np.ndarray, ids: np.ndarray):
    """The list holding each id of ``ids`` through the ``[nlist, capacity]``
    id table: ``(matched, lists)``, ``matched`` False where the id is not
    resident, and ``lists`` of shape ``ids.shape + (2,)``: the lists of its
    first and its second resident copy (a multi-assigned row has two,
    adjacent in the sorted table; without one, the first's list again)."""
    cap = ids_table.shape[1]
    flat = np.asarray(ids_table).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sflat = flat[order]
    want = ids.astype(np.uint64)
    last = max(sflat.size - 1, 0)
    locs = np.clip(np.searchsorted(sflat, want), 0, last)
    matched = sflat[locs] == want
    locs2 = np.minimum(locs + 1, last)
    second = matched & (locs2 != locs) & (sflat[locs2] == want)
    locs2 = np.where(second, locs2, locs)
    lists = (order[np.stack([locs, locs2], -1)] // cap).astype(np.int64)
    return matched, lists


def probe_coverage_calibrate(
    *,
    centroids: torch.Tensor,
    metric: Metric,
    ids_table: np.ndarray,
    queries: np.ndarray,
    exact_search_fn,
    target_coverage: float = 0.99,
    k: int = 10,
    candidates: tuple = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128),
    query_transform=None,
) -> dict:
    """Measure the coverage curve and pick the smallest candidate meeting
    ``target_coverage``.

    ``ids_table`` is the ``[nlist, capacity]`` id layout (a true id with
    two resident copies counts as covered where either copy's list is
    probed); ``exact_search_fn(queries, k)`` returns the full-probe
    top-``k`` ``(dists, ids)`` on the index's stored representation. ``query_transform`` (optional) maps the
    queries, as a tensor on the centroids' device, into the frame the
    centroids live in (an OPQ rotation) before the coarse ranking; the
    exact search gets the untransformed queries. When coverage plateaus
    below target on every candidate, the knee (smallest candidate within 1%
    absolute of the best) is chosen and ``coverage_limited`` is set, rather
    than silently escalating to a full scan.
    """
    nlist = ids_table.shape[0]
    queries = np.ascontiguousarray(queries, np.float32)

    _, ids_true = exact_search_fn(queries, k)
    ids_true = np.asarray(ids_true)

    # list of each ground-truth id (either copy) via the id table
    matched, lists = true_lists(ids_table, ids_true)

    # coarse rank of each true list per query; a replicated id is covered
    # at the earlier of its two copies' ranks
    q = torch.from_numpy(queries).to(centroids.device)
    if query_transform is not None:
        q = query_transform(q)
    if metric == Metric.COSINE:
        q = l2_normalize(q)
    coarse_metric = (
        Metric.INNER_PRODUCT if metric == Metric.INNER_PRODUCT else Metric.L2
    )
    coarse = pairwise_distance(q, centroids, coarse_metric)
    order = torch.argsort(coarse, dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(nlist, device=order.device).expand_as(
            order).contiguous())
    want = torch.from_numpy(
        np.clip(lists, 0, nlist - 1).reshape(lists.shape[0], -1)
    ).to(ranks.device)
    rank_of_true = (
        ranks.gather(1, want).reshape(lists.shape).amin(-1).cpu().numpy()
    )
    valid = matched & (ids_true != INVALID_ID)
    n_valid = max(int(valid.sum()), 1)
    curve = {}
    for p in sorted(set(int(c) for c in candidates) | {nlist}):
        if p > nlist:
            continue
        curve[p] = float((rank_of_true[valid] < p).sum() / n_valid)
    cand_curve = {p: c for p, c in curve.items() if p < nlist}
    chosen = next(
        (p for p in sorted(cand_curve) if cand_curve[p] >= target_coverage),
        None,
    )
    coverage_limited = chosen is None and bool(cand_curve)
    if coverage_limited:
        best = max(cand_curve.values())
        chosen = min(p for p, c in cand_curve.items() if c >= best - 0.01)
    elif chosen is None:
        chosen = nlist
    return {
        "nprobe": int(chosen),
        "coverage": curve.get(chosen, 1.0),
        "coverage_limited": coverage_limited,
        "curve": curve,
        "target": target_coverage,
        "sample": queries.shape[0],
    }
