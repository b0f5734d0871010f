"""Reductions shared by the metric readers of ``metrics/``: each reader
file names one metric and calls one of these on the run."""

from __future__ import annotations

import math

import numpy as np

from vdb_bench import trace, traffic

FAILED_MS = 1e9    # a percentile that falls on a refused or failed request

SEARCH_RANGES = ("ivf_flat.upload", "ivf_flat.coarse_probe",
                 "ivf_flat.finalize")
BATCH_RANGE = "ivf_flat.coarse_probe"   # one a dispatched search
K1_KERNEL = "grouped_scan_tc_kernel"


def _inside(t0: float, window: dict) -> bool:
    lo, hi = window["span_us"]
    return lo <= t0 < hi


def latency_ms(run, q: float) -> float | None:
    """The ``q`` quantile (nearest rank) of the latency of every request
    attempted in the window, from its due time (open loop) or its send
    (closed loop) to its answer. A refused or failed request misses every
    limit: it ranks last, and a quantile that falls on one reads
    :data:`FAILED_MS`."""
    c = run.cols
    due = c["t_due"] < run.t_close
    lat = np.where(c["status"] == traffic.OK,
                   (c["t_done"] - c["t_due"]) * 1e3, math.inf)[due]
    if not lat.size:
        return None
    v = float(np.sort(lat)[math.ceil(q * lat.size) - 1])
    return FAILED_MS if math.isinf(v) else v


def queue_wait_ms(run) -> float | None:
    """Median of the engine's ``queue_wait`` stage (``MetricsCollector``):
    ms from ``submit_search`` to the dispatch of the request's batch."""
    stage = run.stages.get("queue_wait")
    return stage["p50"] if stage else None


def search_host_ms(run) -> float | None:
    """Host ms a dispatched search spends inside the search module's
    ranges (upload, coarse probe, finalize: the copy back, its wait and the
    id map), over the ranges that start inside the traced windows."""
    total = batches = 0.0
    for w in run.windows:
        for t0, t1, name in w["ranges"]:
            if name in SEARCH_RANGES and _inside(t0, w):
                total += t1 - t0
                batches += name == BATCH_RANGE
    return total / 1e3 / batches if batches else None


def idle_share(run) -> float | None:
    """1 − (time in which a device operation ran) / (time traced), over
    the traced windows."""
    busy, span = trace.busy_and_span(run.windows)
    return 1.0 - busy / span if span > 0 and run.on_card else None


def k1_roofline(run) -> float | None:
    """K1's share of its roofline, in %: the bound of the traced searches
    over K1's device time in the traced windows. Each search of a b64 cell
    is one request's batch; the trace cannot name a launch's request, so
    each traced search takes the mean bound of the window's answered
    requests (``run.batch_bounds()``: the index kind's ``bounds``)."""
    k1_us = batches = k1_launches = 0
    for w in run.windows:
        for t0, t1, name, _cat in w["device"]:
            if K1_KERNEL in name and _inside(t0, w):
                k1_us += t1 - t0
                k1_launches += 1
        for t0, _t1, name in w["ranges"]:
            batches += name == BATCH_RANGE and _inside(t0, w)
    run.log(f"k1_roofline: {batches} searches and {k1_launches} K1 "
            f"launches in the traced windows, K1 {k1_us / 1e3:.3f} ms")
    bounds = run.batch_bounds() if k1_us > 0 and batches else []
    if not bounds:
        return None
    mean_bound_s = sum(bounds) / len(bounds)
    return 100.0 * batches * mean_bound_s / (k1_us / 1e6)
