"""K2's share of its roofline in %: the bound of the traced searches over
the device time of K2's kernels (``pq_table_kernel``,
``pq_table_scan_kernel``) in the traced windows. Each search of a b64 cell
is one request's batch, counted by its ``ivf_pq.upload`` range (a search
replayed from CUDA graphs opens no ``ivf_pq.coarse_probe`` range); the
trace cannot name a launch's request, so each traced search takes the
mean bound of the window's answered requests (``run.batch_bounds()``: the
index kind's ``bounds``, ``roofline_pq.grouped_pq_scan_bound``). Nothing
where the windows hold no K2 launch or no such search."""

K2_KERNELS = ("pq_table_kernel", "pq_table_scan_kernel")
BATCH_RANGE = "ivf_pq.upload"


def _inside(t0, window):
    lo, hi = window["span_us"]
    return lo <= t0 < hi


def read(run):
    k2_us = batches = launches = 0
    for w in run.windows:
        for t0, t1, name, _cat in w["device"]:
            if any(k in name for k in K2_KERNELS) and _inside(t0, w):
                k2_us += t1 - t0
                launches += 1
        for t0, _t1, name in w["ranges"]:
            batches += name == BATCH_RANGE and _inside(t0, w)
    run.log(f"k2_roofline: {batches} searches and {launches} K2 launches "
            f"in the traced windows, K2 {k2_us / 1e3:.3f} ms")
    bounds = run.batch_bounds() if k2_us > 0 and batches else []
    if not bounds:
        return None
    mean_bound_s = sum(bounds) / len(bounds)
    return 100.0 * batches * mean_bound_s / (k2_us / 1e6)
