"""Profiler windows of a traced run and their reduction to what the
per-layer readers need.

A window is one ``utils/profiling.profiler_session`` of the port (CUPTI
attached anew, the card waited for at both ends), around a marker range
``vdb_bench.window`` in which the benchmark only sleeps while its callers
drive the engine. A window counts only where the profiler kept at least
``RECORDS_SHARE`` of its kernel launches as kernel records
(``records_complete``); the others are dropped, and a reader that finds no
window returns nothing.

Each kept window is reduced at once (its trace is large): the device's
intervals (kernels, copies, memsets) with their names, and the named host
ranges (``record_function``) of every thread.
"""

from __future__ import annotations

import time

from torch.profiler import record_function

MARKER = "vdb_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
WINDOW_S = 1.0          # length of one profiler window
WINDOWS = 4             # most windows a traced run takes
GAP_S = 0.5             # traffic between two windows (and after an export)


def _reduce(trace: dict) -> dict | None:
    events = trace.get("traceEvents", [])
    marks = [e for e in events if e.get("name") == MARKER
             and e.get("cat") in HOST_CATS and "dur" in e]
    if not marks:
        return None
    m0 = float(marks[0]["ts"])
    m1 = m0 + float(marks[0]["dur"])
    device, ranges = [], set()
    for e in events:
        if "ts" not in e or "dur" not in e:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append((t0, t1, str(e.get("name")), cat))
        elif cat == "user_annotation" and e.get("name") != MARKER:
            ranges.add((t0, t1, str(e.get("name"))))
    # a range can be exported twice (once per thread collection), the same
    # start, length and name: it is one range
    return {"span_us": (m0, m1), "device": device, "ranges": sorted(ranges)}


def warm_profiler() -> None:
    """One throwaway profiler session. A process's first session starts
    the profiler's machinery: on an H100 its start took 8.5 s while the
    callers' requests crawled, and it recorded no kernel at all; the
    sessions after it started in 0.05 s and kept every launch. A traced
    run pays this in its set-up, before the window."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import (
        profiling,
    )

    with profiling.profiler_session(all_threads=True):
        time.sleep(0.01)


def take_windows(should_stop, log=print) -> list[dict]:
    """Take up to :data:`WINDOWS` profiler windows of the running process
    (fewer where ``should_stop()`` says the traffic is ending); returns the
    reduced windows that pass the records gate, each with its gate note.
    Each window's trace is exported before the next session starts: a
    session attaches CUPTI anew, and an earlier session exported after that
    reads every kernel and launch at time 0 (seen on an H100)."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import (
        profiling,
    )

    kept = []
    for i in range(1, WINDOWS + 1):
        if should_stop():
            break
        with profiling.profiler_session(all_threads=True) as (prof, _info):
            with record_function(MARKER):
                time.sleep(WINDOW_S)
        trace = profiling.chrome_trace(prof)
        del prof
        note = profiling._window_note(trace)
        ok = profiling.records_complete(note, profiling.RECORDS_SHARE)
        log(f"trace window {i}: {note['launches_kept']} of "
            f"{note['kernel_launches']} launches kept as records"
            f"{'' if ok else ' (dropped: under the records gate)'}; "
            f"kernels {note['span_us']['kernels']} µs, launch to kernel "
            f"{note['launch_to_kernel_us']} µs")
        window = _reduce(trace) if ok else None
        del trace
        if window is not None:
            window["note"] = {k: note[k] for k in
                              ("kernel_records", "kernel_launches",
                               "launches_kept")}
            kept.append(window)
        time.sleep(GAP_S)
    return kept


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(t0, t1, ...)`` intervals clipped to
    ``[lo, hi]``."""
    total, end = 0.0, lo
    for t0, t1, *_ in sorted(intervals):
        t0, t1 = max(t0, end), min(t1, hi)
        if t1 > t0:
            total += t1 - t0
            end = t1
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, end = [], lo
    for t0, t1, *_ in sorted(intervals):
        if t0 > end and t0 <= hi:
            gaps.append((end, min(t0, hi)))
        end = max(end, t1)
    if end < hi:
        gaps.append((end, hi))
    return gaps


def busy_and_span(windows) -> tuple[float, float]:
    """Seconds in which a device operation ran, and seconds traced, summed
    over ``windows`` (inside each marker)."""
    busy = span = 0.0
    for w in windows:
        lo, hi = w["span_us"]
        busy += union_us(w["device"], lo, hi)
        span += hi - lo
    return busy / 1e6, span / 1e6


def _open_range(ranges, t: float) -> str:
    """The innermost named host range open at ``t`` on any thread."""
    best = None
    for t0, t1, name in ranges:
        if t0 <= t <= t1 and (best is None or t1 - t0 < best[0]):
            best = (t1 - t0, name)
    return best[1] if best else "no host range open"


def breakdown(windows, top: int = 10) -> dict:
    """The device operations that took most time, and the idle stretches
    summed by the host range open at their middle (seconds)."""
    ops: dict[str, float] = {}
    idle: dict[str, float] = {}
    for w in windows:
        lo, hi = w["span_us"]
        for t0, t1, name, _cat in w["device"]:
            cut = min(t1, hi) - max(t0, lo)
            if cut > 0:
                ops[name[:120]] = ops.get(name[:120], 0.0) + cut / 1e6
        for g0, g1 in idle_gaps(w["device"], lo, hi):
            label = _open_range(w["ranges"], (g0 + g1) / 2)
            idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
