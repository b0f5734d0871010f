#!/usr/bin/env python3
"""Directed reproducer of the profiler's lost kernel records, on one GPU.

A thread that starts before the first profiler session and lives through
all of them launches a 256x256 matmul every millisecond and, every tenth,
a search of a small int8 IVF-Flat index (K1 through ctypes, its query
upload a synchronous copy). Between probe windows the process does what a
long ``chip_smoke.py`` run does before phase 17 (h): short sessions on the
main thread, threads that start, launch and end, ``empty_cache``, short
all-thread windows, and sessions opened while a short-lived thread
launches. Each probe window is ``utils/profiling._profile_window`` (300 ms,
every thread's ops) with a burst of large matmuls queued halfway through
it by a new thread.

For each window it prints the kernel launches and the launches whose
kernel was recorded, by launching thread (``launcher``, ``burst``,
``other``), CUPTI's dropped records, the clock offset, and Kineto's own
count of the records CUPTI handed over ("Processed N GPU records (B
bytes)") and of those it filtered ("Out-of-range"), read from the trace's
log (the script sets ``KINETO_LOG_LEVEL=1`` for that). The last line is a
JSON summary.

``--plain`` runs every window as the port did before CUPTI was attached
anew for each session (``_fresh_cupti`` does nothing); the default runs
the windows as they are.

    python3 scripts/profiler_lost_records.py [--plain] [--cycles 4]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time
from pathlib import Path

os.environ.setdefault("KINETO_LOG_LEVEL", "1")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import cuda_acceleratedvectordatabaseengine_tpu_torch as vdb  # noqa: E402
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import (  # noqa: E402
    profiling,
)

WINDOW_MS = 300.0
BURST_MS = 300.0
PROCESSED = re.compile(r"Processed (\d+) GPU records \((\d+) bytes\)")
OUT_OF_RANGE = re.compile(r"Out-of-range = (\d+)")


def kineto_counts(trace: dict) -> dict:
    """Kineto's counts for the session, from the log lines it writes into
    the trace (``INFO`` at ``KINETO_LOG_LEVEL`` 1)."""
    text = " ".join(str(v) for k, v in trace.items() if k != "traceEvents")
    got = {}
    if m := PROCESSED.search(text):
        got["gpu_records"], got["gpu_record_bytes"] = map(int, m.groups())
    if m := OUT_OF_RANGE.search(text):
        got["out_of_range"] = int(m.group(1))
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plain", action="store_true",
                    help="do not attach CUPTI anew for each window")
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the control flow (no kernels)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if args.plain:
        profiling._fresh_cupti = lambda: None

    rows = np.random.default_rng(0).standard_normal(
        (20_000, 128)).astype(np.float32)
    idx = vdb.IVFFlatIndex(vdb.IVFFlatConfig(dimension=128, nlist=64,
                                             dtype="int8"), device=dev)
    idx.train(rows)
    idx.add(rows)
    queries, params = rows[:32], vdb.SearchParams(nprobe=8, k=10)
    idx.search(queries, params)
    side = 8192 if on_card else 256
    big = torch.randn(side, side, device=dev)
    small = torch.randn(256, 256, device=dev)
    sync()
    t0 = time.perf_counter()
    for _ in range(4):
        big @ big
    sync()
    n_big = max(1, int(BURST_MS / ((time.perf_counter() - t0) * 1e3 / 4)))

    tids = {}
    stop = threading.Event()
    errors = []

    def launcher():
        tids["launcher"] = str(threading.get_native_id())
        try:
            if on_card:
                torch.cuda.set_device(dev)
            i = 0
            while not stop.is_set():
                small @ small
                if i % 10 == 0:
                    idx.search_async(queries, params)
                i += 1
                time.sleep(0.001)
        except Exception as e:  # noqa: BLE001 — reported at the end
            errors.append(repr(e))

    def burst():
        tids["burst"] = str(threading.get_native_id())
        for _ in range(n_big):
            big @ big

    def searches(n=3):
        if on_card:
            torch.cuda.set_device(dev)
        for _ in range(n):
            idx.search(queries, params)
            small @ small

    def sessions():             # as chip_smoke.trace_search did before
        for _ in range(8):
            idx.search(queries, params)
            sync()
            with torch.profiler.profile(
                    activities=profiling._activities()) as prof:
                idx.search(queries, params)
            prof.events()

    def thread_churn():
        workers = [threading.Thread(target=searches) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()

    def empty_cache():
        block = torch.empty(2 << 30, dtype=torch.uint8, device=dev)
        del block
        if on_card:
            torch.cuda.empty_cache()

    def short_windows():
        for _ in range(3):
            profiling._profile_window(50)

    def sessions_with_a_thread():
        for _ in range(6):
            done = threading.Event()

            def work():
                while not done.is_set():
                    idx.search(queries, params)
            worker = threading.Thread(target=work)
            worker.start()
            with torch.profiler.profile(activities=profiling._activities()):
                time.sleep(0.03)
            done.set()
            worker.join()

    def window(after: str) -> dict:
        timer = threading.Timer(WINDOW_MS / 2e3, burst)
        timer.start()
        trace, note = profiling._profile_window(WINDOW_MS)
        timer.join()
        names = {v: k for k, v in tids.items()}
        by_name = {}
        for tid, (kept, launched) in note["by_thread"].items():
            got = by_name.setdefault(names.get(tid, "other"), [0, 0])
            got[0] += kept
            got[1] += launched
        row = {"after": after, "kept": note["launches_kept"],
               "launched": note["kernel_launches"], "by_thread": by_name,
               "complete": profiling.records_complete(
                   note, profiling.RECORDS_SHARE),
               "dropped_records": note["dropped_records"],
               "clock_offset_us": note["clock_offset_us"],
               "reattach_ms": (note["fresh_cupti"] or {}).get("ms"),
               **kineto_counts(trace)}
        print("window", json.dumps(row), flush=True)
        return row

    print("device", torch.cuda.get_device_name(dev) if on_card else "cpu",
          torch.__version__,
          "plain" if args.plain else "reattach", flush=True)
    thread = threading.Thread(target=launcher, daemon=True)
    thread.start()
    time.sleep(0.2)
    rows_out = [window("nothing")]
    stages = (("sessions", sessions), ("threads", thread_churn),
              ("empty_cache", empty_cache), ("short_windows", short_windows),
              ("sessions_with_a_thread", sessions_with_a_thread))
    for _ in range(args.cycles):
        for name, stage in stages:
            stage()
            rows_out.append(window(name))
    stop.set()
    thread.join(timeout=10)
    if errors:
        print("the launcher thread failed:", errors, file=sys.stderr)
        return 1
    lost = [r for r in rows_out if not r["complete"]]
    launcher_lost = sum(r["by_thread"].get("launcher", [0, 0])[0] == 0
                        for r in rows_out)
    print(json.dumps({
        "mode": "plain" if args.plain else "reattach",
        "windows": len(rows_out), "incomplete": len(lost),
        "windows_without_a_launcher_record": launcher_lost,
        "launcher_kept": [sum(r["by_thread"].get("launcher", [0, 0])[i]
                              for r in rows_out) for i in (0, 1)],
        "kept": sum(r["kept"] for r in rows_out),
        "launched": sum(r["launched"] for r in rows_out),
        "dropped_records": sorted({r["dropped_records"] for r in rows_out}),
        "negative_clock_offsets": sum((r["clock_offset_us"] or 0) < 0
                                      for r in rows_out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
