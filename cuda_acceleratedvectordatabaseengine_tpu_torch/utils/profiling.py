"""Tracing and timing hooks (port of the JAX package's
``utils/profiling.py``, on ``torch.profiler``).

Two layers:
  - ``start_trace_server`` / ``trace``: device traces. ``trace`` captures
    the enclosed block; ``start_trace_server`` serves on-demand captures of
    a running process over HTTP (``GET /trace?ms=N`` answers with the
    Chrome-trace JSON of the next N ms), the counterpart of
    ``jax.profiler.start_server``, which torch does not have. Both record
    CPU ops and, where CUDA is present, every kernel on the card (CUPTI sees
    the kernels the package launches through ctypes too), and open in
    ``chrome://tracing`` or Perfetto;
  - ``Timer`` / ``timed``: wall-clock spans feeding the metrics layer.
"""

from __future__ import annotations

import collections
import contextlib
import http.server
import json
import os
import tempfile
import threading
import time
import urllib.parse
from typing import Callable

import torch

MAX_TRACE_MS = 10_000   # longest capture one request may ask for
CAPTURE_ATTEMPTS = 3    # windows per capture while the card's records miss
KERNEL_CAT = "kernel"   # the trace category of the card's kernels
COPY_CAT = "gpu_memcpy"  # ... and of its copies
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # host API calls ...
LAUNCH_MARK = "LaunchKernel"                   # ... of these, the launches


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _all_threads_config():
    """Record the CPU ops of every thread (the serving threads, not only
    the capturing one) where this torch offers it; None keeps the default,
    which records the calling thread's ops and every kernel on the card."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:   # a torch without the option
        return None


def _synchronize_ms(on_card: bool) -> float | None:
    """Wait for every kernel queued on the current card; the host ms the
    wait took (the card's backlog), None without a card."""
    if not on_card:
        return None
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile_window(ms: float, all_threads: bool = True) -> tuple[dict,
                                                                   dict]:
    """Profile the whole process for ``ms`` milliseconds; the Chrome trace
    as a dict, and a note of the window (:func:`_window_note`).
    ``all_threads`` False records the calling thread's CPU ops only (the
    card's records and every thread's runtime calls still): the windows
    of :func:`capture_trace` record every thread.

    Where the card is profiled, the card is synchronized before the
    profiler starts and again before it stops: the profiler keeps only the
    card's records that fall inside its window, so a window closed while
    the card still runs the kernels launched in it drops their records (on
    an H100, 96% of the launches of a window's last fifth behind a 0.9 s
    backlog, none with the waits), and a backlog left from before the
    window would straddle its start. The host ms of each wait go into the
    note (``backlog_ms``)."""
    on_card = torch.profiler.ProfilerActivity.CUDA in _activities()
    backlog = [_synchronize_ms(on_card)]
    t_start = time.time_ns()
    with torch.profiler.profile(
        activities=_activities(),
        experimental_config=_all_threads_config() if all_threads else None,
    ) as prof:
        time.sleep(ms / 1000.0)
        backlog.append(_synchronize_ms(on_card))
    t_stop = time.time_ns()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="vdb-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    note = _window_note(trace)
    note.update(all_threads=all_threads, backlog_ms=backlog,
                host_ms=(t_stop - t_start) / 1e6)
    return trace, note


def _span(events) -> list | None:
    """[first start, last end] of trace events, in the trace's µs (None
    when none has a time)."""
    timed = [e for e in events if "ts" in e]
    if not timed:
        return None
    return [min(float(e["ts"]) for e in timed),
            max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed)]


def _correlation(event: dict):
    return (event.get("args") or {}).get("correlation")


def _kept_by_fifth(launched: dict, recorded: dict) -> list | None:
    """Share of the launches (correlation → time) in each fifth of their
    time span whose kernel is among ``recorded``; None without launches."""
    if not launched:
        return None
    t0, t1 = min(launched.values()), max(launched.values())
    width = (t1 - t0) / 5 or 1.0
    total, kept = [0] * 5, [0] * 5
    for c, t in launched.items():
        i = min(int((t - t0) / width), 4)
        total[i] += 1
        kept[i] += c in recorded
    return [round(k / n, 3) if n else None for k, n in zip(kept, total)]


def _window_note(trace: dict) -> dict:
    """What a window holds of the card's side: kernel records, kernel
    launches (the host's runtime / driver calls that launched one) and
    copies, the time span of each and of the host's ops (so a window whose
    kernels fall outside its span shows it), its three commonest kernel
    names with their counts, and the profiler's own warnings or errors
    where its trace carries any. Launches and kernel records pair up by
    their correlation id: ``launch_to_kernel_us`` is the least and the
    median time from a launch to its kernel's start (below 0 the card's
    clock and the host's disagree), and ``kept_by_fifth`` the share of
    the launches in each fifth of their span whose kernel was recorded
    (where in the window records went missing)."""
    kernels, launches, copies, host = [], [], [], []
    for e in trace["traceEvents"]:
        cat = e.get("cat")
        if cat == KERNEL_CAT:
            kernels.append(e)
        elif cat == COPY_CAT:
            copies.append(e)
        elif cat in LAUNCH_CATS and LAUNCH_MARK in str(e.get("name")):
            launches.append(e)
        elif cat == "cpu_op":
            host.append(e)
    names = collections.Counter(str(e.get("name"))[:60] for e in kernels)
    launched = {_correlation(e): float(e["ts"]) for e in launches
                if "ts" in e and _correlation(e) is not None}
    recorded = {_correlation(e): float(e["ts"]) for e in kernels
                if "ts" in e and _correlation(e) is not None}
    lags = sorted(t - launched[c] for c, t in recorded.items()
                  if c in launched)
    note = {"kernel_records": len(kernels), "kernel_launches": len(launches),
            "copy_records": len(copies),
            "span_us": {"host_ops": _span(host), "launches": _span(launches),
                        "kernels": _span(kernels), "copies": _span(copies)},
            "top_kernels": [list(nc) for nc in names.most_common(3)],
            "launch_to_kernel_us": ([lags[0], lags[len(lags) // 2]]
                                    if lags else None),
            "kept_by_fifth": _kept_by_fifth(launched, recorded)}
    said = {k: str(v)[:1000] for k, v in trace.items()
            if any(w in k.lower() for w in ("warn", "error"))}
    if said:
        note["profiler_said"] = said
    return note


def capture_trace(ms: float) -> dict:
    """Profile the whole process for ``ms`` milliseconds (capped at
    :data:`MAX_TRACE_MS`); return the Chrome trace as a dict (its
    ``traceEvents`` list holds the ops and kernels of the window).

    Where the card is profiled, a window that lost the card's records is
    captured again, up to :data:`CAPTURE_ATTEMPTS` windows in all. A window
    lost them when it holds no kernel record, or fewer than half as many
    kernel records as kernel launches: ``torch.profiler`` now and then
    returns a window's host ops, launches and copies with none or almost
    none of the card's kernels (on an H100 late in a long process under
    serving load: once with no kernel record, once with 2 beside 179
    copies, once three windows in a row with none for 4,377 launches). The
    waits of :func:`_profile_window` do not prevent it, and a lost state
    can outlast several windows; its cause is not known.
    ``trace["vdbCapture"]`` gives the window, the number of windows taken,
    the kernel records and launches of the one returned, and ``windows``,
    the note of every window taken (:func:`_profile_window`), so a client
    sees a capture that lost the card's side and what each window held."""
    ms = min(max(float(ms), 1.0), MAX_TRACE_MS)
    on_card = torch.profiler.ProfilerActivity.CUDA in _activities()
    windows = []
    for attempt in range(1, CAPTURE_ATTEMPTS + 1):
        trace, note = _profile_window(ms)
        windows.append(note)
        kernels, launches = note["kernel_records"], note["kernel_launches"]
        if not on_card or (kernels and 2 * kernels >= launches):
            break
    trace["vdbCapture"] = {"ms": ms, "attempts": attempt,
                           "kernel_records": kernels,
                           "kernel_launches": launches, "windows": windows}
    return trace


def start_trace_server(port: int = 9012) -> http.server.ThreadingHTTPServer:
    """Serve on-demand traces on ``port`` (0 picks one): ``GET
    /trace?ms=N`` profiles the process for N ms (default 1000, at most
    :data:`MAX_TRACE_MS`; see :func:`capture_trace`) and answers with the
    Chrome-trace JSON; a second
    capture while one runs gets 409. Runs on a daemon thread; returns the
    HTTP server (``server_address[1]`` is the bound port, ``shutdown()``
    stops it). Raises ``OSError`` when the port is taken."""
    capturing = threading.Lock()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            url = urllib.parse.urlsplit(self.path)
            if url.path != "/trace":
                self._send(404, b"not found\n", "text/plain")
                return
            query = urllib.parse.parse_qs(url.query)
            try:
                ms = float(query.get("ms", ["1000"])[0])
            except ValueError:
                self._send(400, b"ms must be a number\n", "text/plain")
                return
            if not capturing.acquire(blocking=False):
                self._send(409, b"a capture is running\n", "text/plain")
                return
            try:
                body = json.dumps(capture_trace(ms)).encode()
            finally:
                capturing.release()
            self._send(200, body, "application/json")

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet — structured logs only
            pass

    server = http.server.ThreadingHTTPServer(("", port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="vdb-trace-http",
                     daemon=True).start()
    return server


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """Run the enclosed block inside a ``record_function(name)`` range;
    with ``log_dir``, also profile it (CPU + CUDA) and write the Chrome
    trace ``<log_dir>/<name>.<pid>.<ns>.json``."""
    if not log_dir:
        with torch.profiler.record_function(name):
            yield
        return
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        with torch.profiler.record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{name}.{os.getpid()}.{time.time_ns()}.json"))


class Timer:
    """Accumulating wall-clock span timer."""

    def __init__(self):
        self.total_s = 0.0
        self.count = 0

    @contextlib.contextmanager
    def span(self):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.total_s += time.monotonic() - t0
            self.count += 1

    @property
    def avg_ms(self) -> float:
        return 1000.0 * self.total_s / self.count if self.count else 0.0


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists and
    dicts are walked)."""
    found = set()
    stack = [out]
    while stack:
        obj = stack.pop()
        if isinstance(obj, torch.Tensor):
            if obj.is_cuda:
                found.add(obj.device)
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
    return found


def timed(fn: Callable, *args, **kwargs):
    """Run fn, returning (result, elapsed_ms); synchronises every CUDA
    device its output lives on, so the time covers the device's work, not
    only the launches."""
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out, (time.monotonic() - t0) * 1000.0
