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


def _profile_window(ms: float) -> dict:
    """Profile the whole process for ``ms`` milliseconds; the Chrome trace
    as a dict."""
    with torch.profiler.profile(
        activities=_activities(),
        experimental_config=_all_threads_config(),
    ) as prof:
        time.sleep(ms / 1000.0)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="vdb-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _card_records(trace: dict) -> tuple[int, int]:
    """(kernel records, kernel launches) in a window's trace: the card's
    kernels, and the host's runtime / driver calls that launched one."""
    kernels = launches = 0
    for e in trace["traceEvents"]:
        if e.get("cat") == KERNEL_CAT:
            kernels += 1
        elif e.get("cat") in LAUNCH_CATS and LAUNCH_MARK in str(e.get("name")):
            launches += 1
    return kernels, launches


def capture_trace(ms: float) -> dict:
    """Profile the whole process for ``ms`` milliseconds (capped at
    :data:`MAX_TRACE_MS`); return the Chrome trace as a dict (its
    ``traceEvents`` list holds the ops and kernels of the window).

    Where the card is profiled, a window that lost the card's records is
    captured again, up to :data:`CAPTURE_ATTEMPTS` windows in all. A window
    lost them when it holds no kernel record, or fewer than half as many
    kernel records as kernel launches: ``torch.profiler`` now and then
    returns a window's host ops and launches with none or almost none of
    the card's kernels (on an H100, once with no kernel record and once
    with 2 kernel records beside 179 copies, while a served index launched
    kernels throughout the window). ``trace["vdbCapture"]`` gives the
    window, the number of windows taken and the kernel records and launches
    of the one returned, so a client sees a capture that lost the card's
    side."""
    ms = min(max(float(ms), 1.0), MAX_TRACE_MS)
    on_card = torch.profiler.ProfilerActivity.CUDA in _activities()
    for attempt in range(1, CAPTURE_ATTEMPTS + 1):
        trace = _profile_window(ms)
        kernels, launches = _card_records(trace)
        if not on_card or (kernels and 2 * kernels >= launches):
            break
    trace["vdbCapture"] = {"ms": ms, "attempts": attempt,
                           "kernel_records": kernels,
                           "kernel_launches": launches}
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
