"""Tracing hooks (port of the JAX package's ``utils/profiling.py``, on
``torch.profiler``).

Two layers:
  - ``trace``: the named range of every span of the port (the search
    module's stages, the serving engine's waits and handoffs). It opens a
    ``record_function`` range only while a profiler runs, so the range
    lies on the profiler's clock beside the card's kernels; otherwise it
    costs one read of the profiler's module flag. A span can also record
    its duration as a serving stage with the recorder it is given
    (``MetricsCollector.record_stage``): the stage sample and the range
    then come from one block. With a ``log_dir``, ``trace`` also profiles
    the block and writes its Chrome trace;
  - ``start_trace_server`` / :func:`profiler_session`: device traces.
    ``start_trace_server`` serves on-demand captures of a running process
    over HTTP (``GET /trace?ms=N`` answers with the Chrome-trace JSON of
    the next N ms), the counterpart of ``jax.profiler.start_server``,
    which torch does not have. Both record CPU ops and, where CUDA is
    present, every kernel on the card (CUPTI sees the kernels the package
    launches through ctypes too), and open in ``chrome://tracing`` or
    Perfetto. Each session attaches CUPTI anew and waits for the card at
    its ends (:func:`profiler_session`), so a window keeps the kernels of
    every thread; :func:`records_complete` tells whether it did.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import http.server
import json
import os
import tempfile
import threading
import time
import urllib.parse

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_TRACE_MS = 10_000   # longest capture one request may ask for
CAPTURE_ATTEMPTS = 3    # windows per capture while the card's records miss
KERNEL_CAT = "kernel"   # the trace category of the card's kernels
COPY_CAT = "gpu_memcpy"  # ... and of its copies
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # host API calls ...
LAUNCH_MARK = "LaunchKernel"                   # ... of these, the launches
CLOCK_PAD_MS = 20.0     # wait after a session starts and before it stops
IDLE_MS = 1.0           # a wait for the card this short found it idle
DRAIN_WAITS = 5         # waits before a stop until one finds the card idle
RECORDS_SHARE = 0.99    # least share of launches a complete window records


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


def _cupti_library():
    """The CUPTI library this process has loaded (torch loads it with its
    CUDA libraries), or None."""
    try:
        with open("/proc/self/maps") as maps:
            for line in maps:
                if "libcupti" in line:
                    return ctypes.CDLL(line.split()[-1])
    except OSError:
        pass
    return None


def _fresh_cupti() -> dict | None:
    """Detach CUPTI from the process: flush its buffers, then
    ``cuptiFinalize`` (CUPTI's documented condition for calling it outside
    a CUDA call's exit: the card synchronized and the buffers flushed).
    The next ``torch.profiler`` session attaches CUPTI anew, so every
    thread's launches are traced again (see :func:`profiler_session`).
    Returns CUPTI's return codes and the host ms, or None where no CUPTI
    is loaded."""
    lib = _cupti_library()
    if lib is None:
        return None
    t0 = time.perf_counter()
    flushed = lib.cuptiActivityFlushAll(1)   # CUPTI_ACTIVITY_FLAG_FLUSH_FORCED
    finalized = lib.cuptiFinalize()
    return {"flush_rc": flushed, "finalize_rc": finalized,
            "ms": (time.perf_counter() - t0) * 1e3}


def _dropped_records() -> int | None:
    """CUPTI's count of activity records it dropped for want of buffer
    space, in its global queue and on the current stream of the current
    context; None where no CUPTI is loaded."""
    lib = _cupti_library()
    if lib is None:
        return None
    n, sid, ctx = ctypes.c_size_t(), ctypes.c_uint32(), ctypes.c_void_p()
    total = 0
    if lib.cuptiActivityGetNumDroppedRecords(None, 0, ctypes.byref(n)) == 0:
        total += n.value
    ctypes.CDLL("libcuda.so.1").cuCtxGetCurrent(ctypes.byref(ctx))
    if ctx.value:
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if (lib.cuptiGetStreamId(ctx, stream, ctypes.byref(sid)) == 0
                and lib.cuptiActivityGetNumDroppedRecords(
                    ctx, sid, ctypes.byref(n)) == 0):
            total += n.value
    return total


def _synchronize_ms(on_card: bool) -> float | None:
    """Wait for every kernel queued on the current card; the host ms the
    wait took (the card's backlog), None without a card."""
    if not on_card:
        return None
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def profiler_session(all_threads: bool = False):
    """A ``torch.profiler`` session of the enclosed block (CPU ops, and
    every kernel and copy on the card where CUDA is present); yields
    ``(prof, info)``, and ``info`` holds, once the block is left, what the
    session did on the card: ``backlog_ms`` (the waits below),
    ``fresh_cupti`` (:func:`_fresh_cupti`) and ``dropped_records``
    (:func:`_dropped_records`). ``all_threads`` records every thread's CPU
    ops, not only the calling thread's.

    Where the card is profiled, three things keep every kernel of the
    block among the records (measured on an H100 with torch 2.11 and CUPTI
    12.8):

    - CUPTI is attached anew for each session. Torch's profiler leaves
      CUPTI attached between sessions, and a thread that launches while
      sessions open and close can fall into a state where CUPTI makes no
      kernel record of its launches in any later session (its runtime
      calls are still recorded, its asynchronous copies in part; no
      record is dropped or filtered: CUPTI hands over none). A thread
      that starts later is traced in full, and so is every thread once
      CUPTI is attached anew. Late in a long process this lost nearly
      every kernel record of a window, window after window.
    - The card is synchronized before the profiler starts and again
      before it stops, the second time until a wait finds the card idle
      (under :data:`IDLE_MS`, at most :data:`DRAIN_WAITS` more waits):
      the profiler keeps only the card's records inside its window, so a
      session closed while the card still runs kernels launched in it
      (by the block, or by another thread after the first wait) drops
      their records, and a backlog from before it would straddle its
      start.
    - :data:`CLOCK_PAD_MS` of wait follow the start and precede the last
      waits: CUPTI places the card's records on the host's clock with an
      offset that changes from session to session (kernels stamped up to
      5.2 ms before their own launch), and a kernel launched in that
      margin of an edge would fall outside the window."""
    on_card = torch.profiler.ProfilerActivity.CUDA in _activities()
    info = {"backlog_ms": [_synchronize_ms(on_card)],
            "fresh_cupti": _fresh_cupti() if on_card else None}
    with torch.profiler.profile(
        activities=_activities(),
        experimental_config=_all_threads_config() if all_threads else None,
    ) as prof:
        if on_card:
            time.sleep(CLOCK_PAD_MS / 1e3)
        yield prof, info
        info["backlog_ms"].append(_synchronize_ms(on_card))
        if on_card:
            time.sleep(CLOCK_PAD_MS / 1e3)
            for _ in range(DRAIN_WAITS):
                info["backlog_ms"].append(_synchronize_ms(on_card))
                if info["backlog_ms"][-1] < IDLE_MS:
                    break
    info["dropped_records"] = _dropped_records() if on_card else None


def chrome_trace(prof) -> dict:
    """The Chrome trace of a finished ``torch.profiler`` session, as a
    dict."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="vdb-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _profile_window(ms: float, all_threads: bool = True) -> tuple[dict,
                                                                   dict]:
    """Profile the whole process for ``ms`` milliseconds in a
    :func:`profiler_session` (it attaches CUPTI anew and waits for the
    card at both ends); the Chrome trace as a dict, and a note of the
    window (:func:`_window_note`, with the session's ``info``).
    ``all_threads`` False records the calling thread's CPU ops only (the
    card's records and every thread's runtime calls still): the windows
    of :func:`capture_trace` record every thread."""
    t_start = time.time_ns()
    with profiler_session(all_threads) as (prof, info):
        time.sleep(ms / 1000.0)
    t_stop = time.time_ns()
    trace = chrome_trace(prof)
    note = _window_note(trace)
    note.update(all_threads=all_threads, host_ms=(t_stop - t_start) / 1e6,
                **info)
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
    their correlation id: ``launches_kept`` counts the launches whose
    kernel was recorded (:func:`records_complete` reads it), ``by_thread``
    gives ``[kept, launched]`` for each launching thread id,
    ``launch_to_kernel_us`` is the least and the median time from a launch
    to its kernel's start, ``clock_offset_us`` the least of them where it
    is below 0 (a kernel cannot start before its launch: below 0 the
    card's records are placed on the host's clock that much too early),
    and ``kept_by_fifth`` the share of the launches in each fifth of their
    span whose kernel was recorded (where in the window records went
    missing)."""
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
    by_thread = collections.defaultdict(lambda: [0, 0])
    for e in launches:
        counts = by_thread[str(e.get("tid"))]
        counts[0] += _correlation(e) in recorded
        counts[1] += 1
    note = {"kernel_records": len(kernels), "kernel_launches": len(launches),
            "launches_kept": sum(k for k, _ in by_thread.values()),
            "by_thread": dict(sorted(by_thread.items())),
            "copy_records": len(copies),
            "span_us": {"host_ops": _span(host), "launches": _span(launches),
                        "kernels": _span(kernels), "copies": _span(copies)},
            "top_kernels": [list(nc) for nc in names.most_common(3)],
            "launch_to_kernel_us": ([lags[0], lags[len(lags) // 2]]
                                    if lags else None),
            "clock_offset_us": min(lags[0], 0.0) if lags else None,
            "kept_by_fifth": _kept_by_fifth(launched, recorded)}
    said = {k: str(v)[:1000] for k, v in trace.items()
            if any(w in k.lower() for w in ("warn", "error"))}
    if said:
        note["profiler_said"] = said
    return note


def records_complete(note: dict, share: float) -> bool:
    """Whether a window (its :func:`_window_note`) kept at least ``share``
    of its kernel launches as kernel records, launches and records paired
    by correlation id; a window without launches kept them all."""
    return note["launches_kept"] >= share * note["kernel_launches"]


def capture_trace(ms: float) -> dict:
    """Profile the whole process for ``ms`` milliseconds (capped at
    :data:`MAX_TRACE_MS`); return the Chrome trace as a dict (its
    ``traceEvents`` list holds the ops and kernels of the window).

    Where the card is profiled, a window that lost the card's records is
    captured again, up to :data:`CAPTURE_ATTEMPTS` windows in all. A window
    lost them when it holds no kernel record, or fewer than half as many
    kernel records as kernel launches. Late in a long serving process this
    happened on an H100 (once no kernel record, once 2 beside 179 copies,
    once three windows in a row without the records of 4,377 launches):
    CUPTI, left attached from one session to the next, made no kernel
    record of the launches of threads that had lived through earlier
    sessions. Each window now attaches CUPTI anew
    (:func:`profiler_session`), and the retake should never fire; the
    notes say whether it did.
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


class _Span:
    """The range-only path of :func:`trace`."""

    __slots__ = ("name", "stage", "record", "_range", "_t0")

    def __init__(self, name: str, stage: str | None = None, record=None):
        self.name = name
        self.stage = stage
        self.record = record
        self._range = None

    def __enter__(self):
        # The module flag, not ``torch._C._autograd._profiler_enabled()``:
        # in a session that records every thread (``profile_all_threads``)
        # the C flag reads False on every thread, the session's own too,
        # while the ranges of every thread are recorded.
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.record is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            self.record(self.stage, (time.perf_counter() - self._t0) * 1e3)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def trace(name: str, log_dir: str | None = None, stage: str | None = None,
          record=None):
    """A context manager running the enclosed block as the span ``name``:
    a ``record_function(name)`` range while a profiler runs (on any
    thread, in a session of every thread), nothing else otherwise. With
    ``record`` (a ``MetricsCollector.record_stage``), the block's duration
    in ms is also recorded as ``record(stage, ms)``, a failing block's
    too (the range, where open, encloses the timed part). With
    ``log_dir``, the block is also profiled (CPU + CUDA, in a
    :func:`profiler_session`) and its Chrome trace written to
    ``<log_dir>/<name>.<pid>.<ns>.json``."""
    if log_dir:
        return _profiled(name, log_dir)
    return _Span(name, stage, record)


@contextlib.contextmanager
def _profiled(name: str, log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    with profiler_session() as (prof, _):
        with _Span(name):
            yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{name}.{os.getpid()}.{time.time_ns()}.json"))
