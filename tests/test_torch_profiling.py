"""PyTorch port, ``utils/profiling.py`` on ``torch.profiler``: the guarded
span helper and the stages it records, a traced block written as a Chrome
trace, the on-demand trace server, and ``server.main --profile-port``
serving it (CPU)."""

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]


def _names(trace: dict) -> set:
    return {e.get("name") for e in trace["traceEvents"]}


def test_trace_writes_a_chrome_trace_with_the_range(tmp_path):
    with profiling.trace("vdb.test_block", str(tmp_path / "traces")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(tmp_path / "traces")
    assert len(files) == 1 and files[0].startswith("vdb.test_block.")
    with open(tmp_path / "traces" / files[0]) as f:
        trace = json.load(f)
    assert "vdb.test_block" in _names(trace)
    assert any(n and "mm" in n for n in _names(trace))
    with profiling.trace("vdb.untraced"):   # no log_dir: the range only
        torch.ones(2).sum()


def _user_ranges(trace: dict, name: str) -> list:
    return [e for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def test_a_span_on_another_thread_is_recorded_in_an_all_threads_session():
    """A span opened on a thread that did not start the session is in the
    trace of a session of every thread (where the C profiler flag reads
    False on every thread: the guard reads the module flag)."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(10)
        with profiling.trace("vdb.worker_span"):
            time.sleep(0.005)
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with profiling.profiler_session(all_threads=True) as (prof, _):
        go.set()
        assert done.wait(10)
    t.join()
    (event,) = _user_ranges(profiling.chrome_trace(prof), "vdb.worker_span")
    assert event["dur"] >= 5000


def test_a_span_enters_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    rf = torch.autograd.profiler.record_function
    orig = rf.__enter__

    def counting(self):
        entered.append(self.name)
        return orig(self)

    monkeypatch.setattr(rf, "__enter__", counting)
    with profiling.trace("vdb.off", stage="off"):
        pass
    assert entered == []
    with profiling.profiler_session():
        with profiling.trace("vdb.on"):
            pass
    assert "vdb.on" in entered and "vdb.off" not in entered


def test_a_stage_and_its_range_come_from_one_block():
    """The stage a span records and its range in the trace measure the
    same block: they agree within 5%."""
    got = []
    with profiling.profiler_session() as (prof, _):
        with profiling.trace("vdb.timed", stage="timed",
                             record=lambda stage, ms: got.append((stage, ms))):
            time.sleep(0.05)
    (event,) = _user_ranges(profiling.chrome_trace(prof), "vdb.timed")
    ((stage, ms),) = got
    assert stage == "timed" and ms >= 50.0
    assert abs(ms - event["dur"] / 1e3) <= 0.05 * event["dur"] / 1e3


def test_a_span_records_its_stage_with_the_recorder_it_is_given():
    """A span's stage goes to the recorder the span was given, on
    whichever thread it runs; a span given none records nothing, a
    failing block still records its time."""
    mine, other = [], []

    def elsewhere():
        with profiling.trace("vdb.there", stage="there",
                             record=lambda s, ms: other.append(s)):
            pass

    with profiling.trace("vdb.unrecorded", stage="unrecorded"):
        pass
    t = threading.Thread(target=elsewhere)
    t.start()
    t.join()
    with pytest.raises(ValueError):
        with profiling.trace("vdb.fails", stage="fails",
                             record=lambda s, ms: mine.append((s, ms))):
            time.sleep(0.002)
            raise ValueError("a failing block still counts")
    assert other == ["there"]
    ((stage, ms),) = mine
    assert stage == "fails" and ms >= 2.0


def test_trace_server_serves_captures():
    """``/trace?ms=50`` answers with a Chrome trace holding what the
    process ran meanwhile, on another thread; other paths 404, a bad
    ``ms`` 400; a taken port raises."""
    server = profiling.start_trace_server(0)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    stop = []

    def busy():
        while not stop:
            with torch.profiler.record_function("vdb.busy_thread"):
                torch.randn(32, 32).sum()
            time.sleep(0.001)

    worker = threading.Thread(target=busy, daemon=True)
    worker.start()
    try:
        with urllib.request.urlopen(f"{base}/trace?ms=50", timeout=60) as r:
            assert r.status == 200
            trace = json.loads(r.read())
        # the other thread's range: every thread is recorded
        assert "vdb.busy_thread" in _names(trace)
        cap = trace["vdbCapture"]
        assert {k: cap[k] for k in ("ms", "attempts", "kernel_records",
                                    "kernel_launches")} == {
            "ms": 50.0, "attempts": 1, "kernel_records": 0,
            "kernel_launches": 0}
        (note,) = cap["windows"]
        assert note["all_threads"] and note["backlog_ms"] == [None, None]
        assert note["copy_records"] == 0 and note["host_ms"] >= 50.0
        assert note["span_us"]["host_ops"] is not None
        assert note["span_us"]["kernels"] is None
        for path, code in (("/nope", 404), ("/trace?ms=abc", 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + path, timeout=30)
            assert ei.value.code == code
        with pytest.raises(OSError):
            profiling.start_trace_server(port)
    finally:
        stop.append(True)
        worker.join(timeout=10)
        server.shutdown()
        server.server_close()
    assert not worker.is_alive()


def _window(*cats: str) -> dict:
    """A trace of one event per entry: a category, or ``"launch"`` for a
    runtime call that launched a kernel."""
    return {"traceEvents": [
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime"} if c == "launch"
        else {"name": f"e{i}", "cat": c} for i, c in enumerate(cats)]}


@pytest.mark.parametrize("on_card, windows, attempts, kernels, launches", [
    # the card's records came back at once: one window
    (True, [_window("cpu_op", "launch", "launch", "kernel", "kernel")],
     1, 2, 2),
    # the first window lost them, the second holds them
    (True, [_window("cpu_op", "cuda_runtime"), _window("cpu_op", "kernel")],
     2, 1, 0),
    # the first window kept 1 kernel record of 4 launches: taken again
    (True, [_window("launch", "launch", "launch", "launch", "kernel"),
            _window("launch", "launch", "launch", "kernel", "kernel")],
     2, 2, 3),
    # every window lost them: the last is returned, and says so
    (True, [_window("cpu_op", "launch")] * profiling.CAPTURE_ATTEMPTS,
     profiling.CAPTURE_ATTEMPTS, 0, 1),
    # no card profiled: a window without kernels is the answer
    (False, [_window("cpu_op")], 1, 0, 0),
])
def test_capture_retakes_a_window_without_the_cards_records(
        monkeypatch, on_card, windows, attempts, kernels, launches):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    monkeypatch.setattr(profiling, "_activities", lambda: acts)
    taken = []

    def fake_window(ms):
        taken.append(ms)
        window = windows[len(taken) - 1]
        return window, profiling._window_note(window)

    monkeypatch.setattr(profiling, "_profile_window", fake_window)
    trace = profiling.capture_trace(99999)
    assert taken == [profiling.MAX_TRACE_MS] * attempts
    assert trace is windows[attempts - 1]
    notes = [profiling._window_note(w) for w in windows[:attempts]]
    assert trace["vdbCapture"] == {"ms": profiling.MAX_TRACE_MS,
                                   "attempts": attempts,
                                   "kernel_records": kernels,
                                   "kernel_launches": launches,
                                   "windows": notes}
    assert notes[-1]["kernel_records"] == kernels
    assert notes[-1]["kernel_launches"] == launches


def test_window_synchronizes_the_card_before_it_opens_and_closes(
        monkeypatch):
    """Where the card is profiled, the window waits for the card's
    backlog before the profiler starts and again before it stops (the
    profiler keeps only the card's records inside its window), and its
    note gives both waits, the records of each kind and their time spans;
    ``all_threads`` False records the calling thread only."""
    monkeypatch.setattr(profiling, "_activities", lambda: [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    synced = []

    def synchronize(*a):
        synced.append(torch.autograd.profiler._is_profiler_enabled)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    for all_threads in (True, False):
        synced.clear()
        with pytest.warns(UserWarning):   # no CUDA here: CPU ops only
            trace, note = profiling._profile_window(20, all_threads)
        # the last wait found the card idle: no further wait
        assert synced == [False, True, True]
        assert note["all_threads"] is all_threads
        assert len(note["backlog_ms"]) == 3
        assert all(b >= 0 for b in note["backlog_ms"])
        assert note["host_ms"] >= 20.0
        assert note["kernel_records"] == note["copy_records"] == 0
        assert set(note["span_us"]) == {"host_ops", "launches", "kernels",
                                        "copies"}
        # no CUPTI loaded here: nothing to attach anew, no counter to read
        assert note["fresh_cupti"] is None and note["dropped_records"] is None
    note = profiling._window_note({"traceEvents": [
        {"name": "k", "cat": "kernel", "ts": 10.0, "dur": 5.0,
         "args": {"correlation": 7}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 2.0,
         "dur": 1.0, "args": {"correlation": 7}},
        {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 20.0,
         "dur": 2.0},
        {"name": "aten::mm", "cat": "cpu_op", "ts": 1.0, "dur": 30.0}],
        "traceName": "t", "WARNING": ["CUPTI could not enable kernels"]})
    assert note == {
        "kernel_records": 1, "kernel_launches": 1, "copy_records": 1,
        "span_us": {"host_ops": [1.0, 31.0], "launches": [2.0, 3.0],
                    "kernels": [10.0, 15.0], "copies": [20.0, 22.0]},
        "launches_kept": 1, "by_thread": {"None": [1, 1]},
        "top_kernels": [["k", 1]], "launch_to_kernel_us": [8.0, 8.0],
        "clock_offset_us": 0.0,
        "kept_by_fifth": [1.0, None, None, None, None],
        "profiler_said": {"WARNING": "['CUPTI could not enable kernels']"}}
    # five launches over 100 µs, the kernels of the first two recorded (one
    # stamped before its launch: the two clocks disagree)
    events = [{"name": "cudaLaunchKernel", "cat": "cuda_runtime",
               "ts": 25.0 * i, "args": {"correlation": i}} for i in range(5)]
    events += [{"name": "k", "cat": "kernel", "ts": t, "dur": 1.0,
                "args": {"correlation": c}} for c, t in ((0, 3.0),
                                                         (1, 20.0))]
    note = profiling._window_note({"traceEvents": events})
    assert note["kernel_records"] == 2 and note["kernel_launches"] == 5
    assert note["launch_to_kernel_us"] == [-5.0, 3.0]
    assert note["clock_offset_us"] == -5.0 and note["launches_kept"] == 2
    assert note["kept_by_fifth"] == [1.0, 1.0, 0.0, 0.0, 0.0]


def _launches(tid: int, correlations, recorded) -> list[dict]:
    """Runtime launches of thread ``tid`` with these correlation ids, and a
    kernel record for each id in ``recorded``."""
    events = [{"name": "cudaLaunchKernel", "cat": "cuda_runtime",
               "ts": float(c), "tid": tid, "args": {"correlation": c}}
              for c in correlations]
    return events + [{"name": "k", "cat": "kernel", "ts": c + 4.0,
                      "dur": 1.0, "tid": 7, "args": {"correlation": c}}
                     for c in correlations if c in recorded]


@pytest.mark.parametrize("kept, launched, share, complete", [
    (100, 100, 0.99, True),
    (99, 100, 0.99, True),      # the gate's margin
    (98, 100, 0.99, False),
    (0, 100, 0.99, False),      # the lost windows: no record of any launch
    (0, 0, 0.99, True),         # nothing launched, nothing to lose
    (50, 100, 0.5, True),
])
def test_records_complete_counts_launches_paired_with_records(
        kept, launched, share, complete):
    trace = {"traceEvents": _launches(11, range(launched), set(range(kept)))}
    note = profiling._window_note(trace)
    assert note["launches_kept"] == kept and note["kernel_launches"] == launched
    assert profiling.records_complete(note, share) is complete


def test_records_complete_pairs_by_correlation_not_by_count():
    """As many kernel records as launches, but records of other launches
    (from before the window) do not make the window complete."""
    events = _launches(11, range(10), set(range(5)))
    events += [{"name": "k", "cat": "kernel", "ts": 1.0,
                "args": {"correlation": 100 + i}} for i in range(5)]
    note = profiling._window_note({"traceEvents": events})
    assert note["kernel_records"] == note["kernel_launches"] == 10
    assert note["launches_kept"] == 5
    assert not profiling.records_complete(note, 0.99)


def test_window_note_counts_records_by_launching_thread():
    """The note splits launches and their records by the launching thread:
    a long-lived thread whose launches lost their records shows beside a
    thread whose launches kept them."""
    events = (_launches(11, range(0, 6), set())
              + _launches(22, range(6, 10), set(range(6, 10))))
    note = profiling._window_note({"traceEvents": events})
    assert note["by_thread"] == {"11": [0, 6], "22": [4, 4]}
    assert note["launches_kept"] == 4 and note["clock_offset_us"] == 0.0
    assert note["launch_to_kernel_us"] == [4.0, 4.0]


class _FakeCupti:
    """CUPTI's entry points that ``utils/profiling`` calls, recording the
    calls and writing ``dropped`` through the out-arguments."""

    def __init__(self, dropped=(0, 0)):
        self.calls, self.dropped = [], list(dropped)

    def cuptiActivityFlushAll(self, flag):  # noqa: N802 — CUPTI's names
        self.calls.append(("flush", flag))
        return 0

    def cuptiFinalize(self):  # noqa: N802
        self.calls.append(("finalize",))
        return 0

    def cuptiGetStreamId(self, ctx, stream, sid):  # noqa: N802
        sid._obj.value = 7
        return 0

    def cuptiActivityGetNumDroppedRecords(self, ctx, sid, n):  # noqa: N802
        self.calls.append(("dropped", ctx, getattr(sid, "value", sid)))
        n._obj.value = self.dropped.pop(0)
        return 0


def test_fresh_cupti_flushes_then_finalizes(monkeypatch):
    """The cure detaches CUPTI: a forced flush of its buffers, then
    ``cuptiFinalize``; where no CUPTI is loaded (this CPU build) it does
    nothing."""
    assert profiling._cupti_library() is None
    assert profiling._fresh_cupti() is None
    fake = _FakeCupti()
    monkeypatch.setattr(profiling, "_cupti_library", lambda: fake)
    done = profiling._fresh_cupti()
    assert fake.calls == [("flush", 1), ("finalize",)]
    assert done["flush_rc"] == done["finalize_rc"] == 0 and done["ms"] >= 0


@pytest.mark.parametrize("context, dropped, total", [
    (0, (3,), 3),                 # no context: the global queue only
    (0x1234, (3, 4), 7),          # ... and the current stream's
])
def test_dropped_records_adds_the_global_and_the_stream_counts(
        monkeypatch, context, dropped, total):
    assert profiling._dropped_records() is None   # no CUPTI here
    fake = _FakeCupti(dropped)

    class Driver:
        def cuCtxGetCurrent(self, ctx):  # noqa: N802 — CUDA's name
            ctx._obj.value = context
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(profiling, "_cupti_library", lambda: fake)
    monkeypatch.setattr(profiling.ctypes, "CDLL", lambda name: Driver())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    assert profiling._dropped_records() == total
    assert [c[0] for c in fake.calls] == ["dropped"] * len(dropped)


@pytest.mark.parametrize("on_card", [True, False])
def test_profiler_session_attaches_cupti_anew_for_each_session(
        monkeypatch, on_card):
    """On the card each session synchronizes, attaches CUPTI anew, starts
    the profiler, waits ``CLOCK_PAD_MS``, runs the block, synchronizes,
    waits again, stops, and reads CUPTI's dropped-record count; on the CPU
    the session is the plain profiler (no wait, no CUPTI call)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    monkeypatch.setattr(profiling, "_activities", lambda: acts)
    steps = []

    def enabled():
        return torch.autograd.profiler._is_profiler_enabled

    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: steps.append(("sync", enabled())))
    monkeypatch.setattr(profiling, "_fresh_cupti",
                        lambda: steps.append(("fresh", enabled())) or {})
    monkeypatch.setattr(profiling, "_dropped_records",
                        lambda: steps.append(("dropped", enabled())) or 0)
    monkeypatch.setattr(profiling.time, "sleep",
                        lambda s: steps.append(("sleep", s)))
    ctx = (pytest.warns(UserWarning) if on_card
           else contextlib.nullcontext())   # no CUDA here
    with ctx:
        for _ in range(2):
            with profiling.profiler_session() as (prof, info):
                steps.append(("block", enabled()))
                torch.ones(4).sum()
    pad = profiling.CLOCK_PAD_MS / 1e3
    if on_card:
        one = [("sync", False), ("fresh", False), ("sleep", pad),
               ("block", True), ("sync", True), ("sleep", pad),
               ("sync", True), ("dropped", False)]
        assert len(info["backlog_ms"]) == 3
        assert info == {"backlog_ms": info["backlog_ms"],
                        "fresh_cupti": {}, "dropped_records": 0}
    else:
        one = [("block", True)]
        assert info == {"backlog_ms": [None, None], "fresh_cupti": None,
                        "dropped_records": None}
    assert steps == one * 2
    assert any(e.get("name") == "aten::sum"
               for e in profiling.chrome_trace(prof)["traceEvents"])


@pytest.mark.parametrize("waits, taken", [
    # the card idle at the first wait after the pad: one more wait
    ([0.2, 3.0, 0.05], 3),
    # another thread queued a long burst after the first wait: waited out
    ([0.1, 53.0, 600.0, 0.04], 4),
    # a card that never goes idle: at most DRAIN_WAITS waits after the pad
    ([0.1] + [5.0] * 10, 2 + profiling.DRAIN_WAITS),
])
def test_session_waits_until_the_card_is_idle_before_it_stops(
        monkeypatch, waits, taken):
    """Before the profiler stops, the session waits for the card, waits
    ``CLOCK_PAD_MS``, then waits again until a wait finds the card idle
    (under ``IDLE_MS``): work another thread queued after the first wait
    ends inside the window."""
    monkeypatch.setattr(profiling, "_activities", lambda: [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    queue = iter(waits)
    monkeypatch.setattr(profiling, "_synchronize_ms",
                        lambda on_card: next(queue))
    monkeypatch.setattr(profiling, "_fresh_cupti", lambda: None)
    monkeypatch.setattr(profiling, "_dropped_records", lambda: 0)
    with pytest.warns(UserWarning):   # no CUDA here: CPU ops only
        with profiling.profiler_session() as (_, info):
            pass
    assert info["backlog_ms"] == waits[:taken]


def _free_ports(n: int) -> list[int]:
    """``n`` distinct ports free at the time of the call."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_server_main_serves_traces_on_profile_port(tmp_path):
    """``server.main --profile-port`` starts the trace server beside the
    gRPC server (it raised ``NotImplementedError`` before the port of
    ``utils/profiling.py``) and shuts down on SIGTERM."""
    import grpc

    trace_port, grpc_port, metrics_port = _free_ports(3)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "cuda_acceleratedvectordatabaseengine_tpu_torch.server.main",
         "--device", "cpu", "--address", f"127.0.0.1:{grpc_port}",
         "--data-path", str(tmp_path / "data"),
         "--metrics-port", str(metrics_port),
         "--profile-port", str(trace_port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
        grpc.channel_ready_future(channel).result(timeout=120)
        channel.close()
        url = f"http://127.0.0.1:{trace_port}/trace?ms=50"
        with urllib.request.urlopen(url, timeout=60) as r:
            trace = json.loads(r.read())
        assert isinstance(trace["traceEvents"], list)
        assert proc.poll() is None
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    assert "NotImplementedError" not in err, err[-2000:]
    assert f"profiler traces on :{trace_port}" in out, (out, err[-2000:])
