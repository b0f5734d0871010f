"""PyTorch port, the serving layer without the wire (CPU): the parts copied
from the JAX package (epochs, coalescer, balancer, rate limiter, prefetch
scheduler) against their JAX counterparts on the same call sequences, the
YAML reader against ``yaml.safe_load``, the metrics exposition against the
JAX collector's, and ``VdbEngine`` itself: build, activate, coalesced
search through admission, removal with the tombstone log, restart."""

import dataclasses
import json
import logging
import os
import threading
import time
import types

import numpy as np
import pytest
import torch
import yaml

from cuda_acceleratedvectordatabaseengine_tpu.io_host import (
    prefetcher as j_prefetcher,
)
from cuda_acceleratedvectordatabaseengine_tpu.server import (
    balancer as j_balancer,
    coalescer as j_coalescer,
    config as j_config,
    metrics as j_metrics,
    ratelimit as j_ratelimit,
)
from cuda_acceleratedvectordatabaseengine_tpu.storage import epoch as j_epoch
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
    prefetcher as t_prefetcher,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server import (
    balancer as t_balancer,
    coalescer as t_coalescer,
    config as t_config,
    health as t_health,
    metrics as t_metrics,
    ratelimit as t_ratelimit,
    service as t_service,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
    VectorFileWriter,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
    epoch as t_epoch,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import (
    logging as t_logging,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils import (
    profiling as t_profiling,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION_YAML = os.path.join(REPO, "configs", "production.yaml")
DIM = 16


class FakeClock:
    """``time.monotonic`` / ``time.sleep`` / ``time.time_ns`` stand-in that
    advances only when told to (or by the sleeps it is asked for)."""

    def __init__(self):
        self.now = 1000.0
        self.ns = 1_700_000_000_000_000_000

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.now += s

    def time_ns(self):
        self.ns += 1
        return self.ns

    def time(self):
        return self.now


def _fake_time(monkeypatch, *modules) -> FakeClock:
    clock = FakeClock()
    fake = types.SimpleNamespace(monotonic=clock.monotonic, sleep=clock.sleep,
                                 time_ns=clock.time_ns, time=clock.time)
    for mod in modules:
        monkeypatch.setattr(mod, "time", fake)
    return clock


# --------------------------------------------------------------------------- #
# copied parts against the JAX package
# --------------------------------------------------------------------------- #

def _rate_limiter_trace(mod, clock):
    rl = mod.RateLimiter(rate_per_s=10.0, burst=3)
    out = []
    for step in range(12):
        out.append(rl.try_acquire(1 + step % 2))
        clock.now += 0.07
    rl.set_rate(100.0, burst=1)
    out.append((rl.try_acquire(), rl.try_acquire(), rl.rate))
    clock.now += 0.5
    out.append(rl.acquire(1, timeout=0.0))
    out.append(rl.acquire(5, timeout=0.01))
    return out


def test_rate_limiter_matches_jax(monkeypatch):
    a = _rate_limiter_trace(j_ratelimit, _fake_time(monkeypatch, j_ratelimit))
    b = _rate_limiter_trace(t_ratelimit, _fake_time(monkeypatch, t_ratelimit))
    assert a == b
    assert True in a and False in a


def _balancer_trace(mod, clock):
    br = mod.CircuitBreaker(error_threshold=0.5, open_seconds=30.0,
                            decay=0.9, min_requests=4)
    out = []
    for ok in (True, False, False, False, True, False):
        out.append((br.allow(), br.state.value))
        br.record(ok)
        clock.now += 1.0
    out.append((br.allow(), br.state.value))
    clock.now += 31.0
    out.append((br.allow(), br.state.value))      # half-open probe
    br.record(False)
    out.append(br.state.value)
    clock.now += 31.0
    out.append(br.allow())
    br.record(True)
    out.append((br.state.value, br.allow()))
    lim = mod.ConcurrencyLimiter(2)
    out.append((lim.try_enter(), lim.try_enter(), lim.try_enter(),
                lim.active))
    lim.exit()
    out.append((lim.try_enter(), lim.active))
    ad = mod.AdaptiveController(base_batch=64, latency_budget_ms=100.0)
    out.append((ad.batch_size(512, 512), ad.timeout_s()))
    for ms in (150.0,) * 50 + (500.0,) * 50:
        ad.record_latency_ms(ms)
        out.append((ad.batch_size(), ad.timeout_s()))
    q = mod.PriorityRequestQueue()
    for i, p in enumerate([mod.Priority.LOW, mod.Priority.URGENT,
                           mod.Priority.NORMAL, mod.Priority.HIGH,
                           mod.Priority.URGENT, mod.Priority.LOW]):
        q.put((i, 10 * (i + 1)), p)
    out.append(q.drain(4, 0.0, weight_fn=lambda it: it[1], max_weight=70))
    out.append(q.drain(8, 0.0))
    out.append((len(q), q.get(timeout=0.0)))
    return out


def test_balancer_matches_jax(monkeypatch):
    a = _balancer_trace(j_balancer, _fake_time(monkeypatch, j_balancer))
    b = _balancer_trace(t_balancer, _fake_time(monkeypatch, t_balancer))
    assert a == b
    assert ("open" in [x[1] for x in a if isinstance(x, tuple)
                       and len(x) == 2 and isinstance(x[1], str)])


def _coalescer_weighted(mod):
    gate = threading.Event()
    batches = []

    def batch_fn(items):
        gate.wait(timeout=5)
        batches.append(list(items))
        return [w * 2 for w in items]

    co = mod.RequestCoalescer(batch_fn, window_s=0.5, max_batch=32,
                              weight_fn=lambda w: w)
    futs = [co.submit(w) for w in (16, 16, 8, 100, 4, 4, 30)]
    gate.set()
    res = [f.result(timeout=10) for f in futs]
    co.stop()
    return batches, res, co.stats()["batches"]


def _coalescer_priority(mod):
    gate = threading.Event()
    batches = []

    def batch_fn(items):
        gate.wait(timeout=5)
        batches.append(list(items))
        return items

    co = mod.RequestCoalescer(batch_fn, window_s=0.5, max_batch=64,
                              max_batch_fn=lambda: 2)
    futs = [co.submit(name, p) for name, p in (
        ("low", mod.Priority.LOW), ("normal", mod.Priority.NORMAL),
        ("urgent", mod.Priority.URGENT), ("high", mod.Priority.HIGH),
        ("low2", mod.Priority.LOW))]
    gate.set()
    res = [f.result(timeout=10) for f in futs]
    co.stop()
    return batches, res


def _coalescer_cancel_and_shed(mod):
    gate = threading.Event()
    ran = []

    def batch_fn(items):
        gate.wait(timeout=5)
        ran.extend(items)
        return items

    co = mod.RequestCoalescer(batch_fn, window_s=0.01, max_batch=1,
                              max_queue=2)
    f1 = co.submit("a")
    for _ in range(500):               # "a" drained, blocked on the gate
        if co.stats()["batches"]:
            break
        time.sleep(0.005)
    f2, f3 = co.submit("b"), co.submit("c")
    shed = False
    try:
        co.submit("d")
    except mod.QueueFullError:
        shed = True
    cancelled = f2.cancel()
    gate.set()
    out = [f1.result(timeout=5), f3.result(timeout=5)]
    co.stop()
    return out, shed, cancelled, ran, co.stats()["shed"], f2.cancelled()


def _coalescer_pipelined(mod):
    release = threading.Event()
    dispatched = []

    def dispatch_fn(items):
        n = len(dispatched)
        dispatched.append(list(items))

        def thunk():
            if n == 0:
                release.wait(timeout=10)
            if "boom" in items:
                raise ValueError("device failure")
            return list(items)
        return thunk

    co = mod.RequestCoalescer(dispatch_fn=dispatch_fn, window_s=0.002,
                              max_batch=4)
    f1 = co.submit("a")
    for _ in range(500):
        if dispatched:
            break
        time.sleep(0.005)
    f2 = co.submit("b")               # dispatched while a's fetch blocks
    for _ in range(500):
        if len(dispatched) == 2:
            break
        time.sleep(0.005)
    overlapped = len(dispatched) == 2 and not f1.done()
    release.set()
    out = [f1.result(timeout=5), f2.result(timeout=5)]
    f3 = co.submit("boom")
    err = type(f3.exception(timeout=5)).__name__
    co.stop()
    return overlapped, out, err


@pytest.mark.parametrize("scenario", [
    _coalescer_weighted, _coalescer_priority, _coalescer_cancel_and_shed,
    _coalescer_pipelined])
def test_coalescer_matches_jax(scenario):
    """The same submissions give the same drained batches, results,
    cancellations, sheds and pipelining as the JAX package's coalescer."""
    assert scenario(t_coalescer) == scenario(j_coalescer)


def _epoch_trace(mod, base):
    em = mod.EpochManager(base, keep_epochs=2)
    out = []
    for _ in range(4):
        eid, d = em.create_epoch("a")
        out.append(os.path.relpath(d, base))
        em.activate_epoch("a", eid)
    out.append(em.create_epoch("b")[0])
    em.deactivate_epoch("a", em.active_epoch("a"))
    out.append((em.active_epoch("a"), em.active_dir("b"), em.list_indices()))
    out.append(em.list_epochs("a"))
    with pytest.raises(KeyError):
        em.activate_epoch("a", "nope")
    with open(os.path.join(base, mod.EpochManager.REGISTRY), "rb") as f:
        out.append(f.read())
    return out


def test_epoch_manager_matches_jax(tmp_path, monkeypatch):
    """Same calls, same clock: the same epochs, the same GC, and the same
    ``epochs.json`` bytes; each package recovers the other's registry
    (dropping entries whose directory is gone)."""
    _fake_time(monkeypatch, j_epoch)
    a = _epoch_trace(j_epoch, str(tmp_path / "j"))
    _fake_time(monkeypatch, t_epoch)
    b = _epoch_trace(t_epoch, str(tmp_path / "t"))
    assert a == b
    # 4 epochs made, keep_epochs 2: one active + 2 kept, the oldest GC'd
    assert len(a[6]["epochs"]) == 3 and a[5][0] is None
    for mine, theirs in ((t_epoch, "j"), (j_epoch, "t")):
        base = str(tmp_path / theirs)
        eid = sorted(mine.EpochManager(base).list_epochs("a")["epochs"])[0]
        os.rmdir(os.path.join(base, "a", "epochs", eid))
        em = mine.EpochManager(base)
        assert eid not in em.list_epochs("a")["epochs"]
        assert em.list_indices() == ["a", "b"]


class _Task:
    def __init__(self, log, name, fail=False):
        self.log, self.name, self.fail = log, name, fail

    def __call__(self):
        self.log.append(self.name)
        if self.fail:
            raise RuntimeError("staging failed")


def _scheduler_trace(mod):
    log = []
    s = mod.PrefetchScheduler(bandwidth_limit_bps=1e12)
    s.pause()
    for name, prio in (("low", 0), ("high", 5), ("mid", 2), ("bad", 9)):
        s.schedule(_Task(log, name, fail=name == "bad"), priority=prio,
                   nbytes=1000)
    time.sleep(0.05)
    paused = list(log)
    s.resume()
    for _ in range(400):
        if s.completed == 4:
            break
        time.sleep(0.005)
    s.stop()
    with pytest.raises(RuntimeError):
        s.schedule(_Task(log, "late"))
    return paused, log, s.completed


def test_prefetch_scheduler_matches_jax():
    """Paused tasks wait; resumed they run highest priority first; a
    failing task is dropped; a stopped scheduler refuses work."""
    assert _scheduler_trace(t_prefetcher) == _scheduler_trace(j_prefetcher)
    assert _scheduler_trace(t_prefetcher)[1] == ["bad", "high", "mid", "low"]


def test_prefetch_throttle_matches_jax(monkeypatch):
    """The byte-rate throttle asks for the same sleeps."""
    out = []
    for mod in (j_prefetcher, t_prefetcher):
        clock = _fake_time(monkeypatch, mod)
        s = mod.PrefetchScheduler(bandwidth_limit_bps=1000.0)
        s.stop()
        t0 = clock.now
        for nbytes in (400, 400, 900, 100):
            s._throttle(nbytes)
        out.append(clock.now - t0)
    assert out[0] == out[1] and out[0] > 0


# --------------------------------------------------------------------------- #
# the YAML reader and ServerConfig
# --------------------------------------------------------------------------- #

YAML_CASES = [
    "a: 1\nb: -7\nc: +3\nd: 0\ne: 1_000\n",
    "a: 1.5\nb: 2.\nc: .5\nd: -.5\ne: 1.0e+9\nf: 1e3\ng: 10.0e9\nh: .inf\n"
    "i: -.Inf\n",
    "a: yes\nb: No\nc: on\nd: OFF\ne: true\nf: False\ng: y\nh: n\n",
    "a: ~\nb: null\nc:\nd: Null\n",
    "a: 'it''s # not a comment'\nb: \"tab\\there\"  # comment\n"
    "c: \"q\\\"uote\\u00e9\"\nd: x#y\ne: -dash\nf: hello world\n",
    "a: [1, 'x, y', \"z\", 2.5, no, ~]\nb: []\nc: [ 8 , 32 ]\n",
    "# leading comment\n\nouter:\n  inner:\n    deep: 3\n  sib: 'v'\n"
    "empty:\nlast: 1\n",
    "",
    "# only a comment\n",
    "a: 0.0.0.0:50051x\nb: 0o17\n",
]

YAML_REFUSED = [
    "- a\n- b\n", "a:\n  - 1\n", "a: &x 1\n", "a: *x\n", "a: !!str 1\n",
    "a: {b: 1}\n", "a: |\n  text\n", "a: >\n  text\n", "a: 0x1f\n",
    "a: 017\n", "a: 1:30\n", "a: b: c\n", "a: [1, [2]]\n",
    "a: [1,\n  2]\n", "a: 'open\n", "---\na: 1\n", "a: 1\n  b: 2\n",
    "\ta: 1\n", "a: 'x' y\n", "? a\n", "a: [1, ]\n",
]


@pytest.mark.parametrize("text", YAML_CASES)
def test_yaml_reader_matches_pyyaml(text):
    got, want = t_config.load_yaml(text), yaml.safe_load(text)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("text", YAML_REFUSED)
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        t_config.load_yaml(text)


def test_yaml_reader_reads_production_yaml():
    with open(PRODUCTION_YAML) as f:
        text = f.read()
    assert t_config.load_yaml(text) == yaml.safe_load(text)


def test_server_config_from_yaml_matches_jax():
    """Every key the JAX ``from_yaml`` sets comes out equal, except the one
    the port coerces: ``prefetch_bandwidth_bps: 10.0e9`` is a string under
    YAML 1.1, which the JAX config passes on as is."""
    mine = t_config.ServerConfig.from_yaml(PRODUCTION_YAML)
    theirs = j_config.ServerConfig.from_yaml(PRODUCTION_YAML)
    assert ({f.name for f in dataclasses.fields(mine)}
            == {f.name for f in dataclasses.fields(theirs)})
    for f in dataclasses.fields(theirs):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name == "prefetch_bandwidth_bps":
            assert b == "10.0e9" and a == 10e9
        elif f.name == "warm_nprobes":
            assert list(a) == list(b) == [8, 32]
        else:   # the port also makes a YAML int a float where declared
            assert a == b, f.name
            assert type(a) is type(b) or (f.type, type(b)) == ("float", int)
    assert dataclasses.asdict(t_config.ServerConfig()) == \
        dataclasses.asdict(j_config.ServerConfig())


def test_server_config_aliases_coercion_and_auth(tmp_path, monkeypatch):
    path = tmp_path / "c.yaml"
    path.write_text("listen_address: '1.2.3.4:5'\nwindow_ms: 3\n"
                    "nprobe: 16\nbatching:\n  max_batch_size: 32\n"
                    "enable_multi_gpu: false\nunknown_key: 1\n"
                    "auth_token: '$VDB_TEST_TOKEN'\n")
    cfg = t_config.ServerConfig.from_yaml(str(path))
    assert (cfg.address, cfg.coalesce_window_ms, cfg.default_nprobe,
            cfg.max_batch_size, cfg.shard_serving) == (
        "1.2.3.4:5", 3.0, 16, 32, "off")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_config.ServerConfig.from_yaml(str(path)))
    with pytest.raises(ValueError, match="unset environment"):
        cfg.resolved_auth_token()
    monkeypatch.setenv("VDB_TEST_TOKEN", "s3cret")
    assert cfg.resolved_auth_token() == "s3cret"
    path.write_text("security:\n  enable_auth: true\n")
    with pytest.raises(ValueError, match="auth_token"):
        t_config.ServerConfig.from_yaml(str(path))
    for bad in ("max_batch_size: 'many'\n", "metrics_enabled: 1\n",
                "default_nprobe: 2.5\n", "data_path: 7\n",
                "rate_limit_rps: fast\n"):
        path.write_text(bad)
        with pytest.raises(ValueError, match="config key"):
            t_config.ServerConfig.from_yaml(str(path))
    assert cfg.apply_overrides(address=None, max_batch_size=8) \
        .max_batch_size == 8


# --------------------------------------------------------------------------- #
# metrics and health
# --------------------------------------------------------------------------- #

def _record(m):
    m.record_search("docs", 3.2, 4)
    m.record_search('we"ird\\name', 700.0, 1)
    m.record_search("docs", 0.2)
    m.record_stage("fetch", 1.5)
    m.record_stage("decode", 0.1)
    m.record_stage("fetch", 2.5)
    m.set_device_memory(12345678901)
    m.set_storage_bandwidth(2.5e9)
    m.record_recall("docs", 0.9)
    return m


def _families(m):
    from prometheus_client.parser import text_string_to_metric_families

    out = []
    for fam in text_string_to_metric_families(m.prometheus_text().decode()):
        samples = []
        for s in fam.samples:
            # creation times and the uptime rate depend on the clock
            live = s.name.endswith("_created") or "per_second" in s.name
            samples.append((s.name, tuple(sorted(s.labels.items())),
                            None if live else s.value))
        out.append((fam.name, fam.type, fam.documentation, samples))
    return out


def test_metrics_exposition_matches_jax():
    """After the same recorded events the port's own Prometheus text parses
    (``prometheus_client.parser``) into the JAX collector's families and
    samples."""
    mine = _record(t_metrics.MetricsCollector())
    theirs = _record(j_metrics.MetricsCollector())
    assert _families(mine) == _families(theirs)
    assert mine.get_percentiles("docs") == theirs.get_percentiles("docs")
    assert mine.get_stage_percentiles() == theirs.get_stage_percentiles()
    assert mine.get_avg_recall("docs") == theirs.get_avg_recall("docs")
    for m in (mine, theirs):
        m.reset_windows("docs")
    assert mine.get_percentiles("docs") == theirs.get_percentiles("docs")
    assert mine.get_stage_percentiles() == {}
    assert _families(mine) == _families(theirs)


def test_metrics_value_format_matches_prometheus_client():
    from prometheus_client.utils import floatToGoString

    for v in (0.0, 1.0, 3.2, 1e-7, 123456.0, 1234567.0, 12345678901.0,
              1.7e9, -5.5, float("inf"), float("-inf"), 2.5e20):
        assert t_metrics._fmt(v) == floatToGoString(v)


def test_metrics_http_endpoints():
    import urllib.error
    import urllib.request

    m = _record(t_metrics.MetricsCollector())
    health = {"healthy": True, "device_ok": True}
    port = m.start_exposition(0, health_fn=lambda: health)
    try:
        base = f"http://127.0.0.1:{port}"
        resp = urllib.request.urlopen(f"{base}/metrics", timeout=5)
        assert resp.headers["Content-Type"] == t_metrics.CONTENT_TYPE_LATEST
        assert b"vdb_searches_total" in resp.read()
        body = json.loads(urllib.request.urlopen(f"{base}/health",
                                                 timeout=5).read())
        assert body["status"] == "healthy" and body["uptime_s"] >= 0
        health["healthy"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/health", timeout=5)
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=5)
        assert ei.value.code == 404
    finally:
        m.stop_exposition()


def test_health_probes_the_device():
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto import (
        health_pb2,
    )

    st = health_pb2.HealthCheckResponse
    assert (t_health.SERVING, t_health.NOT_SERVING,
            t_health.SERVICE_UNKNOWN) == (st.SERVING, st.NOT_SERVING,
                                          st.SERVICE_UNKNOWN)
    assert t_health.device_usable("cpu")
    assert not t_health.device_usable("no-such-device")
    h = t_health.HealthServicer(poll_interval_s=0.01, device="cpu")
    try:
        assert h.snapshot() == {"healthy": True, "device_ok": True}
        h.set_status("", False)
        assert not h.snapshot()["healthy"]
        assert h._check("other") == t_health.SERVICE_UNKNOWN
    finally:
        h.stop()
    bad = t_health.HealthServicer(poll_interval_s=0.01, device="meta:7")
    try:
        # the first probe's verdict, however long a loaded machine takes
        # to reach it (a fixed 2 s budget ran out under parallel workers)
        bad.probed.wait(timeout=60)
        assert bad._check("") == t_health.NOT_SERVING
    finally:
        bad.stop()


def test_logger_json_lines(monkeypatch, capsys):
    monkeypatch.setenv("VDB_LOG_JSON", "1")
    log = t_logging.get_logger("vdb.test-json-lines")
    assert t_logging.get_logger("vdb.test-json-lines") is log
    assert len(log.handlers) == 1 and not log.propagate
    record = logging.LogRecord("vdb.x", logging.ERROR, __file__, 1,
                               "broken %s", ("epoch",), None)
    line = json.loads(t_logging.JsonFormatter().format(record))
    assert (line["level"], line["msg"]) == ("ERROR", "broken epoch")


# --------------------------------------------------------------------------- #
# VdbEngine on the CPU
# --------------------------------------------------------------------------- #

def _config(tmp_path, **kw):
    base = dict(data_path=str(tmp_path / "data"), default_nlist=8,
                default_nprobe=8, warm_nprobes=(), max_batch_size=16,
                coalesce_window_ms=1.0, prefetch_hot_interval_s=0.0,
                build_chunk_rows=250)
    base.update(kw)
    return t_config.ServerConfig(**base)


def _source(tmp_path, rng, n=600):
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64) * 3 + 5
    path = str(tmp_path / "src.arrow")
    with VectorFileWriter(path) as w:
        w.append(ids[: n // 2], x[: n // 2])
        w.append(ids[n // 2:], x[n // 2:])
    return x, ids, path


def _build_and_activate(eng, name, source=""):
    eid = eng.build_epoch(name, source)
    deadline = time.time() + 60
    while not eng.build_jobs[name].done:
        assert time.time() < deadline, "build never finished"
        time.sleep(0.02)
    assert not eng.build_jobs[name].error, eng.build_jobs[name].error
    eng.activate_epoch(name, eid)
    return eid


def _serve(eng, name, queries, params, threads=4):
    """Each query as its own request, through the calls the servicer makes
    after decoding: admission + coalescer, then the finish."""
    st = eng.get_state(name)
    out = [None] * len(queries)

    def client(lo):
        for i in range(lo, len(queries), threads):
            t0 = time.monotonic()
            fut = eng.submit_search(st, queries[i:i + 1], params)
            out[i] = eng.finish_search(fut, name, t0, 1)

    ts = [threading.Thread(target=client, args=(j,)) for j in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return (np.concatenate([d for d, _ in out]),
            np.concatenate([i for _, i in out]))


def _same(got, want, q):
    assert_topk_match(*got, *want, rtol=1e-5,
                      atol=1e-5 * (q.astype(np.float64) ** 2).sum(1))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_engine_lifecycle(tmp_path, rng, dtype):
    """Create → build an epoch from a vectors file → activate → coalesced
    searches through admission (equal to the library search of the same
    index) → removal with the tombstone log → restart: the new engine
    recovers the epoch, replays the tombstones and answers the same."""
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path, arena_dtype=dtype),
                              device="cpu")
    eng.create_index("docs", DIM, "L2", 8, 0, 0)
    with pytest.raises(KeyError):
        eng.create_index("docs", DIM, "L2", 8, 0, 0)
    _build_and_activate(eng, "docs", src)
    st = eng.get_state("docs")
    assert st.index.ntotal == 600 and str(st.index.arena.dtype).endswith(
        {"bfloat16": "bfloat16", "int8": "int8", "float32": "float32"}[dtype])
    assert st.index.device.type == "cpu"
    q = x[:40] + 0.05 * rng.standard_normal((40, DIM)).astype(np.float32)
    p = SearchParams(nprobe=8, k=5)
    got = _serve(eng, "docs", q, p)
    _same(got, st.index.search(q, p), q)
    assert (got[1][:, 0] == ids[:40]).all()
    co = st.coalescer.stats()
    assert co["items"] == 40 and co["batches"] <= 40
    stages = eng.metrics.get_stage_percentiles()
    assert {"queue_wait", "dispatch", "fetch", "encode"} <= set(stages)
    assert eng.metrics.get_percentiles("docs")["count"] == 40
    removed, total = eng.remove_vectors("docs", ids[:10])
    assert (removed, total) == (10, 590)
    assert eng.remove_vectors("docs", ids[:10]) == (0, 590)
    after = _serve(eng, "docs", q, p)
    assert not np.isin(after[1], ids[:10]).any()
    eng.close()
    again = t_service.VdbEngine(_config(tmp_path, arena_dtype=dtype),
                                device="cpu")
    try:
        st2 = again.get_state("docs")
        assert st2.index.ntotal == 590 and st2.error == ""
        assert st2.epoch == again.epochs.active_epoch("docs")
        _same(_serve(again, "docs", q, p), after, q)
    finally:
        again.close()


def test_engine_add_then_rebuild_bakes_tombstones(tmp_path, rng):
    """AddVectors into a live index, a delete, then a rebuild from the
    live index: the new epoch holds the adds, not the deleted id, and the
    baked tombstone leaves the log; re-adding an id revokes its tombstone."""
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path), device="cpu")
    try:
        eng.create_index("docs", DIM, "L2", 0, 0, 0)
        assert eng.get_state("docs").config["nlist"] == 8
        eng.add_vectors("docs", x[:300], ids[:300])
        assert eng.add_vectors("docs", x[300:], ids[300:]) == (300, 600)
        _build_and_activate(eng, "docs")
        extra = rng.standard_normal((5, DIM)).astype(np.float32)
        assert eng.add_vectors("docs", extra,
                               np.arange(5, dtype=np.uint64) + 10**6) \
            == (5, 605)
        eng.remove_vectors("docs", ids[:3])
        eng.add_vectors("docs", x[:1], ids[:1])           # re-add revokes
        assert set(eng._read_tombstones("docs").tolist()) == \
            set(ids[1:3].tolist())
        _build_and_activate(eng, "docs")
        st = eng.get_state("docs")
        assert st.index.ntotal == 603
        assert eng._read_tombstones("docs").size == 0
        held = st.index.arena.ids
        assert np.isin(ids[:1], held).all() and not np.isin(ids[1:3],
                                                            held).any()
    finally:
        eng.close()


def test_engine_pq_capacity_tier(tmp_path, rng):
    """The capacity tier through the engine: the build streams the host
    rows into the epoch, activation loads codes on the device and rows in
    host RAM, reranked searches serve through the coalescer (equal to the
    library search), removal is refused, adds buffer for the next build."""
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path, pq_rerank_k=40), device="cpu")
    try:
        eng.create_index("cap", DIM, "L2", 8, 4, 8, "pq_capacity")
        _build_and_activate(eng, "cap", src)
        st = eng.get_state("cap")
        assert st.index.read_only and st.index.raw is None
        assert st.index.host_rerank_k == 40
        p = SearchParams(nprobe=8, k=5, use_exact_rerank=True)
        got = _serve(eng, "cap", x[:24], p)
        _same(got, st.index.search(x[:24], p), x[:24])
        assert (got[1][:, 0] == ids[:24]).all()
        with pytest.raises(PermissionError):
            eng.remove_vectors("cap", ids[:2])
        assert eng.add_vectors("cap", x[:20], ids[:20] + 10**6) == (20, 20)
        assert sum(len(v) for v in st.pending_vectors) == 20
        _build_and_activate(eng, "cap")
        assert st.index.ntotal == 20 and st.index._host_rr is not None
    finally:
        eng.close()


def test_engine_streaming_tier(tmp_path, rng):
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path, prefetch_hot_interval_s=0.05),
                              device="cpu")
    try:
        eng.create_index("st", DIM, "L2", 8, 0, 0, "streaming")
        _build_and_activate(eng, "st", src)
        st = eng.get_state("st")
        assert type(st.index).__name__ == "StreamingIVFFlatIndex"
        p = SearchParams(nprobe=8, k=3)
        got = _serve(eng, "st", x[:12], p)
        assert (got[1][:, 0] == ids[:12]).all()
        with pytest.raises(PermissionError):
            eng.remove_vectors("st", ids[:1])
        for _ in range(500):            # the hotness loop queues staging
            if eng.prefetch_scheduler.completed:
                break
            time.sleep(0.01)
        assert eng.prefetch_scheduler.completed >= 1
    finally:
        eng.close()


def test_engine_dispatch_groups_mixed_params(tmp_path, rng):
    """One drained batch with requests of different k / nprobe: each gets
    its own slice of its own group's search."""
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path, coalesce_window_ms=50.0),
                              device="cpu")
    try:
        eng.create_index("docs", DIM, "L2", 8, 0, 0)
        _build_and_activate(eng, "docs", src)
        st = eng.get_state("docs")
        reqs = [(x[i * 3:i * 3 + 3], SearchParams(nprobe=2 + i % 2 * 6,
                                                  k=3 + i % 3))
                for i in range(6)]
        futs = [(eng.submit_search(st, q, p), q, p) for q, p in reqs]
        for fut, q, p in futs:
            d, got = eng.finish_search(fut, "docs", time.monotonic(), len(q))
            _same((d, got), st.index.search(q, p), q)
        assert st.coalescer.stats()["batches"] < len(reqs)
    finally:
        eng.close()


# --------------------------------------------------------------------------- #
# the serving engine's spans and stages
# --------------------------------------------------------------------------- #

# the spans every coalesced batch of a resident IVF-Flat index on the CPU
# opens (the queue's empty wait may or may not come; there is no wait for
# the card)
SERVED_SPANS = {
    "engine.submit", "engine.dispatch", "engine.finish", "coalescer.window",
    "coalescer.handoff", "coalescer.resolve", "coalescer.scatter",
    "ivf_flat.upload", "ivf_flat.coarse_probe", "ivf_flat.finalize",
    "ivf_flat.copy", "ivf_flat.id_map",
}
NEW_STAGES = ("window_wait", "handoff_wait", "fetch_wait", "enqueue")


def _live_engine(tmp_path, rng):
    x, _ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path), device="cpu")
    eng.create_index("docs", DIM, "L2", 8, 0, 0)
    _build_and_activate(eng, "docs", src)
    return eng, x


def _counting_record_function(monkeypatch) -> list:
    """The names of the ``record_function`` ranges entered from now on,
    whichever way they were opened."""
    entered = []
    rf = torch.autograd.profiler.record_function
    orig = rf.__enter__

    def counting(self):
        entered.append(self.name)
        return orig(self)

    monkeypatch.setattr(rf, "__enter__", counting)
    return entered


def test_coalescer_records_one_window_wait_a_drain(monkeypatch):
    """64-query requests through a coalescer whose cap counts queries
    (``weight_fn``): each drain records one ``window_wait``, each pipelined
    batch one ``handoff_wait``."""
    m = t_metrics.MetricsCollector()
    drains = []
    orig = t_balancer.PriorityRequestQueue.drain

    def drain(self, *a, **kw):
        out = orig(self, *a, **kw)
        drains.append(len(out))
        return out

    monkeypatch.setattr(t_balancer.PriorityRequestQueue, "drain", drain)
    co = t_coalescer.RequestCoalescer(
        dispatch_fn=lambda items: (lambda: [len(q) for q in items]),
        window_s=0.002, max_batch=64, weight_fn=len,
        record_stage=m.record_stage)
    for _ in range(5):
        assert co.submit(np.zeros((64, DIM))).result(timeout=10) == 64
    co.stop()
    stages = m.get_stage_percentiles()
    assert stages["window_wait"]["count"] == len(drains) >= 6
    assert stages["window_wait"]["p50"] >= 0.0
    assert stages["handoff_wait"]["count"] == co.stats()["batches"] == 5


def test_a_drain_with_max_n_queued_records_a_zero_window_wait():
    """A drain that finds ``max_n`` items queued waits out no window: it
    records ``window_wait`` 0.0 and opens no window span."""
    got = []
    q = t_balancer.PriorityRequestQueue()
    for i in range(3):
        q.put(i)
    with t_profiling.profiler_session() as (prof, _):
        assert q.drain(3, 30.0, record_stage=lambda stage, ms:
                       got.append((stage, ms))) == [0, 1, 2]
    assert got == [("window_wait", 0.0), ("window_cap", 0.0)]
    names = {e.get("name") for e in
             t_profiling.chrome_trace(prof)["traceEvents"]}
    assert not {"coalescer.window", "coalescer.wait_request"} & names


def _timed_drain(queued, put_later, window_s, **kw):
    """``drain(3 items or kw's cap, window_s)`` over ``queued``, with
    ``put_later`` put by another thread 0.1 s into the window, in a
    profiler session: (batch, [(stage, ms)], seconds, range names)."""
    got = []
    q = t_balancer.PriorityRequestQueue()
    for item in queued:
        q.put(item)

    def later():
        time.sleep(0.1)
        for item in put_later:
            q.put(item)

    putter = threading.Thread(target=later)
    with t_profiling.profiler_session() as (prof, _):
        putter.start()
        t0 = time.monotonic()
        out = q.drain(kw.pop("max_n", 3), window_s, **kw,
                      record_stage=lambda stage, ms: got.append((stage, ms)))
        took = time.monotonic() - t0
    putter.join(timeout=5)
    assert not putter.is_alive()
    names = {e.get("name") for e in
             t_profiling.chrome_trace(prof)["traceEvents"]}
    return out, got, took, names


@pytest.mark.parametrize("queued, put_later, window_s, ended", [
    ((40, 24), (), 30.0, None),                # the cap queued already
    ((32,), (32,), 30.0, "window_cap"),        # a put fills it
    ((10,), (), 0.2, "window_deadline"),       # below the cap
])
def test_a_weight_capped_drain_ends_its_window_at_the_cap(
        queued, put_later, window_s, ended):
    """A drain whose cap counts weight (64) opens no window where the
    queued weight already reaches the cap, ends its window once another
    thread's put brings the weight there, and waits the window out below
    it; each drain records one ``window_wait`` and how its window ended."""
    out, got, took, names = _timed_drain(
        queued, put_later, window_s, max_n=64, weight_fn=lambda w: w,
        max_weight=64)
    assert out == list(queued + put_later)
    stages = dict(got)
    assert len(got) == len(stages) == 2
    if ended is None:
        assert got == [("window_wait", 0.0), ("window_cap", 0.0)]
        assert took < 5.0 and "coalescer.window" not in names
        return
    assert "coalescer.window" in names and set(stages) == {
        "window_wait", ended}
    assert stages[ended] <= took * 1e3
    if ended == "window_cap":
        assert 0.1 <= took < 5.0
    else:
        assert stages["window_deadline"] >= window_s * 1e3


@pytest.mark.parametrize("queued, put_later, window_s", [
    ((0, 1, 2), (), 30.0),      # max_n queued already
    ((0,), (1, 2), 30.0),       # a put brings max_n
    ((0,), (), 0.2),            # short of max_n: waited out
])
def test_weight_one_items_drain_as_the_item_rule(queued, put_later,
                                                 window_s):
    """Items of weight 1 under a weight cap of ``max_n`` drain the same
    batch and end the window the same way as the item rule alone."""
    by_weight = _timed_drain(queued, put_later, window_s,
                             weight_fn=lambda _: 1, max_weight=3)
    by_items = _timed_drain(queued, put_later, window_s)
    for out, got, took, names in (by_weight, by_items):
        assert out == list(queued + put_later)
    shape = [[(stage, ms == 0.0) for stage, ms in got]
             for _out, got, _took, _names in (by_weight, by_items)]
    assert shape[0] == shape[1]


def test_engine_spans_and_stages_of_a_cpu_batch(tmp_path, rng):
    """Coalesced searches of a CPU index in a session of every thread:
    each batch records ``fetch_wait`` 0.0 (no card to wait for) and its
    enqueue's host ms (``enqueue``), and opens the engine's, the
    coalescer's and the search module's spans, the id map inside the
    finalize on the finalize thread."""
    eng, x = _live_engine(tmp_path, rng)
    try:
        st = eng.get_state("docs")
        b0 = st.coalescer.stats()["batches"]
        eng.metrics.reset_windows()
        with t_profiling.profiler_session(all_threads=True) as (prof, _):
            _serve(eng, "docs", x[:16], SearchParams(nprobe=8, k=5),
                   threads=2)
        batches = st.coalescer.stats()["batches"] - b0
        stages = eng.metrics.get_stage_percentiles()
    finally:
        eng.close()
    assert stages["fetch_wait"]["count"] == batches > 0
    assert stages["fetch_wait"]["max"] == 0.0
    assert stages["enqueue"]["count"] == batches
    assert stages["enqueue"]["p50"] > 0.0
    assert stages["handoff_wait"]["count"] == batches
    assert stages["window_wait"]["count"] >= batches
    events = [e for e in t_profiling.chrome_trace(prof)["traceEvents"]
              if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in events}
    assert SERVED_SPANS <= names and "ivf_flat.fetch_wait" not in names
    finals = [e for e in events if e["name"] == "ivf_flat.finalize"]
    resolves = [e for e in events if e["name"] == "coalescer.resolve"]

    def inside(e, outer):
        return any(o["tid"] == e["tid"] and o["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                   for o in outer)

    id_maps = [e for e in events if e["name"] == "ivf_flat.id_map"]
    assert len(id_maps) == batches
    assert all(inside(e, finals) for e in id_maps)
    assert all(inside(e, resolves) for e in finals)


# each family the engine serves: create_index's m and tier, the engine's
# settings (a two-shard CPU mesh for the sharded views) and the index class
SERVED_FAMILIES = {
    "ivf_flat": (0, "", {}, "IVFFlatIndex"),
    "ivf_pq": (4, "", {}, "IVFPQIndex"),
    "sharded_ivf_flat": (0, "", dict(shard_serving="on", mesh_shards=2),
                         "ShardedIVFFlatIndex"),
    "sharded_ivf_pq": (4, "", dict(shard_serving="on", mesh_shards=2),
                       "ShardedIVFPQIndex"),
    "streaming": (0, "streaming", {}, "StreamingIVFFlatIndex"),
    # IVF-Flat behind a wrapper that hands the engine a plain callable, as
    # the benchmark's fault injection does
    "wrapped_ivf_flat": (0, "", {}, "IVFFlatIndex"),
}


@pytest.mark.parametrize("family", list(SERVED_FAMILIES))
def test_engine_records_the_waits_a_search_exposes(tmp_path, rng,
                                                   monkeypatch, family):
    """Every family's ``search_async`` returns a ``PendingSearch`` that
    answers as ``search`` does, bit for bit, with ``waits`` and ``counts``
    dicts; the engine records ``fetch_wait`` and ``enqueue`` from them for
    the families that enqueue, and none for the streaming tier, which
    searches synchronously, or for a plain callable, whose answers it
    serves all the same."""
    m, tier, engine_kw, cls_name = SERVED_FAMILIES[family]
    if family == "wrapped_ivf_flat":
        orig = IVFFlatIndex.search_async

        def bare(self, queries, params=None):
            fin = orig(self, queries, params)
            return lambda: fin()

        monkeypatch.setattr(IVFFlatIndex, "search_async", bare)
    x, _ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path, **engine_kw), device="cpu")
    p = SearchParams(nprobe=8, k=5)
    try:
        eng.create_index("docs", DIM, "L2", 8, m, 8 if m else 0, tier)
        _build_and_activate(eng, "docs", src)
        index = eng.get_state("docs").index
        pending = index.search_async(x[:6], p)
        got = pending()
        want = index.search(x[:6], p)
        _serve(eng, "docs", x[:8], p)
        stages = eng.metrics.get_stage_percentiles()
    finally:
        eng.close()
    assert type(index).__name__ == cls_name
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    enqueues = family not in ("streaming", "wrapped_ivf_flat")
    if family != "wrapped_ivf_flat":
        assert type(pending.waits) is dict and pending.counts == {}
        assert set(pending.waits) == (
            {"fetch_wait", "enqueue"} if enqueues else set())
    if enqueues:
        assert pending.waits["fetch_wait"] == 0.0
        assert pending.waits["enqueue"] > 0.0
        assert stages["fetch_wait"]["count"] == stages["enqueue"]["count"] > 0
    else:
        assert "fetch_wait" not in stages and "enqueue" not in stages
    assert stages["dispatch"]["count"] > 0


def test_engine_serves_without_entering_record_function(tmp_path, rng,
                                                        monkeypatch):
    """No profiler running: the served path enters no ``record_function``
    range; in a session of every thread it enters each served span."""
    eng, x = _live_engine(tmp_path, rng)
    entered = _counting_record_function(monkeypatch)
    p = SearchParams(nprobe=8, k=5)
    try:
        _serve(eng, "docs", x[:8], p)
        assert entered == []
        with t_profiling.profiler_session(all_threads=True):
            _serve(eng, "docs", x[:8], p)
    finally:
        eng.close()
    assert SERVED_SPANS <= set(entered)


def test_engine_prometheus_text_lists_the_new_stages(tmp_path, rng):
    """The new stages are samples of ``vdb_stage_milliseconds``; the text
    holds the same metric families as before them."""
    from prometheus_client.parser import text_string_to_metric_families

    eng, x = _live_engine(tmp_path, rng)
    try:
        _serve(eng, "docs", x[:8], SearchParams(nprobe=8, k=5))
        text = eng.metrics.prometheus_text().decode()
    finally:
        eng.close()
    before = _record(t_metrics.MetricsCollector()).prometheus_text().decode()
    assert ({f.name for f in text_string_to_metric_families(text)}
            == {f.name for f in text_string_to_metric_families(before)})
    for stage in NEW_STAGES:
        for stat in ("p50", "p95", "p99", "max", "mean"):
            assert (f'vdb_stage_milliseconds{{stage="{stage}",'
                    f'stat="{stat}"}}') in text
        assert f'vdb_stage_samples{{stage="{stage}"}}' in text


def test_engine_admission_refusals(tmp_path, rng):
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path, rate_limit_burst=2,
                                      rate_limit_rps=1e-6,
                                      max_concurrent_requests=1),
                              device="cpu")
    try:
        eng.create_index("docs", DIM, "L2", 8, 0, 0)
        _build_and_activate(eng, "docs", src)
        st = eng.get_state("docs")
        p = SearchParams(nprobe=8, k=3)
        fut = eng.submit_search(st, x[:1], p)
        with pytest.raises(t_service.Rejected) as e:
            eng.submit_search(st, x[:1], p)      # the one slot is held
        assert e.value.code == "RESOURCE_EXHAUSTED"
        eng.finish_search(fut, "docs", time.monotonic(), 1)
        assert eng.limiter.active == 0
        with pytest.raises(t_service.Rejected, match="rate limit"):
            eng.submit_search(st, x[:1], p)      # the burst is spent
        eng.rate_limiter.set_rate(1e6, burst=100)
        for _ in range(20):
            eng.breaker.record(False)
        with pytest.raises(t_service.Rejected) as e:
            eng.submit_search(st, x[:1], p)
        assert e.value.code == "UNAVAILABLE"
    finally:
        eng.close()


def test_engine_deadline_and_queue_shedding(tmp_path, rng, monkeypatch):
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path, max_queued_requests=1),
                              device="cpu")
    try:
        eng.create_index("docs", DIM, "L2", 8, 0, 0)
        _build_and_activate(eng, "docs", src)
        st = eng.get_state("docs")
        gate = threading.Event()
        orig = st.index.search_async
        monkeypatch.setattr(st.index, "search_async",
                            lambda q, p: (gate.wait(5), orig(q, p))[1])
        p = SearchParams(nprobe=8, k=3)
        first = eng.submit_search(st, x[:1], p)   # drained, blocks on gate
        for _ in range(400):
            if st.coalescer.stats()["batches"]:
                break
            time.sleep(0.005)
        queued = eng.submit_search(st, x[1:2], p)
        with pytest.raises(t_service.Rejected, match="queue full"):
            eng.submit_search(st, x[2:3], p)
        monkeypatch.setattr(eng.adaptive, "timeout_s", lambda: 0.01)
        with pytest.raises(t_service.Rejected) as e:
            eng.finish_search(queued, "docs", time.monotonic(), 1)
        assert e.value.code == "DEADLINE_EXCEEDED"
        assert "cancelled while queued" in e.value.message
        gate.set()
        monkeypatch.setattr(eng.adaptive, "timeout_s", lambda: 10.0)
        eng.finish_search(first, "docs", time.monotonic(), 1)
        assert eng.limiter.active == 0 and queued.cancelled()
    finally:
        eng.close()


@pytest.mark.parametrize("kw,match", [
    (dict(shard_serving="on"), "parallel"),
    (dict(mesh_shards=4), "parallel"),
    (dict(query_upload_dtype="bfloat16"), "query_upload_dtype"),
])
def test_engine_unported_options_raise(tmp_path, kw, match):
    if match == "parallel":
        # ported since (parallel/): the option builds the engine's mesh,
        # "on" over one CPU shard, mesh_shards over that many
        eng = t_service.VdbEngine(_config(tmp_path, **kw), device="cpu")
        try:
            assert eng.mesh.devices.size == kw.get("mesh_shards", 1)
            assert all(d.type == "cpu" for d in eng.mesh.devices)
        finally:
            eng.close()
    else:
        with pytest.raises(NotImplementedError, match=match):
            t_service.VdbEngine(_config(tmp_path, **kw), device="cpu")
    with pytest.raises(ValueError, match="shard_serving"):
        t_service.VdbEngine(_config(tmp_path, shard_serving="maybe"),
                            device="cpu")
    t_service.VdbEngine(_config(tmp_path, shard_serving="off",
                                mesh_shards=4), device="cpu").close()


def test_engine_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        eng = t_service.VdbEngine(_config(tmp_path))
        assert eng.device.type == "cuda"
        eng.close()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_service.VdbEngine(_config(tmp_path))


def test_engine_warmup_failure_fails_activation(tmp_path, rng, monkeypatch):
    """A warm-up failure propagates: the activation raises and the index
    keeps serving its previous epoch."""
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path), device="cpu")
    try:
        eng.create_index("docs", DIM, "L2", 8, 0, 0)
        first = _build_and_activate(eng, "docs", src)
        eid = eng.build_epoch("docs")
        while not eng.build_jobs["docs"].done:
            time.sleep(0.02)

        def broken(self, *a, **kw):
            raise RuntimeError("kernel build failed")

        monkeypatch.setattr(IVFFlatIndex, "warmup_lists", broken)
        st = eng.get_state("docs")
        with pytest.raises(RuntimeError, match="kernel build failed"):
            eng._load_epoch_into(st, eid)
        assert st.epoch == first and st.index is not None
    finally:
        eng.close()


def test_engine_recovery_records_a_broken_epoch(tmp_path, rng, caplog):
    """A snapshot that fails to reload does not stop the engine: the error
    is logged and recorded on the index state; other indices serve."""
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path), device="cpu")
    eng.create_index("good", DIM, "L2", 8, 0, 0)
    eng.create_index("bad", DIM, "L2", 8, 0, 0)
    _build_and_activate(eng, "good", src)
    _build_and_activate(eng, "bad", src)
    eng.close()
    os.remove(os.path.join(eng.epochs.active_dir("bad"), "centroids.arrow"))
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    t_service.log.addHandler(handler)
    try:
        again = t_service.VdbEngine(_config(tmp_path), device="cpu")
    finally:
        t_service.log.removeHandler(handler)
    try:
        assert again.get_state("good").index is not None
        bad = again.get_state("bad")
        assert bad.index is None and "centroids.arrow" in bad.error
        assert any(r.levelno == logging.ERROR and "bad" in r.getMessage()
                   for r in records)
    finally:
        again.close()


def test_tombstone_log(tmp_path):
    """The deletion WAL: appends dedupe, a torn final record is dropped on
    a cold read, a finished build consumes only what it baked, and the
    atomic rewrite leaves no temp file (the JAX package's semantics)."""
    eng = t_service.VdbEngine(_config(tmp_path), device="cpu")
    try:
        name = "wal"
        os.makedirs(os.path.join(eng.indices_dir, name))
        for _ in range(3):
            eng._append_tombstones(name, np.array([7, 7, 8], np.uint64))
        assert os.path.getsize(eng._tombstone_path(name)) == 16
        with open(eng._tombstone_path(name), "ab") as f:
            f.write(b"\x01\x02\x03")
        eng._tomb_cache.pop(name)
        np.testing.assert_array_equal(eng._read_tombstones(name), [7, 8])
        baked = eng._read_tombstones(name)
        eng._append_tombstones(name, np.array([9], np.uint64))
        eng._consume_tombstones(name, baked)
        eng._tomb_cache.pop(name)
        np.testing.assert_array_equal(eng._read_tombstones(name), [9])
        d = os.path.dirname(eng._tombstone_path(name))
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
        eng._clear_tombstones(name)
        assert not os.path.exists(eng._tombstone_path(name))
    finally:
        eng.close()


def test_delete_during_warmup_lands_in_the_swapped_index(tmp_path, rng,
                                                         monkeypatch):
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path), device="cpu")
    try:
        eng.create_index("docs", DIM, "L2", 8, 0, 0)
        _build_and_activate(eng, "docs", src)
        st = eng.get_state("docs")
        victim = ids[57]
        orig = IVFFlatIndex.warmup_lists
        fired = []

        def delete_mid_warmup(self, *a, **kw):
            out = orig(self, *a, **kw)
            if not fired:
                fired.append(True)
                eng.remove_vectors("docs", np.array([victim], np.uint64))
            return out

        monkeypatch.setattr(IVFFlatIndex, "warmup_lists", delete_mid_warmup)
        eng._load_epoch_into(st, eng.epochs.active_epoch("docs"))
        assert fired and not np.isin(victim, st.index.arena.ids)
        assert np.isin(victim, eng._read_tombstones("docs"))
    finally:
        eng.close()


def test_auto_calibrate_on_build(tmp_path, rng):
    x, ids, src = _source(tmp_path, rng)
    eng = t_service.VdbEngine(_config(tmp_path, auto_calibrate_nprobe=True),
                              device="cpu")
    try:
        eng.create_index("cal", DIM, "L2", 8, 0, 0)
        eid = _build_and_activate(eng, "cal", src)
        st = eng.get_state("cal")
        with open(os.path.join(eng.epochs.epoch_dir("cal", eid),
                               "manifest.json")) as f:
            man = json.load(f)
        assert man["extra"]["calibrated_nprobe"] == st.index.calibrated_nprobe
    finally:
        eng.close()


def test_failed_build_reports_its_error(tmp_path):
    eng = t_service.VdbEngine(_config(tmp_path), device="cpu")
    try:
        eng.create_index("empty", DIM, "L2", 8, 0, 0)
        eng.build_epoch("empty")
        while not eng.build_jobs["empty"].done:
            time.sleep(0.02)
        assert "no data" in eng.build_jobs["empty"].error
        with pytest.raises(KeyError):
            eng.get_state("ghost")
    finally:
        eng.close()
