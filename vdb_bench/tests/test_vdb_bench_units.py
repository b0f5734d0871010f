"""The harness's arithmetic on hand-made inputs."""

import json
import shutil

import numpy as np
import pytest
import torch

from vdb_bench import readers, roofline, spec, trace, traffic
from vdb_bench.harness import Run

OPEN_MIX = {"loop": "open", "rate_per_s": 500, "workers": 16,
            "queries_per_request": 1, "k": 10}


def test_poisson_schedule_repeats_for_one_seed():
    a = traffic.Schedule(OPEN_MIX, 1000, 2**31 + 7, 4.0, phase=1)
    b = traffic.Schedule(OPEN_MIX, 1000, 2**31 + 7, 4.0, phase=1)
    c = traffic.Schedule(OPEN_MIX, 1000, 2**31 + 8, 4.0, phase=1)
    assert np.array_equal(a.arrivals, b.arrivals)
    assert [a.pool_rows(i).tolist() for i in range(50)] == \
        [b.pool_rows(i).tolist() for i in range(50)]
    # every seed sends the same number of requests, at other times
    assert a.arrivals.size == c.arrivals.size == 2000
    assert not np.array_equal(a.arrivals, c.arrivals)
    assert np.all(np.diff(a.arrivals) >= 0)
    assert 0 <= a.arrivals[0] and a.arrivals[-1] < 4.0


def test_closed_schedule_reads_the_pool_evenly():
    mix = {"loop": "closed", "callers": 4, "queries_per_request": 64, "k": 10}
    s = traffic.Schedule(mix, 640, 3, 1.0, phase=1)
    seen = np.concatenate([s.pool_rows(i) for i in range(10)])
    assert sorted(seen.tolist()) == list(range(640))
    assert s.threads == 4 and s.arrivals is None


def _cols(t_due, latency_s, status=None, got=None):
    t_due = np.asarray(t_due, float)
    n = t_due.size
    return {"t_due": t_due, "t_sent": t_due,
            "t_done": t_due + np.asarray(latency_s, float),
            "status": (np.zeros(n, np.int8) if status is None
                       else np.asarray(status, np.int8)),
            "got": np.ones(n, np.int32) if got is None else np.asarray(got)}


def test_a_tail_counts_a_failure_as_a_missed_limit():
    due = np.arange(1011) * 0.001
    lat = np.full(1011, 0.002)
    lat[1000:] = 0.0001          # the failures failed fast
    refused = np.zeros(1011, np.int8)
    refused[1000:] = traffic.REFUSED

    def p99(sl, status=None):
        run = Run(cols=_cols(due[sl], lat[sl],
                             None if status is None else status[sl]),
                  t_close=10.0)
        return readers.latency_ms(run, 0.99)

    assert p99(slice(0, 1000)) == pytest.approx(2.0)
    # eleven failures among 1,000 requests: the 99th percentile falls on one
    # of them, however fast they failed
    assert p99(slice(11, 1011), refused) == readers.FAILED_MS
    # ten failures: the percentile still lands on an answer
    assert p99(slice(10, 1010), refused) == pytest.approx(2.0)
    # an error inside the program counts the same
    err = np.where(refused == traffic.REFUSED, traffic.ERROR, 0)
    assert p99(slice(11, 1011), err) == readers.FAILED_MS
    # the median reader: half the requests failed → it falls on a failure
    half = np.where(np.arange(1011) % 2 == 0, traffic.REFUSED, 0)
    read = spec.load_reader("p50_ms")
    assert read(Run(cols=_cols(due, lat, half), t_close=10.0)) == \
        readers.FAILED_MS


def test_a_tail_leaves_out_requests_due_after_the_close():
    due = np.append(np.arange(1000) * 0.001, 5.0)
    lat = np.append(np.full(1000, 0.002), 9.0)
    run = Run(cols=_cols(due, lat), t_close=1.5)
    assert readers.latency_ms(run, 0.99) == pytest.approx(2.0)
    assert readers.latency_ms(run, 1.0) == pytest.approx(2.0)


def test_busy_union_and_idle_on_a_hand_trace():
    # marker 0–100 µs; kernels overlap at 10–30 and 20–40, a copy at 90–120
    # runs past the marker, one kernel lies before it
    window = {"span_us": (0.0, 100.0),
              "device": [(10.0, 30.0, "k1", "kernel"),
                         (20.0, 40.0, "k2", "kernel"),
                         (90.0, 120.0, "copy", "gpu_memcpy"),
                         (-50.0, -10.0, "k0", "kernel")],
              "ranges": [(0.0, 60.0, "ivf_flat.finalize"),
                         (45.0, 55.0, "ivf_flat.upload")]}
    busy, span = trace.busy_and_span([window])
    assert busy == pytest.approx(40e-6)          # 10–40 and 90–100
    assert span == pytest.approx(100e-6)
    read = spec.load_reader("idle_share")
    assert read(Run(windows=[window], on_card=True)) == pytest.approx(0.6)
    assert trace.idle_gaps(window["device"], 0.0, 100.0) == [
        (0.0, 10.0), (40.0, 90.0)]
    b = trace.breakdown([window])
    assert dict((k, v) for k, v in b["device_ops"]) == {
        "k1": pytest.approx(20e-6), "k2": pytest.approx(20e-6),
        "copy": pytest.approx(10e-6)}
    # 0–10 lies in finalize alone; 40–90's middle (65) in no range
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "ivf_flat.finalize": pytest.approx(10e-6),
        "no host range open": pytest.approx(50e-6)}


def test_grouped_scan_bound_on_a_hand_case():
    # two queries, two probes each; lists 0, 1, 3 probed, list 1 twice
    probe = torch.tensor([[0, 1], [1, 3]])
    counts = torch.tensor([5, 7, 100, 3])
    b = roofline.grouped_scan_bound(probe, counts, cap_s=128, dim=4,
                                    elem_bytes=2, k=10)
    pair_slots = 5 + 7 + 7 + 3
    list_slots = 5 + 7 + 3
    assert b["flops"] == 2 * 4 * pair_slots
    row = 4 * 2 + 4                      # bf16 row and its fp32 norm
    assert b["bytes"] == row * list_slots + 2 * 4 * 4 + 2 * 2 * 10 * 8
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(b["bytes"] / roofline.PEAK_HBM_BYTES)
    # int8 rows carry a scale, and their lists' anchors are read once
    b8 = roofline.grouped_scan_bound(probe, counts, 128, 4, 1, 10,
                                     scaled=True, anchored=True)
    assert b8["bytes"] == ((4 + 4 + 4) * list_slots + 3 * 4 * 4
                           + 2 * 4 * 4 + 2 * 2 * 10 * 8)


def test_names_and_units_keep_to_their_characters():
    assert spec.name_problems(spec.load_benchmark()) == []
    bad = {"configs": [{"name": "a b", "reduced": ["x/y"]}],
           "workloads": [], "per_layer": [],
           "end_to_end": [{"name": "qps", "unit": "queries per s"}]}
    assert len(spec.name_problems(bad)) == 3
    assert spec.NAME.fullmatch("search_host_ms.q1")
    assert not spec.UNIT.fullmatch("µs")


def test_a_new_configuration_traffic_and_metric_are_found_by_name(tmp_path):
    base = tmp_path / "vdb_bench"
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    cfg = json.loads((base / "configs" / "sift-1m-128.json").read_text())
    cfg["name"] = "other-2m-64"
    (base / "configs" / "other-2m-64.json").write_text(json.dumps(cfg))
    (base / "traffic" / "open-q1-other.json").write_text(json.dumps(OPEN_MIX))
    (base / "metrics" / "batch_share.q1.py").write_text(
        "def read(run):\n    return run.answer\n")
    bench["configs"].append({"name": "other-2m-64", "source": "x",
                             "file": "vdb_bench/configs/other-2m-64.json",
                             "reduced": [], "why": "y"})
    bench["workloads"].append({"name": "other-2m-64.q1",
                               "config": "other-2m-64",
                               "traffic": "open-q1-other", "chips": 1,
                               "why": "z"})
    bench["per_layer"].append({"name": "batch_share.q1", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "p50_ms",
                               "workloads": ["other-2m-64.q1"]})
    # a quantity split by the metric it moves reads its stem's reader
    bench["per_layer"].append({"name": "queue_wait_ms.q1", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "p50_ms",
                               "workloads": ["other-2m-64.q1"]})
    bench["end_to_end"].append({"name": "p50_ms", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["other-2m-64.q1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve(spec.load_benchmark(tmp_path), "other-2m-64.q1",
                        base=base)
    assert cell.config["name"] == "other-2m-64"
    assert cell.traffic == OPEN_MIX
    e2e = {m["name"] for m in cell.end_to_end}
    layer = {m["name"] for m in cell.per_layer}
    # metrics that list their cells stay silent in a cell they do not list;
    # those that list none report in every cell (per layer: every cell that
    # reports the end-to-end metric they move)
    assert {"setup_s", "recall_at_10", "device_gb"} <= e2e
    assert "p50_ms" in e2e and "qps" not in e2e
    assert {"batch_share.q1", "queue_wait_ms.q1"} <= layer
    # train_s and arena_gb list the accepted cells: a new cell reports
    # them once it is listed there
    assert not {"k1_roofline", "queue_wait_ms", "train_s",
                "arena_gb"} & layer
    # the configuration's index kind is loaded from under the same base
    assert cell.kind.__file__ == str(base / "kinds" / "ivf_flat.py")
    read = spec.load_reader("batch_share.q1", base=base)
    assert read(Run(answer=42)) == 42
    assert spec.reader_path("queue_wait_ms.q1", base) == (
        base / "metrics" / "queue_wait_ms.py")
    assert spec.reader_path("batch_share.q1", base) == (
        base / "metrics" / "batch_share.q1.py")
    assert spec.load_reader("queue_wait_ms.q1", base=base)(
        Run(stages={"queue_wait": {"p50": 2.5}})) == 2.5


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.resolve(bench, w["name"])
        assert cell.config["index"]["nprobe"] > 0
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert {"qps", "p50_ms"} & e2e
        assert cell.per_layer


def test_qps_counts_answers_inside_the_window():
    read = spec.load_reader("qps")
    cols = _cols([0.0, 0.5, 0.6], [0.5, 0.7, 0.3],
                 [0, 0, traffic.ERROR], [64, 64, 0])
    assert read(Run(cols=cols, t_close=1.0, seconds=1.0)) == 64.0
    assert read(Run(cols=cols, t_close=2.0, seconds=2.0)) == 64.0


def test_the_log_keeps_each_request_in_its_row():
    log = traffic.Log(per_request=2, k=3)
    d = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    ids = np.arange(6, dtype=np.uint64).reshape(2, 3)
    log.put(traffic.Log.CHUNK + 1, np.array([7, 8]), 1.0, 1.1, 1.5,
            traffic.OK, (d, ids), "")
    log.put(0, np.array([1, 2]), 0.0, 0.1, 0.2, traffic.OK, (d[:1], ids[:1]),
            "")
    log.put(2, np.array([3, 4]), 0.5, 0.5, 0.6, traffic.OK,
            (d[:, :2], ids[:, :2]), "")
    c = log.columns()
    assert c["request"].tolist() == [0, 2, traffic.Log.CHUNK + 1]
    assert c["got"].tolist() == [1, 0, 2]
    assert c["status"].tolist() == [traffic.OK, traffic.ERROR, traffic.OK]
    assert np.array_equal(c["ids"][2], ids) and c["rows"][2].tolist() == [7, 8]
    assert "shape" in log.notes[2]


def test_the_sweep_counts_a_failure_as_a_missed_limit():
    from vdb_bench import sweep

    due = np.arange(1011) * 0.001
    lat = np.full(1011, 0.002)
    lat[1000:] = 0.0001
    status = np.zeros(1011, np.int8)
    status[1000:] = traffic.REFUSED
    cols = _cols(due, lat, status)
    out = sweep._summary({"cols": cols, "t0": 0.0, "ended": True}, 2.0)
    assert out["requests"] == 1011 and out["failed"] == 11
    assert out["p99_ms"] == float("inf") and out["max_ms"] == float("inf")
    assert out["p50_ms"] == pytest.approx(2.0)
    read = spec.load_reader("p99_ms")
    assert read(Run(cols=cols, t_close=2.0)) == readers.FAILED_MS


def test_a_query_is_as_far_from_each_ball_of_its_group():
    from vdb_bench.corpus import Corpus, query_pool

    cfg = {"n": 4096, "dim": 48, "balls": 64, "group": 8,
           "group_radius": 4.0, "noise": 0.25, "query_noise": 0.25,
           "queries": 200}
    corpus = Corpus(cfg, 2**33 + 5, "cpu")
    pool = query_pool(corpus, cfg, 2**33 + 5)
    assert torch.equal(pool, query_pool(Corpus(cfg, 2**33 + 5, "cpu"), cfg,
                                        2**33 + 5))
    d = torch.cdist(pool.double(), corpus.centers.double()) ** 2
    near = d.topk(8, dim=1, largest=False)
    # the eight nearest centres are one group's, all at one distance ...
    groups = near.indices // 8
    assert bool((groups == groups[:, :1]).all())
    spread = near.values[:, -1] - near.values[:, 0]
    assert float((spread / near.values[:, 0]).max()) < 1e-5
    # ... and every other centre lies well beyond them
    ninth = d.topk(9, dim=1, largest=False).values[:, -1]
    assert float((ninth / near.values[:, -1]).min()) > 1.5
