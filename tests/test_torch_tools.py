"""PyTorch port, the operational CLIs (``tools/``) on the CPU, as
``tests/test_tools.py`` drives the JAX package's: snapshots built by either
package's ``build_index`` load and search alike in the other, the benchmark
CSV has the JAX header, the recall sweep, ``autotune`` recommends what the
JAX tool recommends and persists it for a server, and ``load_test`` drives
a live port server (unary, packed, batched, deep k, streamed) and parses
its stage metrics as the JAX tool does."""

import csv
import json
import os

import grpc
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFFlatIndex as JFlatIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.storage.epoch import (
    EpochManager as JEpochManager,
)
from cuda_acceleratedvectordatabaseengine_tpu.tools import (
    autotune as j_autotune,
    benchmark as j_benchmark,
    build_index as j_build_index,
    load_test as j_load_test,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFFlatIndex,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
    ArrowStorage,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage.epoch import (
    EpochManager,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (
    autotune,
    benchmark,
    build_index,
    load_test,
    recall_test,
)

torch.set_num_threads(1)
RTOL = 1e-5        # the stated tolerance: RTOL · |d| + ATOL_QSQ · ‖q‖²
ATOL_QSQ = 1e-5
CPU = ["--device", "cpu"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _search_equal(port_idx, jax_idx, rng, dim, nprobe=8, k=5):
    q = rng.standard_normal((16, dim)).astype(np.float32)
    got = port_idx.search(q, SearchParams(nprobe=nprobe, k=k))
    want = jax_idx.search(q, JParams(nprobe=nprobe, k=k))
    assert_topk_match(*got, *(np.asarray(a) for a in want), rtol=RTOL,
                      atol=ATOL_QSQ * (q.astype(np.float64) ** 2).sum(1))


def test_build_index_cli_synthetic_loads_in_both(tmp_path, rng, capsys):
    out = str(tmp_path / "snap")
    rc = build_index.main([
        "--synthetic", "2000", "--dimension", "16", "--nlist", "8",
        "--output", out, "--dtype", "float32", *CPU,
    ])
    assert rc == 0
    report = _last_json(capsys)
    assert report["vectors"] == 2000 and report["snapshot"] == out
    assert os.path.isfile(os.path.join(out, "manifest.json"))
    idx = IVFFlatIndex.load(out, device="cpu")
    jidx = JFlatIndex.load(out)
    assert idx.ntotal == jidx.ntotal == 2000
    _search_equal(idx, jidx, rng, 16)


def test_jax_built_snapshot_loads_in_the_port(tmp_path, rng, capsys):
    out = str(tmp_path / "jsnap")
    assert j_build_index.main([
        "--synthetic", "2000", "--dimension", "16", "--nlist", "8",
        "--output", out, "--dtype", "float32",
    ]) == 0
    idx = IVFFlatIndex.load(out, device="cpu")
    assert idx.ntotal == 2000
    _search_equal(idx, JFlatIndex.load(out), rng, 16)


def test_build_index_cli_from_arrow_with_epoch(tmp_path, rng, capsys):
    src = str(tmp_path / "src.arrow")
    vecs = rng.standard_normal((1000, 8)).astype(np.float32)
    ArrowStorage.write_vectors(src, np.arange(1000, dtype=np.uint64), vecs)
    base = str(tmp_path / "epochs")
    rc = build_index.main([
        "--source", src, "--nlist", "4", "--output", "ignored",
        "--epoch-base", base, "--index-name", "foo", "--chunk-rows", "300",
        *CPU,
    ])
    assert rc == 0
    report = _last_json(capsys)
    eps = EpochManager(base).list_epochs("foo")["epochs"]
    assert list(eps) == [report["epoch"]]
    assert list(JEpochManager(base).list_epochs("foo")["epochs"]) == list(eps)
    idx = IVFFlatIndex.load(report["snapshot"], device="cpu")
    assert idx.ntotal == 1000
    d, ids = idx.search(vecs[:4], SearchParams(nprobe=4, k=1))
    assert (ids[:, 0] == np.arange(4)).all()


def test_benchmark_cli_csv_has_the_jax_header(tmp_path):
    out = str(tmp_path / "bench.csv")
    rc = benchmark.main([
        "--vectors", "5000", "--dimension", "16", "--nlist", "16",
        "--queries", "64", "--batch", "32", "--csv", out, *CPU,
    ])
    assert rc == 0
    jout = str(tmp_path / "jbench.csv")
    assert j_benchmark.main([
        "--vectors", "2000", "--dimension", "16", "--nlist", "8",
        "--queries", "32", "--batch", "32", "--csv", jout,
    ]) == 0
    with open(out) as f:
        rows = list(csv.reader(f))
    with open(jout) as f:
        jrows = list(csv.reader(f))
    assert rows[0] == jrows[0] == benchmark.HEADER
    assert len(rows) == 2 and len(rows[1]) == len(rows[0])
    assert rows[1][:5] == ["5000", "16", "16", "10", "10"]
    assert float(rows[1][8]) > 0  # qps


@pytest.mark.parametrize("pq_m", [0, 4])
def test_recall_cli(capsys, pq_m):
    rc = recall_test.main([
        "--vectors", "3000", "--dimension", "16", "--nlist", "8",
        "--queries", "32", "--nprobe", "2", "8", "--pq-m", str(pq_m), *CPU,
    ])
    assert rc == 0
    rows = _last_json(capsys)
    # full probe must beat partial probe and be ~1.0 (queries are perturbed
    # corpus points); with PQ the exact rerank recovers it
    by_probe = {(r["nprobe"], r["rerank"]): r["recall@10"] for r in rows}
    assert by_probe[(8, bool(pq_m))] >= by_probe[(2, bool(pq_m))]
    assert by_probe[(8, bool(pq_m))] > 0.9
    assert len(rows) == (4 if pq_m else 2)


def test_recall_ground_truth_is_exact(rng):
    x = rng.standard_normal((500, 8)).astype(np.float32)
    q = rng.standard_normal((300, 8)).astype(np.float32)
    truth = recall_test.ground_truth(q, x, 5)
    d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(truth, np.argsort(d, axis=1,
                                                    kind="stable")[:, :5])
    assert recall_test.recall_at_k(truth.astype(np.uint64), truth) == 1.0
    assert recall_test.recall_at_k(truth[:, ::-1].copy(), truth) == 1.0


def test_autotune_cli_recommends_and_persists(tmp_path, capsys):
    """The tuned nprobe meets its target, is persisted into the manifest
    and reloads into ``SearchParams(nprobe=0)``."""
    snap = str(tmp_path / "snap")
    assert build_index.main([
        "--synthetic", "4000", "--dimension", "16", "--nlist", "16",
        "--output", snap, "--dtype", "float32", *CPU,
    ]) == 0
    capsys.readouterr()
    rc = autotune.main([
        "--snapshot", snap, "--target-coverage", "0.9", "--k", "5",
        "--sample", "128", "--measure-qps", "--batch", "32",
        "--qps-batches", "2", "--persist", *CPU,
    ])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["recommended_nprobe"] >= 1
    assert str(rep["recommended_nprobe"]) in rep["coverage_curve"]
    assert rep["measured_coverage"] >= 0.9 or rep["coverage_limited"]
    assert rep["sequential_qps"] > 0
    assert rep["persisted"] is True
    assert rep["reference_static_nprobe"] == 16  # <1M tier

    idx = IVFFlatIndex.load(snap, device="cpu")
    assert idx.calibrated_nprobe == rep["recommended_nprobe"]
    q = np.zeros((2, 16), np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=0, k=5))  # the calibration
    assert ids.shape == (2, 5)
    assert JFlatIndex.load(snap).calibrated_nprobe == rep[
        "recommended_nprobe"]


def test_autotune_recommends_what_the_jax_tool_does(tmp_path, capsys):
    """One JAX-built snapshot, both packages' tools: the same recommended
    nprobe and the same coverage curve."""
    snap = str(tmp_path / "jsnap")
    assert j_build_index.main([
        "--synthetic", "4000", "--dimension", "16", "--nlist", "16",
        "--output", snap, "--dtype", "float32",
    ]) == 0
    args = ["--snapshot", snap, "--target-coverage", "0.95", "--k", "5",
            "--sample", "256"]
    capsys.readouterr()
    assert autotune.main(args + CPU) == 0
    mine = json.loads(capsys.readouterr().out)
    assert j_autotune.main(args) == 0
    theirs = json.loads(capsys.readouterr().out)
    for key in ("recommended_nprobe", "measured_coverage", "coverage_curve",
                "coverage_limited", "ntotal", "kind", "arena_dtype"):
        assert mine[key] == theirs[key], key
    assert set(mine) == set(theirs)


def test_autotune_cli_ivf_pq_snapshot(tmp_path, capsys):
    snap = str(tmp_path / "pqsnap")
    assert build_index.main([
        "--synthetic", "3000", "--dimension", "16", "--nlist", "8",
        "--pq-m", "4", "--output", snap, *CPU,
    ]) == 0
    capsys.readouterr()
    rc = autotune.main([
        "--snapshot", snap, "--target-coverage", "0.9", "--k", "5",
        "--sample", "64", "--measure-qps", "--batch", "16",
        "--qps-batches", "1", *CPU,
    ])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["kind"] == "ivf_pq"
    assert rep["recommended_nprobe"] >= 1 and rep["sequential_qps"] > 0
    assert IVFPQIndex.load(snap, device="cpu").ntotal == 3000


# --------------------------------------------------------------------------- #
# load_test against a live port server, on an epoch from build_index
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tuned_server(tmp_path_factory):
    """``build_index`` into a server's epochs, ``autotune --persist``, then
    a port server that activates the epoch over the wire (CreateIndex,
    ActivateEpoch) and serves it with its ``/metrics`` endpoint."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.config import (
        ServerConfig,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.grpc_api \
        import AdminServiceClient
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.main import (
        build_server,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto import (
        vdb_pb2,
    )

    data = tmp_path_factory.mktemp("vdb-data")
    assert build_index.main([
        "--synthetic", "600", "--dimension", "8", "--nlist", "4",
        "--output", "ignored", "--epoch-base", str(data / "epochs"),
        "--index-name", "lt", "--dtype", "float32", *CPU,
    ]) == 0
    epoch = EpochManager(str(data / "epochs")).list_epochs("lt")["epochs"]
    (eid,) = epoch
    snap = EpochManager(str(data / "epochs")).epoch_dir("lt", eid)
    assert autotune.main(["--snapshot", snap, "--target-coverage", "0.9",
                          "--sample", "64", "--persist", "--output",
                          str(data / "tune.json"), *CPU]) == 0
    with open(data / "tune.json") as f:
        tuned = json.load(f)
    config = ServerConfig(address="127.0.0.1:0", data_path=str(data),
                          coalesce_window_ms=1.0, max_batch_size=16,
                          warm_nprobes=(), prefetch_hot_interval_s=0.0)
    server, engine, health, port = build_server(config, device="cpu")
    server.start()
    metrics_port = engine.metrics.start_exposition(0)
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    grpc.channel_ready_future(channel).result(timeout=30)
    admin = AdminServiceClient(channel)
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(name="lt", dimension=8,
                                                 nlist=4))
    admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="lt", epoch=eid))
    try:
        yield {"port": port, "engine": engine, "tuned": tuned,
               "metrics": f"http://127.0.0.1:{metrics_port}/metrics"}
    finally:
        channel.close()
        engine.metrics.stop_exposition()
        server.stop(grace=None)
        health.stop()
        engine.close()


def test_server_serves_the_persisted_nprobe(tuned_server):
    st = tuned_server["engine"].get_state("lt")
    assert st.index.ntotal == 600
    assert st.index.calibrated_nprobe == tuned_server["tuned"][
        "recommended_nprobe"]


@pytest.mark.parametrize("mode", [[], ["--packed"], ["--packed", "--batch",
                                                     "4"],
                                  ["--topk", "100"], ["--stream"]],
                         ids=["unary", "packed", "batch4", "topk100",
                              "stream"])
def test_load_test_cli_against_live_server(tuned_server, capsys, mode):
    rc = load_test.main([
        "--target", f"127.0.0.1:{tuned_server['port']}", "--index", "lt",
        "--dimension", "8", "--threads", "2", "--requests", "5",
        "--nprobe", "0", "--metrics-url", tuned_server["metrics"], *mode,
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["success_rate"] == 1.0 and report["n_errors"] == 0
    assert report["qps"] > 0 and report["requests"] == 10
    assert report["stream"] == ("--stream" in mode)
    assert report["packed_wire"] == ("--packed" in mode)
    assert "server_p99_ms" in report
    stages = report["server_stages_ms"]
    assert stages and all("p50" in v for v in stages.values())


def test_parse_stage_metrics_matches_jax(tuned_server, capsys):
    import urllib.request

    assert load_test.main([
        "--target", f"127.0.0.1:{tuned_server['port']}", "--index", "lt",
        "--dimension", "8", "--threads", "1", "--requests", "3",
    ]) == 0
    with urllib.request.urlopen(tuned_server["metrics"], timeout=10) as r:
        text = r.read().decode()
    assert "vdb_stage_milliseconds" in text
    got = load_test.parse_stage_metrics(text)
    assert got and got == j_load_test.parse_stage_metrics(text)
    assert load_test.parse_stage_metrics("") == {}
