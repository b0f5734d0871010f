"""PyTorch port, the gRPC front end on the CPU: a live in-process server
(``server.main.build_server(config, device="cpu")``) driven through the
wire the way ``tests/test_server.py`` drives the JAX package's (status
codes, the index lifecycle, ``StreamSearch``, tombstones across a reload
and a restart, the streaming and ``pq_capacity`` tiers), bearer auth
through ``hmac``, and epochs that cross between the packages' servers in
both directions."""

import threading
import time

import grpc
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.server import (
    main as t_main,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.config import (
    ServerConfig,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.grpc_api import (
    AdminServiceClient,
    HealthClient,
    QueryServiceClient,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.main import (
    build_server,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto import (
    health_pb2,
    vdb_pb2,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)


def _config(path, **kw):
    base = dict(address="127.0.0.1:0", data_path=str(path),
                coalesce_window_ms=1.0, default_nlist=8, max_batch_size=16,
                warm_nprobes=(), prefetch_hot_interval_s=0.0)
    base.update(kw)
    return ServerConfig(**base)


def _connect(port):
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    grpc.channel_ready_future(channel).result(timeout=10)
    return channel


@pytest.fixture(scope="module")
def live_server(tmp_path_factory):
    config = _config(tmp_path_factory.mktemp("vdb-data"))
    server, engine, health, port = build_server(config, device="cpu")
    server.start()
    channel = _connect(port)
    yield {
        "channel": channel,
        "query": QueryServiceClient(channel),
        "admin": AdminServiceClient(channel),
        "health": HealthClient(channel),
        "engine": engine,
        "config": config,
    }
    channel.close()
    server.stop(grace=None)
    health.stop()
    engine.close()


def _vectors(rng, n, dim, id0=0):
    return [
        vdb_pb2.Vector(id=id0 + i,
                       values=rng.standard_normal(dim).astype(float))
        for i in range(n)
    ]


def _activate(admin, name, deadline_s=60):
    deadline = time.time() + deadline_s
    while True:
        try:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index=name))
            return
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.FAILED_PRECONDITION:
                raise
            assert time.time() < deadline, "build never finished"
            time.sleep(0.05)


def _build_and_activate(admin, name, source_path=""):
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index=name,
                                               source_path=source_path))
    _activate(admin, name)


def _code(fn, *a, **kw):
    with pytest.raises(grpc.RpcError) as e:
        fn(*a, **kw)
    return e.value.code()


def test_health_check(live_server):
    resp = live_server["health"].Check(health_pb2.HealthCheckRequest())
    assert resp.status == health_pb2.HealthCheckResponse.SERVING
    resp = live_server["health"].Check(
        health_pb2.HealthCheckRequest(service="nope"))
    assert resp.status == health_pb2.HealthCheckResponse.SERVICE_UNKNOWN


def test_full_lifecycle(live_server):
    rng = np.random.default_rng(0)
    admin, query = live_server["admin"], live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="docs", dimension=16, metric="L2", nlist=8))
    for b in range(3):
        resp = admin.AddVectors(vdb_pb2.AddVectorsRequest(
            index="docs", vectors=_vectors(rng, 200, 16, id0=b * 200)))
        assert resp.added == 200
    _build_and_activate(admin, "docs")
    stats = admin.GetStats(vdb_pb2.StatsRequest(index="docs"))
    assert stats.indexed_vectors == 600 and stats.current_epoch != ""
    assert stats.gpu_memory_used > 0
    st = live_server["engine"].get_state("docs")
    assert st.index.device.type == "cpu"
    probe = rng.standard_normal(16).astype(np.float32)
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=probe)], topk=5, nprobe=8,
        index="docs"))
    assert len(resp.results) == 1
    dists = [n.distance for n in resp.results[0].neighbors]
    assert len(dists) == 5 and dists == sorted(dists)
    d, ids = st.index.search(probe[None], _params(nprobe=8, k=5))
    assert [n.id for n in resp.results[0].neighbors] == ids[0].tolist()


def _params(**kw):
    from cuda_acceleratedvectordatabaseengine_tpu_torch import SearchParams

    return SearchParams(**kw)


def test_remove_vectors_rpc(live_server):
    rng = np.random.default_rng(3)
    admin, query = live_server["admin"], live_server["query"]
    total0 = live_server["engine"].get_state("docs").index.ntotal
    vec = rng.standard_normal(16).astype(np.float32)
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="docs", vectors=[vdb_pb2.Vector(id=99_999, values=vec)]))
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=vec)], topk=1, nprobe=8,
        index="docs"))
    assert resp.results[0].neighbors[0].id == 99_999
    out = admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[99_999]))
    assert (out.removed, out.total) == (1, total0)
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=vec)], topk=5, nprobe=8,
        index="docs"))
    assert all(n.id != 99_999 for n in resp.results[0].neighbors)
    assert admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[99_999])).removed == 0
    assert _code(admin.RemoveVectors, vdb_pb2.RemoveVectorsRequest(
        index="nope", ids=[1])) == grpc.StatusCode.NOT_FOUND
    assert _code(admin.RemoveVectors, vdb_pb2.RemoveVectorsRequest(
        index="docs")) == grpc.StatusCode.INVALID_ARGUMENT


def test_remove_vectors_durable_across_epoch_reload(live_server):
    """A deletion survives LoadIndex (the snapshot still holds the row;
    the tombstone log replays it); re-adding the id revokes the
    tombstone."""
    admin, query = live_server["admin"], live_server["query"]
    eng = live_server["engine"]
    st = eng.get_state("docs")
    victim = 42
    vec = st.index.state_arrays()["arena"][
        tuple(a[0] for a in np.nonzero(st.index.arena.ids == victim))]
    assert admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[victim])).removed == 1
    query.LoadIndex(vdb_pb2.LoadIndexRequest(index="docs"))
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=vec)], topk=10, nprobe=8,
        index="docs"))
    assert all(n.id != victim for n in resp.results[0].neighbors)
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="docs", vectors=[vdb_pb2.Vector(id=victim, values=vec)]))
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=vec)], topk=1, nprobe=8,
        index="docs"))
    assert resp.results[0].neighbors[0].id == victim
    assert not np.isin(victim, eng._read_tombstones("docs"))


def test_search_error_codes(live_server):
    query = live_server["query"]
    v = vdb_pb2.Vector(values=[0.0] * 16)
    bad = grpc.StatusCode.INVALID_ARGUMENT
    for kw, code in (
        (dict(topk=5, index="docs"), bad),
        (dict(queries=[v], topk=0, index="docs"), bad),
        (dict(queries=[v], topk=2000, index="docs"), bad),
        (dict(queries=[v], topk=5), bad),
        (dict(queries=[v], topk=5, index="ghost"),
         grpc.StatusCode.NOT_FOUND),
        (dict(queries=[vdb_pb2.Vector(values=[0.0] * 3)], topk=5,
              index="docs"), bad),
        (dict(queries=[v], topk=5, index="docs", metric="Cosine"), bad),
        (dict(queries=[v], topk=5, index="docs", metric="hamming"), bad),
        (dict(packed_queries=b"\0" * 12, topk=5, index="docs"), bad),
        (dict(packed_queries=b"\0" * (4 * 16 * 8193), topk=5,
              index="docs"), bad),
    ):
        assert _code(query.Search, vdb_pb2.SearchRequest(**kw)) == code, kw


def test_admin_error_codes(live_server):
    admin = live_server["admin"]
    bad = grpc.StatusCode.INVALID_ARGUMENT
    for req, code in (
        (vdb_pb2.CreateIndexRequest(name="", dimension=8), bad),
        (vdb_pb2.CreateIndexRequest(name="docs", dimension=16),
         grpc.StatusCode.ALREADY_EXISTS),
        (vdb_pb2.CreateIndexRequest(name="big", dimension=100_000), bad),
        (vdb_pb2.CreateIndexRequest(name="m", dimension=8,
                                    metric="hamming"), bad),
        (vdb_pb2.CreateIndexRequest(name="t", dimension=8, tier="nvme"),
         bad),
        (vdb_pb2.CreateIndexRequest(name="s", dimension=8, m=4,
                                    tier="streaming"), bad),
        (vdb_pb2.CreateIndexRequest(name="c", dimension=8,
                                    tier="pq_capacity"), bad),
    ):
        assert _code(admin.CreateIndex, req) == code, req
    nf = grpc.StatusCode.NOT_FOUND
    assert _code(admin.GetStats, vdb_pb2.StatsRequest(index="ghost")) == nf
    assert _code(admin.BuildEpoch,
                 vdb_pb2.BuildEpochRequest(index="ghost")) == nf
    assert _code(admin.ActivateEpoch,
                 vdb_pb2.ActivateEpochRequest(index="ghost")) == nf
    assert _code(admin.AddVectors, vdb_pb2.AddVectorsRequest(
        index="ghost", vectors=[vdb_pb2.Vector(values=[0.0] * 8)])) == nf
    assert _code(admin.AddVectors, vdb_pb2.AddVectorsRequest(
        index="docs", vectors=[vdb_pb2.Vector(values=[0.0] * 3)])) == bad
    assert _code(admin.AddVectors,
                 vdb_pb2.AddVectorsRequest(index="docs")) == bad


def test_concurrent_search(live_server):
    """4 threads × 5 requests, all succeed, and they were coalesced."""
    rng = np.random.default_rng(1)
    admin, query = live_server["admin"], live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="conc", dimension=16, nlist=8))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="conc", vectors=_vectors(rng, 300, 16)))
    _build_and_activate(admin, "conc")
    errors = []

    def worker(seed):
        wrng = np.random.default_rng(seed)
        for _ in range(5):
            try:
                resp = query.Search(vdb_pb2.SearchRequest(
                    queries=[vdb_pb2.Vector(
                        values=wrng.standard_normal(16).astype(float))],
                    topk=3, nprobe=8, index="conc"))
                assert len(resp.results) == 1
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:2]
    st = live_server["engine"].get_state("conc")
    assert st.coalescer.stats()["items"] >= 20
    assert live_server["engine"].limiter.active == 0


def test_warmup(live_server):
    live_server["query"].Warmup(vdb_pb2.WarmupRequest(
        index="docs", lists=[0, 1, 2]))
    assert _code(live_server["query"].Warmup, vdb_pb2.WarmupRequest(
        index="ghost")) == grpc.StatusCode.NOT_FOUND


def test_epoch_rebuild_and_swap(live_server):
    rng = np.random.default_rng(2)
    admin = live_server["admin"]
    engine = live_server["engine"]
    e1 = engine.get_state("docs").epoch
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="docs", vectors=_vectors(rng, 100, 16, id0=600)))
    _build_and_activate(admin, "docs")
    assert engine.get_state("docs").epoch != e1
    assert admin.GetStats(vdb_pb2.StatsRequest(
        index="docs")).indexed_vectors == 700


def test_load_index_previous_epoch(live_server):
    engine = live_server["engine"]
    epochs = engine.epochs.list_epochs("docs")["epochs"]
    assert len(epochs) >= 2
    older = sorted(epochs)[0]
    live_server["query"].LoadIndex(vdb_pb2.LoadIndexRequest(
        index="docs", epoch=older))
    assert engine.get_state("docs").epoch == older
    assert _code(live_server["query"].LoadIndex, vdb_pb2.LoadIndexRequest(
        index="docs", epoch="123")) == grpc.StatusCode.NOT_FOUND
    live_server["query"].LoadIndex(vdb_pb2.LoadIndexRequest(index="docs"))


def test_metrics_exposition(live_server):
    engine = live_server["engine"]
    text = engine.metrics.prometheus_text().decode()
    assert "vdb_searches_total" in text
    assert "vdb_search_duration_milliseconds" in text
    assert 'vdb_stage_milliseconds{stage="decode"' in text
    pct = engine.metrics.get_percentiles("docs")
    assert pct["count"] > 0 and pct["p99"] >= pct["p50"] >= 0


def test_stream_search_matches_unary(live_server):
    rng = np.random.default_rng(7)
    query = live_server["query"]
    reqs = []
    for i in range(12):
        q = rng.standard_normal(16).astype(np.float32)
        if i % 3 == 0:
            reqs.append(vdb_pb2.SearchRequest(
                index="docs", topk=5, nprobe=8, packed_queries=q.tobytes(),
                packed_response=True))
        else:
            reqs.append(vdb_pb2.SearchRequest(
                index="docs", topk=5, nprobe=8,
                queries=[vdb_pb2.Vector(values=q)]))
    streamed = list(query.StreamSearch(iter(reqs)))
    assert len(streamed) == len(reqs)
    for req, got in zip(reqs, streamed):
        want = query.Search(req)
        g_ids, g_d = _decode(req, got)
        w_ids, w_d = _decode(req, want)
        assert np.array_equal(g_ids, w_ids)
        np.testing.assert_allclose(g_d, w_d, rtol=1e-5, atol=1e-5)
    assert live_server["engine"].limiter.active == 0


def _decode(req, resp):
    """A response's (ids [B, ≤k], distances) as arrays."""
    if req.packed_response:
        return (np.frombuffer(resp.packed_ids, dtype="<u8"),
                np.frombuffer(resp.packed_distances, dtype="<f4"))
    ns = [n for r in resp.results for n in r.neighbors]
    return (np.array([n.id for n in ns], dtype=np.uint64),
            np.array([n.distance for n in ns], dtype=np.float32))


def test_stream_search_invalid_message_aborts_stream(live_server):
    rng = np.random.default_rng(8)
    good = vdb_pb2.SearchRequest(
        index="docs", topk=5, nprobe=8, queries=[vdb_pb2.Vector(
            values=rng.standard_normal(16).astype(np.float32))])
    bad = vdb_pb2.SearchRequest(index="docs", topk=0)
    assert _code(lambda: list(live_server["query"].StreamSearch(
        iter([good, good, bad, good])))) == grpc.StatusCode.INVALID_ARGUMENT
    assert live_server["engine"].limiter.active == 0


def test_packed_wire_round_trip(live_server):
    """64 packed queries in, packed ids and distances out, equal to the
    library search of the served index."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    resp = live_server["query"].Search(vdb_pb2.SearchRequest(
        index="docs", topk=7, nprobe=8, packed_queries=q.tobytes(),
        packed_response=True))
    ids = np.frombuffer(resp.packed_ids, "<u8").reshape(64, 7)
    d = np.frombuffer(resp.packed_distances, "<f4").reshape(64, 7)
    st = live_server["engine"].get_state("docs")
    assert_topk_match(d, ids, *st.index.search(q, _params(nprobe=8, k=7)),
                      rtol=1e-5, atol=1e-5 * (q * q).sum(1))


def test_engine_recovery_after_restart(live_server):
    """A new engine over the same data path recovers the active epoch and
    replays the tombstone log: an id removed over the wire after the
    epoch was built stays removed."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.service import (
        VdbEngine,
    )

    admin = live_server["admin"]
    st = live_server["engine"].get_state("docs")
    victim = int(st.index.arena.ids[0, 0])
    vec = st.index.state_arrays()["arena"][0, 0]
    assert admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[victim])).removed == 1
    engine2 = VdbEngine(live_server["config"], device="cpu")
    try:
        st2 = engine2.get_state("docs")
        assert st2.index is not None and st2.index.trained
        assert st2.epoch == engine2.epochs.active_epoch("docs")
        assert victim not in st2.index.arena.ids
        _, ids = st2.index.search(vec[None], _params(nprobe=8, k=5))
        assert victim not in ids
    finally:
        engine2.close()
        admin.AddVectors(vdb_pb2.AddVectorsRequest(
            index="docs", vectors=[vdb_pb2.Vector(id=victim, values=vec)]))


def test_pq_index_via_rpc(live_server):
    from cuda_acceleratedvectordatabaseengine_tpu_torch import IVFPQIndex

    rng = np.random.default_rng(5)
    admin, query = live_server["admin"], live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="pq", dimension=32, metric="L2", nlist=8, m=8, nbits=8))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(index="pq", vectors=[
        vdb_pb2.Vector(id=i, values=rng.standard_normal(32))
        for i in range(800)]))
    _build_and_activate(admin, "pq")
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=[0.0] * 32)], topk=5, nprobe=8,
        index="pq", rerank_exact=True))
    assert len(resp.results[0].neighbors) == 5
    assert isinstance(live_server["engine"].get_state("pq").index,
                      IVFPQIndex)


def test_build_from_arrow_source_via_rpc(live_server, tmp_path_factory):
    from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
        ArrowStorage,
    )

    rng = np.random.default_rng(6)
    src = str(tmp_path_factory.mktemp("src") / "v.arrow")
    ArrowStorage.write_vectors(
        src, np.arange(500, dtype=np.uint64) + 10_000,
        rng.standard_normal((500, 24)).astype(np.float32))
    admin = live_server["admin"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="arrowidx", dimension=24, nlist=4))
    _build_and_activate(admin, "arrowidx", source_path=src)
    resp = live_server["query"].Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=[0.0] * 24)], topk=3, nprobe=4,
        index="arrowidx"))
    assert all(n.id >= 10_000 for n in resp.results[0].neighbors)


def test_failed_build_reports_error(live_server):
    admin = live_server["admin"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(name="empty", dimension=8))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="empty"))
    deadline = time.time() + 30
    while True:
        with pytest.raises(grpc.RpcError) as e:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="empty"))
        if e.value.code() == grpc.StatusCode.INTERNAL:
            assert "no data" in e.value.details()
            break
        assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert time.time() < deadline
        time.sleep(0.05)
    assert admin.GetStats(vdb_pb2.StatsRequest(
        index="empty")).indexed_vectors == 0
    assert _code(live_server["query"].Search, vdb_pb2.SearchRequest(
        index="empty", topk=1, queries=[vdb_pb2.Vector(values=[0.0] * 8)])
    ) == grpc.StatusCode.FAILED_PRECONDITION


def test_search_priority_field_accepted(live_server):
    rng = np.random.default_rng(3)
    admin, query = live_server["admin"], live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="prio-idx", dimension=16, metric="L2", nlist=4))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="prio-idx", vectors=_vectors(rng, 128, 16)))
    _build_and_activate(admin, "prio-idx")
    for prio in (1, 4):
        resp = query.Search(vdb_pb2.SearchRequest(
            queries=[vdb_pb2.Vector(values=rng.standard_normal(16))],
            topk=4, nprobe=4, index="prio-idx", priority=prio))
        assert len(resp.results[0].neighbors) >= 1


def test_streaming_tier_lifecycle(live_server):
    from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
        StreamingIVFFlatIndex,
    )

    rng = np.random.default_rng(11)
    admin, query = live_server["admin"], live_server["query"]
    name = "stream-idx"
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name=name, dimension=16, metric="L2", nlist=8, tier="streaming"))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 400, 16)))
    _build_and_activate(admin, name)
    st = live_server["engine"].get_state(name)
    assert isinstance(st.index, StreamingIVFFlatIndex)
    query.Warmup(vdb_pb2.WarmupRequest(index=name, lists=[0, 1, 2]))
    assert {0, 1, 2} <= set(st.index.cache.resident_lists())
    v0 = st.index.store.vectors[0][0]
    id0 = int(st.index.store.ids[0][0])
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=v0.astype(float))], topk=3,
        nprobe=8, index=name))
    assert resp.results[0].neighbors[0].id == id0
    assert resp.results[0].neighbors[0].distance < 1e-3
    stats = admin.GetStats(vdb_pb2.StatsRequest(index=name))
    assert stats.indexed_vectors == 400 and stats.gpu_memory_used > 0
    assert _code(admin.RemoveVectors, vdb_pb2.RemoveVectorsRequest(
        index=name, ids=[id0])) == grpc.StatusCode.FAILED_PRECONDITION
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 50, 16, id0=1000)))
    assert sum(len(v) for v in st.pending_vectors) == 50
    _build_and_activate(admin, name)
    assert admin.GetStats(vdb_pb2.StatsRequest(
        index=name)).indexed_vectors == 50


def test_pq_capacity_tier_lifecycle(live_server):
    rng = np.random.default_rng(13)
    admin, query = live_server["admin"], live_server["query"]
    name = "cap-idx"
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name=name, dimension=16, metric="L2", nlist=8, m=4,
        tier="pq_capacity"))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 400, 16)))
    _build_and_activate(admin, name)
    st = live_server["engine"].get_state(name)
    rr = st.index._host_rr
    assert st.index.raw is None and rr is not None and st.index.read_only
    v0 = rr.vecs[0].astype(np.float32) * rr.scale[0] + rr.anchors[
        rr.anchor_row[0]]
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=v0.astype(float))], topk=3,
        nprobe=8, index=name, rerank_exact=True))
    assert resp.results[0].neighbors[0].id == int(rr.ids[0])
    assert resp.results[0].neighbors[0].distance < 0.05
    assert _code(admin.RemoveVectors, vdb_pb2.RemoveVectorsRequest(
        index=name, ids=[1])) == grpc.StatusCode.FAILED_PRECONDITION
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 50, 16, id0=1000)))
    _build_and_activate(admin, name)
    assert admin.GetStats(vdb_pb2.StatsRequest(
        index=name)).indexed_vectors == 50
    assert st.index._host_rr is not None


def test_unset_nprobe_uses_persisted_calibration(live_server):
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.service import (
        QueryServiceImpl,
    )

    engine = live_server["engine"]
    impl = QueryServiceImpl(engine)
    st = engine.get_state("docs")
    req = vdb_pb2.SearchRequest(index="docs", topk=3, queries=[
        vdb_pb2.Vector(values=np.zeros(16, np.float32))])

    class _Ctx:
        def abort(self, code, msg):
            raise AssertionError(f"abort {code}: {msg}")

    old = st.index.calibrated_nprobe
    try:
        st.index.calibrated_nprobe = 7
        assert impl._validate(req, _Ctx())[2].nprobe == 7
        st.index.calibrated_nprobe = None
        assert impl._validate(req, _Ctx())[2].nprobe == \
            live_server["config"].default_nprobe
        req.nprobe = 3
        assert impl._validate(req, _Ctx())[2].nprobe == 3
    finally:
        st.index.calibrated_nprobe = old


def test_stats_reset_isolates_percentile_windows(live_server):
    rng = np.random.default_rng(11)
    admin, query = live_server["admin"], live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="statsreset", dimension=16, metric="L2", nlist=8))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="statsreset", vectors=_vectors(rng, 200, 16)))
    _build_and_activate(admin, "statsreset")
    live_server["engine"].metrics.reset_windows("statsreset")
    query.Search(vdb_pb2.SearchRequest(
        queries=_vectors(rng, 1, 16), topk=5, nprobe=8, index="statsreset"))
    assert admin.GetStats(vdb_pb2.StatsRequest(
        index="statsreset")).latency_p50_ms > 0.0
    admin.GetStats(vdb_pb2.StatsRequest(index="statsreset", reset=True))
    assert admin.GetStats(vdb_pb2.StatsRequest(
        index="statsreset")).latency_p50_ms == 0.0
    assert live_server["engine"].metrics.get_stage_percentiles() == {}


# --------------------------------------------------------------------------- #
# admission over the wire, auth, the command line
# --------------------------------------------------------------------------- #

def test_admission_status_codes(tmp_path):
    """Rate limit and concurrency cap answer RESOURCE_EXHAUSTED, an open
    breaker UNAVAILABLE; client errors never trip the breaker."""
    config = _config(tmp_path / "data", rate_limit_burst=3,
                     rate_limit_rps=1e-6)
    server, engine, health, port = build_server(config, device="cpu")
    server.start()
    channel = _connect(port)
    try:
        admin, query = AdminServiceClient(channel), QueryServiceClient(
            channel)
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="a", dimension=8, nlist=4))
        admin.AddVectors(vdb_pb2.AddVectorsRequest(
            index="a", vectors=_vectors(np.random.default_rng(0), 64, 8)))
        _build_and_activate(admin, "a")
        req = vdb_pb2.SearchRequest(index="a", topk=2, nprobe=4,
                                    queries=[vdb_pb2.Vector(values=[0] * 8)])
        for _ in range(5):
            assert _code(query.Search, vdb_pb2.SearchRequest(
                index="a", topk=0)) == grpc.StatusCode.INVALID_ARGUMENT
        for _ in range(3):
            query.Search(req)                       # the burst
        assert _code(query.Search, req) == \
            grpc.StatusCode.RESOURCE_EXHAUSTED
        engine.rate_limiter.set_rate(1e6, burst=1000)
        engine.limiter = type(engine.limiter)(0)
        assert _code(query.Search, req) == \
            grpc.StatusCode.RESOURCE_EXHAUSTED
        engine.limiter = type(engine.limiter)(8)
        for _ in range(20):
            engine.breaker.record(False)
        assert _code(query.Search, req) == grpc.StatusCode.UNAVAILABLE
    finally:
        channel.close()
        server.stop(grace=None)
        health.stop()
        engine.close()


def test_auth_token_compared_in_constant_time(tmp_path, monkeypatch):
    """Every vdb.* RPC needs ``authorization: Bearer <token>``, checked
    with ``hmac.compare_digest``; health stays open."""
    calls = []
    real = t_main.hmac.compare_digest
    monkeypatch.setattr(t_main.hmac, "compare_digest",
                        lambda a, b: calls.append((a, b)) or real(a, b))
    config = _config(tmp_path / "data", auth_token="sekrit-42")
    server, engine, health, port = build_server(config, device="cpu")
    server.start()
    channel = _connect(port)
    try:
        admin = AdminServiceClient(channel)
        query = QueryServiceClient(channel)
        un = grpc.StatusCode.UNAUTHENTICATED
        assert _code(admin.GetStats, vdb_pb2.StatsRequest()) == un
        assert _code(admin.GetStats, vdb_pb2.StatsRequest(), metadata=(
            ("authorization", "Bearer nope"),)) == un
        assert _code(lambda: list(query.StreamSearch(iter(
            [vdb_pb2.SearchRequest()])))) == un
        assert _code(admin.GetStats, vdb_pb2.StatsRequest(), metadata=(
            ("authorization", "Bearer sekrit-42"),)) == \
            grpc.StatusCode.NOT_FOUND
        hc = HealthClient(channel).Check(health_pb2.HealthCheckRequest())
        assert hc.status == health_pb2.HealthCheckResponse.SERVING
        assert (b"Bearer sekrit-42", b"Bearer sekrit-42") in [
            (b, a) for a, b in calls]
        assert len(calls) >= 4
    finally:
        channel.close()
        server.stop(grace=None)
        health.stop()
        engine.close()


def test_main_refuses_unported_options(tmp_path, monkeypatch):
    # --profile-port is ported (tests/test_torch_profiling.py serves a
    # trace through it); a taken port fails before the engine loads
    import socket

    with socket.socket() as taken:
        taken.bind(("", 0))
        taken.listen()
        with pytest.raises(OSError):
            t_main.main(["--profile-port", str(taken.getsockname()[1]),
                         "--data-path", str(tmp_path / "d"),
                         "--device", "cpu"])
    # --shard-serving on is ported (parallel/): the engine that main
    # builds serves over a one-shard mesh
    # (tests/test_torch_server_sharded.py)
    seen = {}

    class Built(Exception):
        pass

    def build(config, device=None, mesh=None):
        engine = t_main.VdbEngine(config, device=device, mesh=mesh)
        seen["mesh"] = engine.mesh
        engine.close()
        raise Built

    monkeypatch.setattr(t_main, "build_server", build)
    with pytest.raises(Built):
        t_main.main(["--shard-serving", "on", "--data-path",
                     str(tmp_path / "d"), "--device", "cpu"])
    assert seen["mesh"].devices.size == 1
    assert t_main.device_banner("cpu") == "[vdb] device: cpu"


# --------------------------------------------------------------------------- #
# epochs across the packages
# --------------------------------------------------------------------------- #

DIM_X = 16


def _jax_server(config_kw):
    from cuda_acceleratedvectordatabaseengine_tpu.server.config import (
        ServerConfig as JConfig,
    )
    from cuda_acceleratedvectordatabaseengine_tpu.server.main import (
        build_server as j_build_server,
    )

    return j_build_server(JConfig(shard_serving="off", **config_kw))


def _port_server(config_kw):
    return build_server(ServerConfig(**config_kw), device="cpu")


def _wire_round(port, queries, removed):
    """The requests both servers answer: unpacked and packed, the
    resident index and the reranked capacity tier."""
    channel = _connect(port)
    query = QueryServiceClient(channel)
    out = []
    try:
        for name, rr in (("flat", False), ("cap", True)):
            for packed in (False, True):
                req = vdb_pb2.SearchRequest(
                    index=name, topk=10, nprobe=4, rerank_exact=rr,
                    packed_response=packed)
                if packed:
                    req.packed_queries = queries.tobytes()
                else:
                    req.queries.extend(vdb_pb2.Vector(values=q)
                                       for q in queries)
                ids, d = _decode(req, query.Search(req))
                out.append((ids.reshape(len(queries), -1),
                            d.reshape(len(queries), -1)))
        for ids, _ in out[:2]:
            assert not np.isin(ids, removed).any()
    finally:
        channel.close()
    return out


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_epochs_cross_between_the_packages(tmp_path, monkeypatch, builder):
    """One package's server builds and activates epochs (a resident
    IVF-Flat index and a ``pq_capacity`` one) from a vectors file and
    removes ids; the other package's server recovers the same data path
    (epochs.json, the snapshots, the tombstone log) and answers the same
    Search requests with the same ids (up to ties) and distances within
    1e-6 relative (+ 1e-6·‖q‖²)."""
    from cuda_acceleratedvectordatabaseengine_tpu.io_host import host_rerank
    from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
        VectorFileWriter,
    )

    # the JAX package's numpy rerank path (its C++ one sums in another
    # order), as the host-rerank parity tests hold it
    monkeypatch.setattr(host_rerank.HostReranker, "_rerank_native",
                        lambda self, *a, **k: None)
    rng = np.random.default_rng(21)
    centers = 3.0 * rng.standard_normal((8, DIM_X)).astype(np.float32)
    x = (centers[rng.integers(0, 8, 1200)]
         + rng.standard_normal((1200, DIM_X))).astype(np.float32)
    ids = np.arange(1200, dtype=np.uint64) * 11 + 3
    src = str(tmp_path / "src.arrow")
    with VectorFileWriter(src) as w:
        w.append(ids, x)
    kw = dict(address="127.0.0.1:0", data_path=str(tmp_path / "data"),
              default_nlist=8, default_nprobe=4, warm_nprobes=(),
              max_batch_size=8, coalesce_window_ms=1.0,
              prefetch_hot_interval_s=0.0, pq_rerank_k=40,
              # fp32 rows: the JAX package's CPU scan of a bf16 arena
              # rounds the query to bf16, off the fp32 answer by ~1e-2
              arena_dtype="float32")
    first, second = ((_jax_server, _port_server) if builder == "jax"
                     else (_port_server, _jax_server))
    queries = x[:12] + 0.2 * rng.standard_normal((12, DIM_X)).astype(
        np.float32)
    removed = ids[::7][:40]

    server, engine, health, port = first(kw)
    server.start()
    channel = _connect(port)
    try:
        admin = AdminServiceClient(channel)
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="flat", dimension=DIM_X, metric="L2", nlist=8))
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="cap", dimension=DIM_X, metric="L2", nlist=8, m=4,
            tier="pq_capacity"))
        for name in ("flat", "cap"):
            _build_and_activate(admin, name, source_path=src)
        admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
            index="flat", ids=removed.tolist()))
        want = _wire_round(port, queries, removed)
    finally:
        channel.close()
        server.stop(grace=None)
        health.stop()
        engine.close()

    server, engine, health, port = second(kw)
    server.start()
    try:
        for name in ("flat", "cap"):
            assert engine.get_state(name).index is not None
        got = _wire_round(port, queries, removed)
    finally:
        server.stop(grace=None)
        health.stop()
        engine.close()
    atol = 1e-6 * (queries.astype(np.float64) ** 2).sum(1)
    for (g_ids, g_d), (w_ids, w_d) in zip(got, want):
        assert g_ids.shape == (12, 10)
        assert_topk_match(g_d, g_ids, w_d, w_ids, rtol=1e-6, atol=atol)
