"""PyTorch port, sharded serving on the CPU: the counterparts of
``tests/test_server_sharded.py``. The engine builds its mesh from
``shard_serving`` / ``mesh_shards`` (8 CPU shards here) or takes one
(``VdbEngine(mesh=...)``); epoch activation serves resident IVF-Flat and
IVF-PQ through the sharded views and streaming tiers on the mesh; the wire
answers equal a single-device server's on the same data."""

import time

import grpc
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel import (
    ShardedIVFFlatIndex,
    ShardedIVFPQIndex,
    ShardedStreamingIVFFlatIndex,
    make_mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.config import (
    ServerConfig,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.grpc_api import (
    AdminServiceClient,
    QueryServiceClient,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.main import (
    build_server,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto import (
    vdb_pb2,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.service import (
    VdbEngine,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

DIM = 16
SHARDS = 8


def _config(path, **kw):
    base = dict(address="127.0.0.1:0", data_path=str(path),
                coalesce_window_ms=1.0, default_nlist=8, max_batch_size=16,
                warm_nprobes=(), prefetch_hot_interval_s=0.0)
    base.update(kw)
    return ServerConfig(**base)


def _start(config, mesh=None):
    server, engine, health, port = build_server(config, device="cpu",
                                                mesh=mesh)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    grpc.channel_ready_future(channel).result(timeout=10)
    return {"server": server, "engine": engine, "health": health,
            "channel": channel, "admin": AdminServiceClient(channel),
            "query": QueryServiceClient(channel)}


def _stop(h):
    h["channel"].close()
    h["server"].stop(grace=None)
    h["health"].stop()
    h["engine"].close()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    h = _start(_config(tmp_path_factory.mktemp("vdb-sharded"),
                       shard_serving="on", mesh_shards=SHARDS))
    yield h
    _stop(h)


def _build_and_activate(admin, name, deadline_s=60):
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index=name))
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


def _search(query, name, qs, k=5, nprobe=8, rerank=False):
    resp = query.Search(vdb_pb2.SearchRequest(
        index=name, topk=k, nprobe=nprobe,
        packed_queries=np.ascontiguousarray(qs, "<f4").tobytes(),
        packed_response=True, rerank_exact=rerank,
    ), timeout=30)
    ids = np.frombuffer(resp.packed_ids, "<u8").reshape(len(qs), k)
    d = np.frombuffer(resp.packed_distances, "<f4").reshape(len(qs), k)
    return d, ids


def _ingest(admin, name, x, id0=0, **create):
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name=name, dimension=DIM, metric="L2", nlist=8, **create))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=[vdb_pb2.Vector(id=id0 + i, values=x[i])
                             for i in range(len(x))]))


def test_engine_mesh_modes(tmp_path):
    """auto shards only over more than one device, on builds a one-shard
    mesh, mesh_shards gives that many CPU shards, off never shards, an
    explicit mesh wins, an unknown mode is refused; on CUDA a mesh larger
    than the card count raises."""
    def mesh_of(sub, mesh=None, **kw):
        eng = VdbEngine(_config(tmp_path / sub, **kw), device="cpu",
                        mesh=mesh)
        try:
            return eng.mesh
        finally:
            eng.close()

    assert mesh_of("a", shard_serving="auto") is None
    assert mesh_of("b", shard_serving="on").devices.size == 1
    assert mesh_of("c", shard_serving="auto",
                   mesh_shards=4).devices.size == 4
    assert mesh_of("d", shard_serving="off", mesh_shards=4) is None
    explicit = make_mesh(devices=["cpu"] * 3)
    assert mesh_of("e", mesh=explicit, shard_serving="off") is explicit
    with pytest.raises(ValueError):
        VdbEngine(_config(tmp_path / "f", shard_serving="sideways"),
                  device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested"):
            VdbEngine(_config(tmp_path / "g", shard_serving="on",
                              mesh_shards=torch.cuda.device_count() + 1))


def test_enable_multi_gpu_yaml_alias(tmp_path):
    """The reference's enable_multi_gpu bool maps onto shard_serving; an
    explicit shard_serving key wins; on maps to a one-shard mesh."""
    p = tmp_path / "c.yaml"
    p.write_text("server:\n  enable_multi_gpu: false\n")
    assert ServerConfig.from_yaml(str(p)).shard_serving == "off"
    p.write_text("server:\n  enable_multi_gpu: true\n")
    assert ServerConfig.from_yaml(str(p)).shard_serving == "auto"
    p.write_text("server:\n  enable_multi_gpu: true\n"
                 "  shard_serving: \"on\"\n")
    cfg = ServerConfig.from_yaml(str(p))
    assert cfg.shard_serving == "on"
    eng = VdbEngine(cfg.apply_overrides(data_path=str(tmp_path / "d"),
                                        prefetch_hot_interval_s=0.0),
                    device="cpu")
    try:
        assert eng.mesh.devices.size == 1
    finally:
        eng.close()


def test_sharded_lifecycle_flat(sharded):
    """create → ingest → build → activate: the live index is the sharded
    view over the whole mesh and every vector finds itself."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((600, DIM)).astype(np.float32)
    _ingest(sharded["admin"], "docs", x)
    _build_and_activate(sharded["admin"], "docs")
    st = sharded["engine"].get_state("docs")
    assert isinstance(st.index, ShardedIVFFlatIndex)
    assert st.index.n_shards == SHARDS and st.index.ntotal == 600
    d, ids = _search(sharded["query"], "docs", x[:8])
    assert (ids[:, 0] == np.arange(8)).all()
    assert (d[:, 0] <= d[:, 1]).all()
    stats = sharded["admin"].GetStats(vdb_pb2.StatsRequest(index="docs"))
    assert stats.indexed_vectors == 600 and stats.gpu_memory_used > 0


def test_wire_parity_sharded_vs_single(sharded, tmp_path):
    """The same corpus and deterministic build on a single-device server:
    the wire answers equal the sharded server's (tie-aware, fp32
    tolerance of ‖q‖²)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, DIM)).astype(np.float32)
    qs = x[:16] + 0.1 * rng.standard_normal((16, DIM)).astype(np.float32)

    def drive(h):
        _ingest(h["admin"], "parity", x)
        _build_and_activate(h["admin"], "parity")
        return _search(h["query"], "parity", qs, k=10, nprobe=4)

    got = drive(sharded)
    single = _start(_config(tmp_path / "single", shard_serving="off"))
    try:
        ref = drive(single)
        assert single["engine"].mesh is None
    finally:
        _stop(single)
    assert_topk_match(*got, *ref, rtol=1e-5,
                      atol=1e-5 * (qs * qs).sum(1))


def test_sharded_mutations_over_wire(sharded):
    """AddVectors / RemoveVectors on the live sharded index: the view
    delegates to its base and re-publishes the stripes."""
    rng = np.random.default_rng(3)
    admin, query = sharded["admin"], sharded["query"]
    new = (4 * rng.standard_normal((4, DIM))).astype(np.float32)
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="docs", vectors=[vdb_pb2.Vector(id=70_000 + i, values=new[i])
                               for i in range(4)]))
    _, ids = _search(query, "docs", new, k=3)
    assert (ids[:, 0] == np.arange(70_000, 70_004)).all()
    resp = admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[70_000, 70_001]))
    assert resp.removed == 2
    _, ids = _search(query, "docs", new, k=3)
    assert not set(ids.ravel().tolist()) & {70_000, 70_001}
    assert ids[2, 0] == 70_002 and ids[3, 0] == 70_003


def test_sharded_tombstone_replay_on_reload(sharded):
    """An epoch reload replays the deletion log on the base before the
    stripes publish: a deleted id does not come back."""
    engine = sharded["engine"]
    st = engine.get_state("docs")
    engine._load_epoch_into(st, st.epoch)
    assert isinstance(st.index, ShardedIVFFlatIndex)
    _, ids = _search(sharded["query"], "docs",
                     np.zeros((1, DIM), np.float32), k=10)
    assert not set(ids.ravel().tolist()) & {70_000, 70_001}


def test_sharded_pq_lifecycle(sharded):
    """An IVF-PQ epoch activates into the sharded ADC view; the exact
    rerank over the striped raw rows finds every vector; removal works."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((400, DIM)).astype(np.float32)
    _ingest(sharded["admin"], "pq", x, m=4)
    _build_and_activate(sharded["admin"], "pq")
    st = sharded["engine"].get_state("pq")
    assert isinstance(st.index, ShardedIVFPQIndex)
    _, ids = _search(sharded["query"], "pq", x[:8], rerank=True)
    assert (ids[:, 0] == np.arange(8)).all()
    sharded["admin"].RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="pq", ids=[0, 1]))
    _, ids = _search(sharded["query"], "pq", x[:2], rerank=True)
    assert not set(ids.ravel().tolist()) & {0, 1}


def test_sharded_streaming_tier(sharded):
    """tier=streaming on a mesh activates the slot-striped cache and
    serves; the tier is read-only (removal is refused on the wire)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((400, DIM)).astype(np.float32)
    _ingest(sharded["admin"], "stream", x, tier="streaming")
    _build_and_activate(sharded["admin"], "stream")
    st = sharded["engine"].get_state("stream")
    assert isinstance(st.index, ShardedStreamingIVFFlatIndex)
    assert st.index.n_shards == SHARDS
    _, ids = _search(sharded["query"], "stream", x[:8])
    assert (ids[:, 0] == np.arange(8)).all()
    with pytest.raises(grpc.RpcError) as e:
        sharded["admin"].RemoveVectors(vdb_pb2.RemoveVectorsRequest(
            index="stream", ids=[0]))
    assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION


def test_explicit_mesh_and_pq_capacity_stays_single_device(tmp_path):
    """An engine given an explicit mesh serves flat through the sharded
    view, while the pq_capacity tier (its rerank on the host) stays on
    one device, as in the JAX package."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((400, DIM)).astype(np.float32)
    h = _start(_config(tmp_path, shard_serving="off"),
               mesh=make_mesh(devices=["cpu"] * 4))
    try:
        _ingest(h["admin"], "flat", x)
        _build_and_activate(h["admin"], "flat")
        _ingest(h["admin"], "pqcap", x, m=4, tier="pq_capacity")
        _build_and_activate(h["admin"], "pqcap")
        eng = h["engine"]
        assert isinstance(eng.get_state("flat").index, ShardedIVFFlatIndex)
        assert eng.get_state("flat").index.n_shards == 4
        pqcap = eng.get_state("pqcap").index
        assert not isinstance(pqcap, ShardedIVFPQIndex) and pqcap.read_only
        for name in ("flat", "pqcap"):
            _, ids = _search(h["query"], name, x[:6], rerank=True)
            assert (ids[:, 0] == np.arange(6)).all()
    finally:
        _stop(h)


def test_memory_gauge_counts_a_one_shard_view_once(tmp_path):
    """shard_serving: on serves through one-shard views, which publish
    the base arenas with no copy: the device-memory gauge reads the
    bases' bytes once, not twice."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((400, DIM)).astype(np.float32)
    h = _start(_config(tmp_path, shard_serving="on"))
    try:
        _ingest(h["admin"], "flat", x)
        _build_and_activate(h["admin"], "flat")
        _ingest(h["admin"], "pq", x, m=4)
        _build_and_activate(h["admin"], "pq")
        eng = h["engine"]
        views = [eng.get_state(name).index for name in ("flat", "pq")]
        assert [v.n_shards for v in views] == [1, 1]
        assert [v.memory_stats()["striped_bytes"] for v in views] == [0, 0]
        bases = sum(v.base.memory_stats()["total_bytes"] for v in views)
        eng._update_memory_gauge()
        gauge = eng.metrics.g_device_mem.render()[-1].split()[-1]
        assert float(gauge) == bases > 0
    finally:
        _stop(h)
