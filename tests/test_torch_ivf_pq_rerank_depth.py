"""PyTorch port, the IVF-PQ index's exact-rerank depth (``rerank_k``, the
upstream ``IVFPQIndex``'s name): the index against a plain IVF-PQ
reference (``vdb_bench/reference/ivf_pq.py``) at depth 0 (the default
``min(4k, 256)``), 64 and more than the probed slots; the default depth bit
for bit as before; the depth through save / load, the engine's
``create_index`` and the sharded view; the rerank's stage, row count and
profiler ranges; and the bulk build in slices (CPU)."""

import functools
import json
import time

import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models import ivf_pq
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    _ivf_pq_search_device,
    rerank_depth,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel import (
    ShardedIVFPQIndex,
    make_mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server import (
    config as t_config,
    service as t_service,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)
from vdb_bench.reference import ivf_pq as ref_pq

torch.set_num_threads(1)

N, DIM, NLIST, M, NPROBE, K = 3000, 32, 8, 8, 3, 10
# a depth past the probed slots of any search (the corpus has N rows)
DEEP = 5000


@functools.lru_cache(maxsize=None)
def _data():
    """Clustered corpus (12 modes) and held-out queries near it."""
    rng = np.random.default_rng(21)
    centers = 2.0 * rng.standard_normal((12, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, 12, N)]
         + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (x[rng.integers(0, N, 20)]
         + 0.3 * rng.standard_normal((20, DIM))).astype(np.float32)
    return x, q


def _config(rerank_k=0, raw_dtype="bfloat16", scan_impl="auto"):
    return IVFPQConfig(dimension=DIM, nlist=NLIST, m=M, raw_dtype=raw_dtype,
                       pq_train_sample=2048, train_iters=10,
                       rerank_k=rerank_k, scan_impl=scan_impl)


@functools.lru_cache(maxsize=None)
def _index(rerank_k=0, raw_dtype="bfloat16", scan_impl="auto"):
    x, _ = _data()
    idx = IVFPQIndex(_config(rerank_k, raw_dtype, scan_impl), device="cpu")
    idx.train(x)
    idx.add(x)
    return idx


def _probed_slots(idx, q, nprobe=NPROBE):
    """Occupied slots of each query's probed lists."""
    from vdb_bench.reference.exact import coarse_probe

    probes = coarse_probe(torch.from_numpy(q), idx.centroids, nprobe)
    return idx.counts.long()[probes].sum(1).numpy()


def _reference(idx, q, depth, k=K, nprobe=NPROBE):
    raw = idx.raw
    d, pos, short = ref_pq.search(
        torch.from_numpy(q), idx.centroids, idx.codebooks,
        idx.code_arena.contiguous(), idx.counts, raw.arena, nprobe, depth, k)
    ids = idx.ids.reshape(-1)[pos.clamp_min(0).numpy()]
    ids[pos.numpy() < 0] = INVALID_ID
    return d.numpy(), ids, short.numpy()


@pytest.mark.parametrize("scan_impl", ["gather", "grouped"])
@pytest.mark.parametrize("raw_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rerank_k", [0, 64, DEEP],
                         ids=["default", "64", "past-the-probed-slots"])
def test_index_matches_the_plain_reference(rerank_k, raw_dtype, scan_impl):
    idx = _index(rerank_k, raw_dtype, scan_impl)
    _, q = _data()
    fin = idx.search_async(q, SearchParams(nprobe=NPROBE, k=K,
                                           use_exact_rerank=True))
    d, ids = fin()
    depth = rerank_k or min(4 * K, 256)
    d_r, ids_r, short = _reference(idx, q, depth)
    # The index sums |q|² − 2 q·x + |x|² in fp32 (its ADC through tables,
    # its rerank with the stored norm); the reference sums squared
    # differences. Each is a few ulps of |q|² + |x|²: 1e-5 of it bounds
    # both, and an id may only trade places with one as near.
    scale = (q * q).sum(1) + float(idx.raw.arena_sq.max())
    assert_topk_match(d, ids, d_r, ids_r, rtol=1e-5, atol=1e-5 * scale)
    # the rows the rerank read: the depth, or every probed slot where fewer
    want = np.minimum(depth, _probed_slots(idx, q))
    assert (short == want).all()
    assert fin.counts["rerank_rows"] == pytest.approx(want.mean())
    if rerank_k == DEEP:
        assert (want < DEEP).all()


@pytest.mark.parametrize("scan_impl", ["gather", "grouped"])
@pytest.mark.parametrize("k", [1, 10, 70])
def test_depth_zero_is_the_default_depth_bit_for_bit(k, scan_impl):
    """An index without ``rerank_k`` reranks ``min(max(4k, k), 256)``
    candidates, the depth the search had before the option, and answers
    exactly as the device search at that depth does."""
    idx = _index(0, "bfloat16", scan_impl)
    _, q = _data()
    d, ids = idx.search(q, SearchParams(nprobe=NPROBE, k=k,
                                        use_exact_rerank=True))
    raw = idx.raw
    d_o, pos_o = _ivf_pq_search_device(
        torch.from_numpy(q), idx.centroids, idx.codebooks, idx.code_arena_t,
        idx.code_sq, idx.counts, raw.arena, raw.arena_sq, raw.arena_scale,
        raw.anchors, NPROBE, k, idx.metric, min(max(4 * k, k), 256),
        scan_impl, scan_capacity=idx._scan_capacity_hint())
    pos_o = pos_o.numpy()
    ids_o = idx.ids.reshape(-1)[np.clip(pos_o, 0, None)]
    ids_o[pos_o < 0] = INVALID_ID
    np.testing.assert_array_equal(ids, ids_o)
    np.testing.assert_array_equal(d[pos_o >= 0], d_o.numpy()[pos_o >= 0])


def test_rerank_depth_rule():
    assert rerank_depth(0, 10, 10_000) == 40
    assert rerank_depth(0, 100, 10_000) == 256
    # past k 64 the default stays at 256 (the search keeps k at least)
    assert rerank_depth(0, 300, 10_000) == 256
    assert rerank_depth(2048, 10, 10_000) == 2048
    assert rerank_depth(5, 10, 10_000) == 10
    assert rerank_depth(2048, 10, 1_000) == 1_000
    with pytest.raises(ValueError, match="rerank_k"):
        _config(rerank_k=-1)


def test_a_deep_rerank_in_query_chunks_answers_as_one(monkeypatch):
    """The rerank's gathered rows go through in query chunks past
    ``_RERANK_ROWS_BYTES``: the same answers, bit for bit."""
    idx = _index(512)
    _, q = _data()
    p = SearchParams(nprobe=NPROBE, k=K, use_exact_rerank=True)
    whole = idx.search(q, p)
    # 512 rows × 32 dims × 4 bytes a query: three queries a chunk
    monkeypatch.setattr(ivf_pq, "_RERANK_ROWS_BYTES", 3 * 512 * DIM * 4)
    chunked = idx.search(q, p)
    np.testing.assert_array_equal(whole[1], chunked[1])
    np.testing.assert_array_equal(whole[0], chunked[0])


def test_rerank_k_survives_save_and_load(tmp_path):
    idx = _index(64)
    idx.save(str(tmp_path / "r64"))
    back = IVFPQIndex.load(str(tmp_path / "r64"), device="cpu")
    assert back.config.rerank_k == 64
    _, q = _data()
    p = SearchParams(nprobe=NPROBE, k=K, use_exact_rerank=True)
    for a, b in zip(idx.search(q, p), back.search(q, p)):
        np.testing.assert_array_equal(a, b)
    # without the option a snapshot records no depth and loads the default
    _index(0).save(str(tmp_path / "r0"))
    with open(tmp_path / "r0" / "manifest.json") as f:
        assert "rerank_k" not in json.load(f)["extra"]
    assert IVFPQIndex.load(str(tmp_path / "r0"),
                           device="cpu").config.rerank_k == 0


def _engine(tmp_path, **kw):
    base = dict(data_path=str(tmp_path / "data"), default_nlist=NLIST,
                default_nprobe=NPROBE, warm_nprobes=(), max_batch_size=64,
                coalesce_window_ms=1.0, prefetch_hot_interval_s=0.0)
    base.update(kw)
    return t_service.VdbEngine(t_config.ServerConfig(**base), device="cpu")


def test_create_index_carries_rerank_k(tmp_path):
    eng = _engine(tmp_path)
    try:
        eng.create_index("deep", DIM, "L2", NLIST, M, 8, rerank_k=128)
        eng.create_index("plain", DIM, "L2", NLIST, M, 8)
        assert eng.get_state("deep").config["rerank_k"] == 128
        assert "rerank_k" not in eng.get_state("plain").config
        assert eng._new_index(
            eng.get_state("deep").config).config.rerank_k == 128
        assert eng._new_index(
            eng.get_state("plain").config).config.rerank_k == 0
        with pytest.raises(ValueError, match="rerank_k"):
            eng.create_index("flat", DIM, "L2", NLIST, 0, 0, rerank_k=64)
        with pytest.raises(ValueError, match="rerank_k"):
            eng.create_index("neg", DIM, "L2", NLIST, M, 8, rerank_k=-1)
    finally:
        eng.close()
    # the creation parameters come back with the engine
    again = _engine(tmp_path)
    try:
        assert again.get_state("deep").config["rerank_k"] == 128
    finally:
        again.close()


def test_the_engine_records_the_rerank_stage_and_rows(tmp_path):
    """A reranked search through the coalescer records ``fetch_wait``, its
    enqueue's host ms (``enqueue``), ``rerank`` (device ms; 0.0 on the
    CPU) and ``rerank_rows`` (the shortlist's candidates a query) once a
    search; the metrics page exports the count apart from the
    milliseconds."""
    idx = _index(64)
    _, q = _data()
    eng = _engine(tmp_path)
    try:
        eng.create_index("pq", DIM, "L2", NLIST, M, 8, rerank_k=64)
        st = eng.get_state("pq")
        with eng.lock:
            st.index = idx
            st.coalescer = eng._make_coalescer(st)
        p = SearchParams(nprobe=NPROBE, k=K, use_exact_rerank=True)
        batches = (q[:8], q[8:])
        for rows in batches:
            t0 = time.monotonic()
            fut = eng.submit_search(st, rows, p)
            got = eng.finish_search(fut, "pq", t0, rows.shape[0])
            assert_topk_match(*got, *idx.search(rows, p))
        stages = eng.metrics.get_stage_percentiles()
        searches = stages["fetch"]["count"]
        assert stages["enqueue"]["count"] == searches
        assert stages["rerank"]["count"] == searches
        assert stages["rerank"]["max"] == 0.0
        assert stages["rerank_rows"]["count"] == searches
        # one sample a search: its mean over the search's queries
        want = np.mean([np.minimum(64, _probed_slots(idx, b)).mean()
                        for b in batches])
        assert stages["rerank_rows"]["mean"] == pytest.approx(want)
        text = eng.metrics.prometheus_text().decode()
        assert 'vdb_stage_count{stage="rerank_rows",stat="mean"}' in text
        assert 'vdb_stage_milliseconds{stage="rerank",stat="p50"}' in text
        assert 'vdb_stage_milliseconds{stage="rerank_rows"' not in text
        # an ADC-only search reports no rerank
        eng.metrics.reset_windows()
        t0 = time.monotonic()
        fut = eng.submit_search(st, q[:4], SearchParams(nprobe=NPROBE, k=K))
        eng.finish_search(fut, "pq", t0, 4)
        stages = eng.metrics.get_stage_percentiles()
        assert "fetch_wait" in stages
        assert "rerank" not in stages and "rerank_rows" not in stages
    finally:
        with eng.lock:
            st.index = None
        eng.close()


def test_a_deep_search_opens_the_select_and_rerank_ranges():
    idx = _index(256, "bfloat16", "grouped")
    _, q = _data()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        idx.search(q[:4], SearchParams(nprobe=NPROBE, k=K,
                                       use_exact_rerank=True))
    names = {e.name for e in prof.events()}
    assert {"ivf_pq.upload", "ivf_pq.coarse_probe", "grouped_pq_scan.rows",
            "grouped_pq_scan.select", "ivf_pq.rerank", "ivf_pq.finalize",
            "ivf_pq.copy", "ivf_pq.id_map"} <= names
    assert "grouped_pq_scan.epilogue" not in names


def test_the_sharded_view_reads_the_depth():
    """The sharded view reranks each shard's own ``rerank_k`` shortlist:
    at a depth past every probed slot each shard reranks all of its
    slots, so the answer is the exact one over the probed lists."""
    idx = _index(DEEP)
    _, q = _data()
    p = SearchParams(nprobe=NPROBE, k=K, use_exact_rerank=True)
    view = ShardedIVFPQIndex(idx, make_mesh(devices=["cpu"] * 2))
    d, ids = view.search(q, p)
    d_r, ids_r, _ = _reference(idx, q, DEEP)
    scale = (q * q).sum(1) + float(idx.raw.arena_sq.max())
    assert_topk_match(d, ids, d_r, ids_r, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("slice_rows", [700, 1 << 20])
def test_a_bulk_build_places_rows_as_the_flat_bulk_build(monkeypatch,
                                                         slice_rows):
    """``build_from_device`` clamps the lists near the p99 list size (at
    least 1.5× the mean) and places a row past a full list in its next
    nearest, as ``IVFFlatIndex.build_from_device`` does; in slices or
    whole, the same codes, rows, ids and counts; searched, it answers as
    the plain reference does on its arrays."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat \
        import _balance_assignments, _choose_capacity
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.kmeans import (
        kmeans_assign_topk,
    )

    x, q = _data()
    trained = _index(0)

    def build():
        idx = IVFPQIndex(_config(), device="cpu")
        idx.centroids, idx.codebooks = trained.centroids, trained.codebooks
        idx.trained = True
        idx.build_from_device(torch.from_numpy(x).to(torch.bfloat16))
        return idx

    whole = build()
    monkeypatch.setattr(IVFPQIndex, "BUILD_SLICE_ROWS", slice_rows)
    idx = build()
    choices = kmeans_assign_topk(
        torch.from_numpy(x).to(torch.bfloat16).float(), trained.centroids,
        ivf_pq.BULK_ASSIGN_CHOICES).numpy()
    cap = _choose_capacity(np.bincount(choices[:, 0], minlength=NLIST), 128)
    want = np.bincount(_balance_assignments(choices, cap, NLIST),
                       minlength=NLIST)
    assert idx.capacity == cap and int(idx.counts.max()) <= cap
    np.testing.assert_array_equal(idx.counts.numpy(), want)
    assert sorted(idx.ids[idx.ids != INVALID_ID].tolist()) == list(range(N))
    for a, b in ((idx.code_arena_t, whole.code_arena_t),
                 (idx.code_sq, whole.code_sq),
                 (idx.raw.arena, whole.raw.arena)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(idx.ids, whole.ids)
    d, ids = idx.search(q, SearchParams(nprobe=NPROBE, k=K,
                                        use_exact_rerank=True))
    d_r, ids_r, _ = _reference(idx, q, min(4 * K, 256))
    scale = (q * q).sum(1) + float(idx.raw.arena_sq.max())
    assert_topk_match(d, ids, d_r, ids_r, rtol=1e-5, atol=1e-5 * scale)
    with pytest.raises(ValueError, match="empty index"):
        idx.build_from_device(torch.from_numpy(x[:10]))


class _Step:
    def __init__(self, fn):
        self.replay = fn


class _ReplayedGraph(ivf_pq._SearchGraph):
    """A search graph whose capture keeps its two steps and runs them at
    each replay: what surrounds the CUDA graphs (the static query buffer
    of a batch bucket, the answers' slices, the probes' heat, the rerank's
    row count, the cache by shape) on the CPU, where nothing is captured."""

    def __init__(self, rows, dim, device, shortlist, finish):
        self.q = torch.zeros((rows, dim), dtype=torch.float32, device=device)
        self.launches = 0
        self.shortlist = _Step(
            lambda: setattr(self, "short", shortlist(self.q)))
        self.finish = _Step(lambda: setattr(self, "out", finish(self.short)))
        self.captures.append(rows)


@pytest.fixture
def replayed(monkeypatch):
    """A fresh index whose searches go through :class:`_ReplayedGraph`."""
    monkeypatch.setattr(ivf_pq, "_SearchGraph", _ReplayedGraph)
    monkeypatch.setattr(_ReplayedGraph, "captures", [], raising=False)
    monkeypatch.setattr(IVFPQIndex, "_graphable",
                        lambda self, q: self.graph_searches
                        and q.shape[0] <= 1024)
    x, _ = _data()
    idx = IVFPQIndex(_config(64), device="cpu")
    idx.train(x)
    idx.add(x[:2500])
    return idx


@pytest.mark.parametrize("rerank", [True, False], ids=["rerank", "adc"])
@pytest.mark.parametrize("batch", [20, 13, 1])
def test_a_replayed_search_answers_as_the_eager_search(replayed, batch,
                                                       rerank):
    """The first search of a shape runs eagerly, the second captures it
    (its batch bucket of rows), the third replays the capture: all three
    answer as an index without graphs does, count the same rerank rows a
    query and heat the same lists."""
    idx = replayed
    _, q = _data()
    q = q[:batch]
    p = SearchParams(nprobe=NPROBE, k=K, use_exact_rerank=rerank)

    def search():
        heat0 = idx.list_access_count.copy()
        fin = idx.search_async(q, p)
        d, ids = fin()
        return d, ids, dict(fin.counts), idx.list_access_count - heat0

    idx.graph_searches = False
    want = search()
    idx.graph_searches = True
    for n in range(3):
        d, ids, counts, heat = search()
        np.testing.assert_array_equal(ids, want[1])
        np.testing.assert_array_equal(d, want[0])
        assert counts == want[2]
        np.testing.assert_array_equal(heat, want[3])
        assert _ReplayedGraph.captures == (
            [] if n == 0 else [{20: 32, 13: 16, 1: 1}[batch]])
    assert ("rerank_rows" in want[2]) == rerank


def test_search_graphs_are_kept_by_shape(replayed):
    """A mutation publishes new counts, which makes a new shape: the old
    capture is never replayed for it and the answers see the new rows.
    At most ``GRAPH_SHAPES`` captures are kept, the least recently used
    dropped first."""
    idx = replayed
    x, q = _data()
    p = SearchParams(nprobe=NPROBE, k=K, use_exact_rerank=True)
    for _ in range(3):
        idx.search(q[:8], p)
    assert _ReplayedGraph.captures == [8] and len(idx._graphs) == 1
    idx.add(x[2500:], np.arange(2500, N, dtype=np.uint64))
    idx.graph_searches = False
    want = idx.search(q[:8], p)
    idx.graph_searches = True
    for n in range(2):
        got = idx.search(q[:8], p)
        np.testing.assert_array_equal(got[1], want[1])
    assert _ReplayedGraph.captures == [8, 8] and len(idx._graphs) == 2
    idx.GRAPH_SHAPES = 2
    for b in (1, 2, 1, 2):
        idx.search(q[:b], p)
    assert _ReplayedGraph.captures == [8, 8, 1, 2]
    assert sorted(key[0] for key in idx._graphs) == [1, 2]
