"""PyTorch port, the IVF-PQ slice as a whole: a JAX-built index carried
across searches the same in both packages; the port's own train / add /
calibrate / search reaches the JAX index's recall; capacities, snapshots,
OPQ calibration and the not-ported surface (CPU)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFPQConfig as JConfig,
    IVFPQIndex as JIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.models.calibrate import (
    probe_coverage_calibrate as j_calibrate,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.calibrate import (
    probe_coverage_calibrate,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.convert import (
    ivf_pq_from_arrays,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    _ivf_pq_search_device,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
    grouped_pq_scan,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

N, DIM, NLIST, M = 4000, 32, 8, 4


def _recall(found_ids, true_ids):
    hits = sum(len(set(f.tolist()) & set(t.tolist()))
               for f, t in zip(found_ids, true_ids))
    return hits / true_ids.size


@functools.lru_cache(maxsize=None)
def _data():
    """Clustered corpus (16 modes) and held-out queries near it."""
    rng = np.random.default_rng(7)
    centers = 2.0 * rng.standard_normal((16, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, 16, N)]
         + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (x[rng.integers(0, N, 24)]
         + 0.3 * rng.standard_normal((24, DIM))).astype(np.float32)
    return x, q


@functools.lru_cache(maxsize=None)
def _recall_queries():
    """200 held-out queries: enough that recall is stable to ~0.015
    between two trainings that differ only in their random draws."""
    x, _ = _data()
    rng = np.random.default_rng(8)
    return (x[rng.integers(0, N, 200)]
            + 0.3 * rng.standard_normal((200, DIM))).astype(np.float32)


def _cfg_kw(metric, opq, raw_dtype, keep_raw=True, m=M):
    return dict(dimension=DIM, nlist=NLIST, m=m, metric=metric, opq=opq,
                opq_iters=3, raw_dtype=raw_dtype, keep_raw=keep_raw,
                pq_train_sample=2048, train_iters=10)


@functools.lru_cache(maxsize=None)
def _jax_index(metric="L2", opq=False, raw_dtype="bfloat16", m=M):
    x, _ = _data()
    idx = JIndex(JConfig(**_cfg_kw(metric, opq, raw_dtype, m=m)))
    idx.train(x)
    idx.add(x)
    return idx


def _carry(jidx, cfg):
    raw = jidx.raw
    opt = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    return ivf_pq_from_arrays(
        cfg, centroids=np.asarray(jidx.centroids),
        codebooks=np.asarray(jidx.codebooks),
        codes_t=np.asarray(jidx.code_arena_t),
        code_sq=np.asarray(jidx.code_sq), counts=np.asarray(jidx.counts),
        ids=jidx.ids, raw_arena=opt(raw.arena), raw_sq=opt(raw.arena_sq),
        raw_scale=opt(raw.arena_scale), raw_anchors=opt(raw.anchors),
        opq_R=opt(jidx.opq_R), device="cpu",
    )


CARRIED = [("L2", False, "bfloat16"), ("InnerProduct", False, "bfloat16"),
           ("Cosine", False, "bfloat16"), ("L2", True, "bfloat16"),
           ("L2", False, "int8")]


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("metric,opq,raw_dtype", CARRIED)
def test_carried_index_searches_like_jax(metric, opq, raw_dtype, impl,
                                         rerank):
    jidx = _jax_index(metric, opq, raw_dtype)
    cfg = IVFPQConfig(**_cfg_kw(metric, opq, raw_dtype), scan_impl=impl)
    tidx = _carry(jidx, cfg)
    assert tidx.ntotal == N and tidx.capacity == jidx.capacity
    _, q = _data()
    jidx.config.scan_impl = impl
    params = dict(nprobe=6, k=10, use_exact_rerank=rerank)
    d_j, i_j = jidx.search(q, JParams(**params))
    d_t, i_t = tidx.search(q, SearchParams(**params))
    assert d_t.dtype == np.float32 and i_t.dtype == np.uint64
    scale = q if metric != "Cosine" else q / np.linalg.norm(
        q, axis=1, keepdims=True)
    # fp32 sums in another order: a few ulps of ‖q‖²
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5,
                      atol=1e-5 * (scale ** 2).sum(1))


def test_port_end_to_end_recall_near_jax(oracle):
    """train → add → calibrate → search on the port alone reaches the JAX
    index's recall (ADC-only and reranked, at the port's calibrated
    nprobe) on the same data, within 0.03."""
    x, _ = _data()
    q = _recall_queries()
    _, truth = oracle(q, x, 10)
    idx = IVFPQIndex(IVFPQConfig(**_cfg_kw("L2", False, "bfloat16", m=8)),
                     device="cpu")
    idx.train(x)
    idx.add(x)
    rep = idx.calibrate_nprobe(queries=q, target_coverage=0.95, k=10)
    assert idx.calibrated_nprobe == rep["nprobe"]
    jidx = _jax_index(m=8)
    jidx.calibrated_nprobe = rep["nprobe"]
    for rerank in (False, True):
        p = dict(nprobe=0, k=10, use_exact_rerank=rerank)
        r_t = _recall(idx.search(q, SearchParams(**p))[1].astype(np.int64),
                      truth)
        r_j = _recall(jidx.search(q, JParams(**p))[1].astype(np.int64),
                      truth)
        assert r_t >= r_j - 0.03, (rerank, r_t, r_j)
    assert r_t > 0.9


@pytest.mark.parametrize("keep_raw", [True, False])
def test_code_and_raw_capacity_stay_equal_across_growth(rng, keep_raw):
    x = rng.standard_normal((1000, DIM)).astype(np.float32)
    idx = IVFPQIndex(IVFPQConfig(**_cfg_kw("L2", False, "bfloat16",
                                           keep_raw=keep_raw)), device="cpu")
    idx.train(x)
    idx.add(x)
    cap0 = idx.capacity
    for _ in range(3):
        idx.add(rng.standard_normal((1000, DIM)).astype(np.float32))
    assert idx.ntotal == 4000 and idx.capacity > cap0
    assert idx.code_sq.shape[1] == idx.ids.shape[1] == idx.capacity
    if keep_raw:
        assert idx.raw.capacity == idx.capacity
    d, ids = idx.search(x[:4], SearchParams(nprobe=NLIST, k=3,
                                            use_exact_rerank=keep_raw))
    assert (ids != INVALID_ID).all()
    if keep_raw:
        assert (ids[:, 0] == np.arange(4)).all()
    idx.reserve(idx.capacity + 1)
    assert idx.capacity % 128 == 0
    if keep_raw:
        assert idx.raw.capacity == idx.capacity


def test_search_snapshot_unaffected_by_later_add(rng):
    """A dispatched search finalizes against its own snapshot (ids table,
    capacity), even when a later add grows the arenas."""
    x, q = _data()
    idx = IVFPQIndex(IVFPQConfig(**_cfg_kw("L2", False, "bfloat16")),
                     device="cpu")
    idx.train(x)
    idx.add(x[:2000])
    params = SearchParams(nprobe=NLIST, k=5, use_exact_rerank=True)
    before = idx.search(q, params)
    pending = idx.search_async(q, params)
    cap0 = idx.capacity
    idx.add(np.repeat(q, 40, axis=0))          # exact hits, forces growth
    assert idx.capacity > cap0
    d, ids = pending()
    np.testing.assert_array_equal(ids, before[1])
    np.testing.assert_array_equal(d, before[0])
    after = idx.search(q, params)
    assert (after[1][:, 0] >= 2000).all()      # the new rows now win
    batches = list(idx.search_batches_pipelined([q[:8], q[8:]], params))
    np.testing.assert_array_equal(
        np.concatenate([b[1] for b in batches]), after[1])


def test_calibrate_query_transform_matches_jax(rng):
    """Coverage ranked in a rotated frame (the OPQ case): the port and the
    JAX package agree, and rotating back gives the same curve."""
    cen = rng.standard_normal((NLIST, DIM)).astype(np.float32)
    R, _ = np.linalg.qr(rng.standard_normal((DIM, DIM)))
    R = R.astype(np.float32)
    q = rng.standard_normal((64, DIM)).astype(np.float32)
    ids_table = np.arange(NLIST * 16, dtype=np.uint64).reshape(NLIST, 16)
    true = rng.integers(0, NLIST * 16, (64, 5)).astype(np.uint64)

    def exact(qq, kk):
        return np.zeros((len(qq), kk), np.float32), true[:, :kk]

    kw = dict(ids_table=ids_table, queries=q,
              exact_search_fn=exact, k=5, target_coverage=0.9,
              candidates=(1, 2, 4))
    cen_rot = cen @ R
    got = probe_coverage_calibrate(
        centroids=torch.from_numpy(cen_rot),
        query_transform=lambda t: t @ torch.from_numpy(R),
        metric=Metric.L2, **kw)
    ref = j_calibrate(centroids=jnp.asarray(cen_rot),
                      query_transform=lambda t: t @ jnp.asarray(R),
                      metric=JMetric.L2, **kw)
    plain = probe_coverage_calibrate(centroids=torch.from_numpy(cen),
                                     metric=Metric.L2, **kw)
    assert got["curve"] == ref["curve"] == plain["curve"]
    assert got["nprobe"] == ref["nprobe"]


def test_calibrate_nprobe_under_opq():
    x, _ = _data()
    idx = IVFPQIndex(IVFPQConfig(**_cfg_kw("L2", True, "bfloat16")),
                     device="cpu")
    idx.train(x)
    idx.add(x)
    assert idx.opq_R is not None
    rep = idx.calibrate_nprobe(sample=64, target_coverage=0.9, k=5)
    assert 1 <= rep["nprobe"] <= NLIST
    assert rep["curve"][NLIST] == pytest.approx(1.0)
    R = idx.opq_R.numpy().astype(np.float64)
    assert np.abs(R.T @ R - np.eye(DIM)).max() < 2e-5


def test_state_memory_and_not_ported_surface(tmp_path):
    x, q = _data()
    idx = IVFPQIndex(IVFPQConfig(**_cfg_kw("L2", False, "int8")), device="cpu")
    idx.train(x[:1000])
    idx.add(x[:1000])
    st = idx.state_arrays()
    assert st["codes"].shape == (NLIST, idx.capacity, M)
    assert st["arena"].dtype == np.float32
    l = int(np.argmax(st["counts"]))
    np.testing.assert_allclose(st["arena"][l, 0], x[int(st["ids"][l, 0])],
                               rtol=0.1, atol=0.05)
    # the code_arena setter re-derives the decoded norms (code_sq)
    fresh = IVFPQIndex(IVFPQConfig(**_cfg_kw("L2", False, "int8")),
                       device="cpu")
    fresh.centroids, fresh.codebooks = idx.centroids, idx.codebooks
    fresh.code_arena = st["codes"]
    assert fresh.code_arena_t.is_contiguous()
    np.testing.assert_array_equal(fresh.code_arena_t.numpy(),
                                  idx.code_arena_t.numpy())
    live = np.arange(idx.capacity)[None, :] < st["counts"][:, None]
    np.testing.assert_allclose(fresh.code_sq.numpy()[live],
                               idx.code_sq.numpy()[live], rtol=1e-5)
    mem = idx.memory_stats()
    assert mem["code_bytes"] == NLIST * M * idx.capacity
    assert mem["total_vectors"] == 1000
    idx.search(q[:2], SearchParams(nprobe=4, k=3))
    assert idx.list_access_count.sum() > 0
    hot = idx.get_hot_lists(2)
    idx.evict_list(int(hot[0]))
    assert idx.list_access_count[hot[0]] == 0
    idx.warmup_lists(batch_sizes=(1,), nprobes=(2,))
    assert grouped_pq_scan.LAUNCHES == 0
    # removal and snapshots are ported (tests/test_torch_removal.py and
    # tests/test_torch_storage.py hold them against the JAX package)
    assert idx.remove_ids(np.array([1, 1, 10**9], np.uint64)) == 1
    assert idx.ntotal == 999 and 1 not in idx.ids
    idx.save(str(tmp_path / "snap"))
    back = IVFPQIndex.load(str(tmp_path / "snap"), device="cpu")
    np.testing.assert_array_equal(
        back.search(q[:4], SearchParams(nprobe=4, k=3))[1],
        idx.search(q[:4], SearchParams(nprobe=4, k=3))[1])
    # the host rerank is ported (tests/test_torch_host_rerank.py); an
    # index with resident raw rows refuses a host store, as in JAX
    with pytest.raises(ValueError, match="keep_raw"):
        idx.attach_host_rerank(None)
    with pytest.raises(NotImplementedError):
        IVFPQConfig(dimension=DIM, m=M, query_upload_dtype="bfloat16")
    with pytest.raises(ValueError):
        IVFPQConfig(dimension=DIM, m=M, scan_impl="pallas_sorted")
    with pytest.raises(ValueError):
        IVFPQConfig(dimension=30, m=8)


def test_list_heat_counts_each_query_over_its_probe_set(monkeypatch):
    """IVF-PQ counts list heat as IVF-Flat does: per query over its probe
    set (two queries probing one list add 2, a -1 probe adds nothing),
    not the lists of the returned positions as the JAX package does."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models import (
        ivf_pq as pq_mod,
    )

    _, q = _data()
    idx = _carry(_jax_index(), IVFPQConfig(**_cfg_kw("L2", False,
                                                      "bfloat16")))
    probes = torch.tensor([[2, 6], [2, -1]], dtype=torch.int32)
    real = pq_mod.topk_smallest
    seen = []

    def probe_topk(d, k, *a, **kw):
        if not seen and d.shape[-1] == NLIST and k == 2:  # the coarse probe
            seen.append(k)
            return d[:, :2], probes
        return real(d, k, *a, **kw)

    monkeypatch.setattr(pq_mod, "topk_smallest", probe_topk)
    before = idx.list_access_count
    idx.search(q[:2], SearchParams(nprobe=2, k=3))
    assert seen
    expect = np.zeros(NLIST, np.int64)
    expect[[2, 6]] = [2, 1]
    np.testing.assert_array_equal(idx.list_access_count - before, expect)


@pytest.mark.parametrize("name,route", [
    ("pallas", "grouped_adc"), ("grouped", "grouped_adc"),
    ("xla", "_gather_adc"), ("gather", "_gather_adc"),
    ("auto", "_gather_adc")])
def test_device_search_resolves_every_scan_name(name, route, monkeypatch):
    """``_ivf_pq_search_device`` takes the config path's names: the JAX
    package's ``"pallas"`` reaches the grouped ADC (K2 on CUDA) as
    ``"grouped"`` does, ``"xla"`` and ``"gather"`` the gather ADC, and
    ``"auto"`` the gather ADC on CPU tensors; both give the same
    answers."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models import (
        ivf_pq as pq_mod,
    )

    calls = []
    for fn in ("grouped_adc", "_gather_adc"):
        monkeypatch.setattr(pq_mod, fn, functools.partial(
            lambda real, fn, *a, **kw: calls.append(fn) or real(*a, **kw),
            getattr(pq_mod, fn), fn))
    idx = _carry(_jax_index(), IVFPQConfig(**_cfg_kw("L2", False,
                                                      "bfloat16")))
    _, q = _data()
    raw = idx.raw

    def search(impl):
        return pq_mod._ivf_pq_search_device(
            torch.from_numpy(q[:6]), idx.centroids, idx.codebooks,
            idx.code_arena_t, idx.code_sq, idx.counts, raw.arena,
            raw.arena_sq, raw.arena_scale, raw.anchors, 4, 5, Metric.L2, 0,
            scan_impl=impl)

    d, pos = search(name)
    assert calls == [route]
    ref_d, ref_pos = search("gather")
    assert_topk_match(d.numpy(), pos.numpy(), ref_d.numpy(), ref_pos.numpy(),
                      rtol=1e-5, atol=1e-4)


def test_device_search_refuses_an_unknown_scan_name():
    idx = _carry(_jax_index(), IVFPQConfig(**_cfg_kw("L2", False,
                                                      "bfloat16")))
    _, q = _data()
    with pytest.raises(ValueError, match="bogus"):
        _ivf_pq_search_device(
            torch.from_numpy(q[:2]), idx.centroids, idx.codebooks,
            idx.code_arena_t, idx.code_sq, idx.counts, None, None, None, None,
            4, 5, Metric.L2, 0, scan_impl="bogus")
