"""PyTorch port, the streaming tier: the device list cache on its own, the
host store against the JAX package's, and the port's
``StreamingIVFFlatIndex`` against the JAX one (whose ``"pallas_sorted"``
runs K3 in interpret mode) on identical state carried across (CPU)."""

import gc
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFFlatConfig as JConfig,
    IVFFlatIndex as JIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.io_host import (
    StreamingIVFFlatIndex as JStreaming,
)
from cuda_acceleratedvectordatabaseengine_tpu.io_host.streaming import (
    HostListStore as JStore,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFFlatConfig,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
    HbmListCache,
    HostListStore,
    ListPrefetcher,
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.convert import (
    ivf_flat_from_arrays,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import sorted_scan
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

DIM = 16


def _lists(n_lists, rows, dim=8):
    return {l: (np.full((rows, dim), l, np.float32),
                np.zeros(rows, np.float32), rows) for l in range(n_lists)}


def _cache(n_slots=3, policy="lru", cap=8, dtype=torch.float32):
    return HbmListCache(n_slots, cap, 8, dtype, policy, device="cpu")


def test_cache_hit_miss_lru_eviction():
    data = _lists(10, 4)
    cache = _cache()
    m = cache.ensure_resident(np.array([0, 1, 2]), data.__getitem__)
    assert sorted(m) == [0, 1, 2] and cache.misses == 3 and cache.hits == 0
    cache.ensure_resident(np.array([1]), data.__getitem__)
    assert cache.hits == 1
    time.sleep(0.01)
    cache.ensure_resident(np.array([5]), data.__getitem__)
    assert set(cache.resident_lists()) == {1, 2, 5}  # 1 was used last
    slot = cache.ensure_resident(np.array([5]), data.__getitem__)[5]
    assert float(cache.cache_arena[slot, 0, 0]) == 5.0
    assert int(cache.cache_counts[slot]) == 4
    # rows past the count are zero and the norms are of the stored rows
    assert float(cache.cache_arena[slot, 4:].abs().sum()) == 0.0
    np.testing.assert_allclose(cache.cache_sq[slot, :4].numpy(), 25.0 * 8)
    assert cache.h2d_bytes > 0 and 0 < cache.get_hit_rate() < 1
    assert cache.evict_list(5) and 5 not in cache.resident_lists()
    assert not cache.evict_list(99)


def test_cache_lfu_victim_and_sentinel():
    data = _lists(10, 2)
    cache = _cache(policy="lfu")
    for _ in range(3):
        cache.ensure_resident(np.array([0, 1]), data.__getitem__)
    cache.ensure_resident(np.array([2]), data.__getitem__)   # freq 1
    cache.ensure_resident(np.array([7]), data.__getitem__)
    assert 2 not in cache.resident_lists()                  # least frequent
    assert {0, 1, 7} == set(cache.resident_lists())
    # the sentinel row (index n_slots) is never assigned and stays empty
    assert int(cache.cache_counts[3]) == 0
    assert float(cache.cache_arena[3].abs().sum()) == 0.0
    with pytest.raises(ValueError):
        cache.ensure_resident(np.arange(4), data.__getitem__)
    with pytest.raises(ValueError):
        HbmListCache(2, 8, 8, policy="fifo", device="cpu")


def test_cache_soft_protect_prefers_unprotected_victim():
    data = _lists(10, 2)
    cache = _cache(cap=4)
    cache.ensure_resident(np.array([1, 2]), data.__getitem__)
    time.sleep(0.01)
    cache.ensure_resident(np.array([0]), data.__getitem__)   # 0 = freshest
    cache.ensure_resident(np.array([5]), data.__getitem__,
                          soft_protect={1, 2})
    assert 0 not in cache.resident_lists()
    assert {1, 2, 5} <= set(cache.resident_lists())
    cache.ensure_resident(np.array([7]), data.__getitem__,
                          soft_protect={1, 2, 5})
    assert 7 in cache.resident_lists()


def test_cache_int8_planes_and_upload_batches(monkeypatch):
    """An int8 cache takes codes, norms, scales and anchors as the store
    hands them; uploads larger than a batch split and still land."""
    rng = np.random.default_rng(3)
    store = {l: (rng.integers(-127, 128, (l + 1, 8)).astype(np.int8),
                 rng.random(l + 1).astype(np.float32), l + 1,
                 rng.random(l + 1).astype(np.float32),
                 rng.random(8).astype(np.float32)) for l in range(6)}
    monkeypatch.setattr(HbmListCache, "UPLOAD_BATCH_BYTES", 2 * 8 * 8)
    cache = HbmListCache(6, 8, 8, torch.int8, device="cpu")
    assert cache.quantized and cache._batch_lists() == 2
    m = cache.ensure_resident(np.arange(6), store.__getitem__)
    for l, s in m.items():
        v, sq, c, sc, an = store[l]
        np.testing.assert_array_equal(cache.cache_arena[s, :c].numpy(), v)
        np.testing.assert_array_equal(cache.cache_sq[s, :c].numpy(), sq)
        np.testing.assert_array_equal(cache.cache_scale[s, :c].numpy(), sc)
        np.testing.assert_array_equal(cache.cache_anchors[s].numpy(), an)
        assert int(cache.cache_counts[s]) == c
        assert float(cache.cache_scale[s, c:].abs().sum()) == 0.0
    assert cache.memory_bytes() == 7 * 8 * 8 + 7 * 8 * 4 * 2 + 7 * 4 \
        + 7 * 8 * 4


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_host_store_from_assignments_is_bit_identical(rng, dtype):
    x = rng.standard_normal((500, DIM)).astype(np.float32)
    ids = rng.permutation(500).astype(np.uint64)
    assign = rng.integers(0, 8, 500).astype(np.int32)
    anchors = rng.standard_normal((8, DIM)).astype(np.float32)
    kw = dict(dtype=dtype, anchors=anchors if dtype == "int8" else None)
    a = HostListStore.from_assignments(x, ids, assign, 8, **kw)
    b = JStore.from_assignments(x, ids, assign, 8, **kw)
    for l in range(8):
        for name in ("vectors", "sq", "ids") + (
                ("scale",) if dtype == "int8" else ()):
            got, ref = getattr(a, name)[l], getattr(b, name)[l]
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    assert a.nbytes() == b.nbytes() and a.total() == 500
    lists = np.array([[0, 3, -1]])
    offs = np.array([[0, 1, 0]])
    np.testing.assert_array_equal(a.lookup_ids(lists, offs),
                                  b.lookup_ids(lists, offs))
    assert a.lookup_ids(lists, offs)[0, 2] == INVALID_ID


def _carried(rng, dtype, n=2000, nlist=16):
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    kw = dict(dimension=DIM, nlist=nlist, dtype=dtype, train_iters=8)
    jidx = JIndex(JConfig(**kw))
    jidx.train(x)
    jidx.add(x)
    a = jidx.arena
    opt = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    tidx = ivf_flat_from_arrays(
        IVFFlatConfig(**kw), centroids=np.asarray(jidx.centroids),
        arena=np.asarray(a.arena), arena_sq=np.asarray(a.arena_sq),
        arena_scale=opt(a.arena_scale), anchors=opt(a.anchors),
        counts=np.asarray(a.counts), ids=a.ids, counts_max=a.counts_max,
        device="cpu",
    )
    return jidx, tidx, x


def _check(got, ref, q):
    assert_topk_match(*got, *ref, rtol=1e-5, atol=1e-5 * (q * q).sum(1))


# (name, cache slots, batch, nprobe, k): one wave; several waves; a cache
# smaller than one wave's set; a column wider than the cache (batch split)
CASES = [("one_wave", 16, 8, 4, 10), ("many_waves", 6, 4, 8, 10),
         ("tiny_cache", 3, 4, 8, 5), ("wide_column", 2, 8, 2, 10)]


@pytest.mark.parametrize("scan_impl", ["auto", "pallas_sorted",
                                       "pallas_grouped"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_streaming_matches_jax(rng, case, dtype, scan_impl):
    _, slots, batch, nprobe, k = case
    jidx, tidx, x = _carried(rng, dtype)
    j = JStreaming(jidx, cache_slots=slots, scan_impl=(
        "gather" if scan_impl == "auto" else scan_impl))
    t = StreamingIVFFlatIndex(tidx, cache_slots=slots, scan_impl=scan_impl,
                              device="cpu")
    assert t.store.dtype == j.store.dtype == dtype
    assert t.cache.cache_arena.dtype == {"int8": torch.int8,
                                         "float32": torch.float32}[dtype]
    q = x[rng.choice(len(x), batch, replace=False)] + 0.1 * \
        rng.standard_normal((batch, DIM)).astype(np.float32)
    p = dict(nprobe=nprobe, k=k)
    got = t.search(q, SearchParams(**p))
    _check(got, j.search(q, JParams(**p)), q)
    _check(got, tidx.search(q, SearchParams(**p)), q)   # = resident index
    st = t.stats()
    assert st["misses"] > 0 and st["resident"] <= slots
    assert st["waves"] >= st["batches"] >= 1
    if case[0] == "wide_column":
        assert st["batches"] > 1                        # rows were split


def test_streaming_from_store_matches_jax(rng):
    jidx, tidx, x = _carried(rng, "float32")
    assign = rng.integers(0, 16, len(x)).astype(np.int32)
    ids = np.arange(len(x), dtype=np.uint64) + 7
    cent = np.asarray(jidx.centroids)
    t = StreamingIVFFlatIndex.from_store(
        HostListStore.from_assignments(x, ids, assign, 16), cent,
        tidx.config, cache_slots=8, scan_impl="pallas_sorted", device="cpu")
    j = JStreaming.from_store(JStore.from_assignments(x, ids, assign, 16),
                              jnp.asarray(cent), jidx.config, cache_slots=8,
                              scan_impl="pallas_sorted")
    q = x[:4] + 0.05
    got = t.search(q, SearchParams(nprobe=16, k=10))
    _check(got, j.search(q, JParams(nprobe=16, k=10)), q)
    assert (got[1][:, 0] == ids[:4]).all()
    assert t.cache.capacity == j.cache.capacity
    assert t.memory_stats()["host_bytes"] == j.memory_stats()["host_bytes"]


def test_streaming_prefetch_hot_lists_and_evict(rng):
    _, tidx, x = _carried(rng, "int8")
    t = StreamingIVFFlatIndex(tidx, cache_slots=8, device="cpu")
    assert t.scan_impl == "gather" and t.cache.quantized
    t.prefetch_lists([0, 1, 2])
    assert set(t.cache.resident_lists()) >= {0, 1, 2}
    for _ in range(3):
        t.search(x[:4], SearchParams(nprobe=2, k=5))
    hot = t.prefetch_hot_lists()
    assert hot and set(hot) <= set(t.cache.resident_lists())
    t.evict_list(hot[0])
    assert hot[0] not in t.cache.resident_lists()
    t.warmup_lists(list_ids=[hot[0]])
    assert hot[0] in t.cache.resident_lists()
    t.warmup_lists(batch_sizes=(1, 2), nprobes=(2,))
    ms = t.memory_stats()
    assert ms["total_vectors"] == len(x) == t.ntotal
    assert ms["arena_bytes"] == t.cache.memory_bytes()
    lp = ListPrefetcher(min_accesses=2.0)
    lp.record_many([3, 4], [5, 1])
    assert lp.prefetch_hot_lists(4) == [3] and lp.get_hot_lists(1) == [3]
    assert lp.hotness(3) == 1.0 and 0 < lp.hotness(4) < 1


def test_streaming_deep_k_takes_the_sorted_scan(rng, monkeypatch):
    """k above K1's depth cap sends the grouped cache scan to K3, with the
    resident index's answer."""
    _, tidx, x = _carried(rng, "int8")
    t = StreamingIVFFlatIndex(tidx, cache_slots=16, scan_impl="grouped",
                              device="cpu")
    calls = []
    real = sorted_scan.scan_probed_lists_sorted
    monkeypatch.setattr(
        "cuda_acceleratedvectordatabaseengine_tpu_torch.ops.flat_scan."
        "scan_probed_lists_sorted",
        lambda *a, **kw: calls.append(a[5]) or real(*a, **kw))
    q = x[:3]
    got = t.search(q, SearchParams(nprobe=4, k=100))
    assert calls and all(k == 100 for k in calls)
    _check(got, tidx.search(q, SearchParams(nprobe=4, k=100)), q)
    assert (got[1] != INVALID_ID).sum() > 0


def test_dropping_the_tier_frees_its_cache_without_the_collector(rng):
    """The prefetcher refers to the cache and the store, not to the tier,
    so the tier and its device cache go as soon as the last reference
    does, with the cycle collector off."""
    _, tidx, x = _carried(rng, "int8")
    t = StreamingIVFFlatIndex(tidx, cache_slots=8, device="cpu")
    t.search(x[:4], SearchParams(nprobe=2, k=5))
    assert t.prefetch_hot_lists() is not None
    tier_ref, cache_ref = weakref.ref(t), weakref.ref(t.cache)
    gc.disable()
    try:
        del t
        assert tier_ref() is None and cache_ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("scan_impl,k,dtype,want", [
    ("auto", 10, "int8", "gather"), ("pallas_grouped", 10, "int8", "grouped"),
    ("pallas_grouped", 100, "int8", "sorted"),
    ("pallas", 10, "int8", "sorted"), ("pallas", 10, "float32", "pallas"),
])
def test_streaming_cache_scan_routes_as_the_resident_index(
        rng, monkeypatch, scan_impl, k, dtype, want):
    """The tier's cache scan goes through the same router as the resident
    index (``ops/flat_scan.py``): the same name, depth and arena dtype
    select the same scan, and the answer is the resident index's."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import flat_scan

    _, tidx, x = _carried(rng, dtype)
    t = StreamingIVFFlatIndex(tidx, cache_slots=16, scan_impl=scan_impl,
                              device="cpu")
    calls = []
    names = {"grouped": "scan_probed_lists_grouped",
             "sorted": "scan_probed_lists_sorted",
             "pallas": "scan_probed_lists_pairs",
             "gather": "scan_probed_lists"}
    for impl, name in names.items():
        real = getattr(flat_scan, name)
        monkeypatch.setattr(flat_scan, name,
                            lambda *a, _r=real, _i=impl, **kw:
                            calls.append(_i) or _r(*a, **kw))
    q = x[:3] + 0.05
    got = t.search(q, SearchParams(nprobe=4, k=k))
    assert calls and set(calls) == {want}
    tidx.config.scan_impl = scan_impl
    calls.clear()
    _check(got, tidx.search(q, SearchParams(nprobe=4, k=k)), q)
    assert set(calls) == {want}
