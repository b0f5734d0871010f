"""PyTorch port, ``parallel/sharded_streaming.py``: the streaming tier over
a mesh (a slot-striped device list cache) against the port's single-device
tier, the resident index and the JAX package's sharded tier (on its
8-device CPU mesh) on the same state carried across (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFFlatConfig as JConfig,
    IVFFlatIndex as JIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.parallel import (
    ShardedStreamingIVFFlatIndex as JShardedStreaming,
    make_mesh as j_make_mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
    HostListStore,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.convert import (
    ivf_flat_from_arrays,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.kmeans import (
    kmeans_assign,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel import (
    ShardedStreamingIVFFlatIndex,
    make_mesh,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

DIM = 16


def _mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _check(got, ref, q):
    # fp32 sums in another order: a few ulps of ‖q‖²
    assert_topk_match(*got, *ref, rtol=1e-5, atol=1e-5 * (q * q).sum(1))


def _carried(dtype, n=2000, nlist=16):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    q = rng.standard_normal((6, DIM)).astype(np.float32)
    kw = dict(dimension=DIM, nlist=nlist, dtype=dtype, train_iters=5)
    jidx = JIndex(JConfig(**kw))
    jidx.train(x)
    if dtype == "int8":
        jidx.build_from_device(jnp.asarray(x))
    else:
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
    return jidx, tidx, x, q


# (dtype, scan_impl, N, cache slots, nprobe): one wave and several waves
# with evictions, every scan name of the tier, both cache kinds. At least
# 8 slots: the JAX tier pads the 6 queries to 8 and needs every probe
# column's lists in the cache at once.
CASES = [("float32", "auto", 2, 16, 8), ("float32", "pallas_grouped", 8, 8, 8),
         ("int8", "pallas_sorted", 4, 16, 8), ("int8", "auto", 8, 8, 12),
         ("float32", "pallas", 4, 9, 10)]


@pytest.mark.parametrize("dtype,impl,n,slots,nprobe", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_sharded_streaming_matches_single_device_and_jax(dtype, impl, n,
                                                         slots, nprobe):
    """The mesh tier's answers are the single-device tier's and the JAX
    sharded tier's (tie-aware, fp32 tolerance); an int8 store keeps an
    int8 cache with scale and anchor planes."""
    jidx, tidx, _, q = _carried(dtype)
    p = dict(nprobe=nprobe, k=10)
    tier = ShardedStreamingIVFFlatIndex.from_base(
        tidx, _mesh(n), cache_slots=slots, scan_impl=impl)
    assert tier.cache.quantized == (dtype == "int8")
    got = tier.search(q, SearchParams(**p))
    single = StreamingIVFFlatIndex(tidx, cache_slots=slots, scan_impl=impl,
                                   device="cpu")
    _check(got, single.search(q, SearchParams(**p)), q)
    _check(got, tidx.search(q, SearchParams(**p)), q)
    jtier = JShardedStreaming.from_base(
        jidx, j_make_mesh(n), cache_slots=slots,
        scan_impl="gather" if impl == "auto" else impl)
    _check(got, jtier.search(q, JParams(**p)), q)
    assert tier.stats()["waves"] == single.stats()["waves"]


def test_sharded_streaming_waves_and_eviction():
    """A cache smaller than the probe set: several waves with evictions
    between them, answers still the resident index's, and the cache bytes
    striped (each shard holds 1/N of every slot)."""
    _, tidx, _, q = _carried("float32")
    tier = ShardedStreamingIVFFlatIndex.from_base(tidx, _mesh(4),
                                                  cache_slots=8)
    p = SearchParams(nprobe=16, k=10)
    _check(tier.search(q, p), tidx.search(q, p), q)
    assert tier.cache.misses > 8 and tier.stats()["waves"] >= 2
    cap = tier.cache.capacity
    assert [t.shape for t in tier.cache.cache_arena] == [(9, cap // 4,
                                                          DIM)] * 4
    assert tier.cache.memory_bytes() == 4 * (9 * cap // 4 * DIM * 4
                                             + 9 * cap // 4 * 4 + 9 * 4)


def test_sharded_streaming_from_store_capacity_padding():
    """A ragged host store: the capacity pads up to a multiple of 8·N, the
    padding slots never answer, and the tier equals the single-device one
    on the same store."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((500, DIM)).astype(np.float32)
    ids = np.arange(500, dtype=np.uint64)
    cfg = IVFFlatConfig(dimension=DIM, nlist=8, dtype="float32",
                        train_iters=4)
    idx = IVFFlatIndex(cfg, device="cpu")
    idx.train(x)
    assigns = kmeans_assign(torch.from_numpy(x), idx.centroids,
                            idx.metric).numpy()
    store = HostListStore.from_assignments(x, ids, assigns, 8)
    tier = ShardedStreamingIVFFlatIndex(_mesh(8), store, idx.centroids, cfg,
                                        cache_slots=8, capacity=100)
    assert tier.cache.capacity == 128 and tier.cache.capacity % 64 == 0
    single = StreamingIVFFlatIndex.from_store(store, idx.centroids, cfg,
                                              cache_slots=8, device="cpu")
    q = x[:5] + 0.01 * rng.standard_normal((5, DIM)).astype(np.float32)
    p = SearchParams(nprobe=8, k=5)
    got = tier.search(q, p)
    _check(got, single.search(q, p), q)
    assert (got[1][:, 0] == np.arange(5)).all()
