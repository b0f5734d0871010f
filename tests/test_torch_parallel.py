"""PyTorch port, ``parallel/``: the slot-striped sharded IVF-Flat and
IVF-PQ views, build on the mesh and data-parallel k-means, held against
the JAX package's sharded views on its 8-device CPU mesh (Pallas kernels in
interpret mode) and against the port's single-device search, on the same
state carried across. The port's mesh is ``make_mesh(devices=["cpu"] * N)``
(CPU)."""

import functools
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFFlatConfig as JConfig,
    IVFFlatIndex as JIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.models.ivf_pq import (
    IVFPQConfig as JPQConfig,
    IVFPQIndex as JPQIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu.parallel import (
    ShardedIVFFlatIndex as JSharded,
    ShardedIVFPQIndex as JShardedPQ,
    make_mesh as j_make_mesh,
    sharded_kmeans_fit as j_sharded_kmeans_fit,
    sharded_kmeans_lloyd_step as j_lloyd_step,
)
from cuda_acceleratedvectordatabaseengine_tpu.parallel.sharded import (
    _stripe_scan_capacity as j_stripe_scan_capacity,
    _striping_perm as j_striping_perm,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFFlatConfig,
    IVFFlatIndex,
    IVFPQConfig,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.convert import (
    ivf_flat_from_arrays,
    ivf_pq_from_arrays,
    sharded_ivf_flat_from_arrays,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel import (
    SHARD_AXIS,
    ShardedIVFFlatIndex,
    ShardedIVFPQIndex,
    make_mesh,
    sharded_kmeans_fit,
    sharded_kmeans_lloyd_step,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel.sharded import (
    _stripe_scan_capacity,
    _striping_perm,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

DIM = 16


def _mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _tol(q, metric):
    """fp32 sums in another order: a few ulps of ‖q‖² (of the unit query
    under cosine)."""
    if metric == "Cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return dict(rtol=1e-5, atol=1e-5 * (q * q).sum(1))


def _recall(found, truth):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / truth.shape[1]
                    for a, b in zip(found.astype(np.int64), truth)])


@functools.lru_cache(maxsize=None)
def _data(n=2000):
    rng = np.random.default_rng(11)
    centers = 2.0 * rng.standard_normal((16, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, 16, n)]
         + rng.standard_normal((n, DIM))).astype(np.float32)
    q = (x[rng.integers(0, n, 12)]
         + 0.3 * rng.standard_normal((12, DIM))).astype(np.float32)
    return x, q


def _carry_flat(jidx, cfg):
    a = jidx.arena
    opt = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    return ivf_flat_from_arrays(
        cfg, centroids=np.asarray(jidx.centroids),
        arena=np.asarray(a.arena), arena_sq=np.asarray(a.arena_sq),
        arena_scale=opt(a.arena_scale), anchors=opt(a.anchors),
        counts=np.asarray(a.counts), ids=a.ids, counts_max=a.counts_max,
        arena_lo=opt(a.arena_lo), device="cpu",
    )


@functools.lru_cache(maxsize=None)
def _flat_pair(metric, dtype, store_residuals=False):
    """A JAX IVF-Flat index and the port's index on the same state."""
    x, _ = _data()
    kw = dict(dimension=DIM, nlist=16, metric=metric, dtype=dtype,
              train_iters=6, store_residuals=store_residuals)
    jidx = JIndex(JConfig(**kw))
    jidx.train(x)
    if dtype == "int8":
        jidx.build_from_device(jnp.asarray(x))
    else:
        jidx.add(x)
    return jidx, kw


def _port_flat(metric, dtype, store_residuals=False, scan_impl="auto"):
    jidx, kw = _flat_pair(metric, dtype, store_residuals)
    return _carry_flat(jidx, IVFFlatConfig(**kw, scan_impl=scan_impl))


# ---------------------------------------------------------------------- #
# striping helpers and the mesh
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("cap,n", [(128, 1), (256, 2), (256, 8), (384, 4),
                                   (1408, 4), (3328, 8)])
def test_striping_perm_and_stripe_capacity_match_jax(cap, n):
    perm = _striping_perm(cap, n)
    np.testing.assert_array_equal(perm, j_striping_perm(cap, n))
    assert sorted(perm.tolist()) == list(range(cap))
    for counts_max in (None, 0, 1, 127, 300, cap // 2, cap - 1, cap):
        assert (_stripe_scan_capacity(counts_max, cap, n)
                == j_stripe_scan_capacity(counts_max, cap, n))


def test_make_mesh_devices_and_refusals():
    mesh = _mesh(4)
    assert mesh.devices.size == 4 and mesh.size == 4
    assert mesh.axis_names == (SHARD_AXIS,) and SHARD_AXIS == "shard"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh(2)
    else:
        with pytest.raises(ValueError, match="requested"):
            make_mesh(torch.cuda.device_count() + 1)


# ---------------------------------------------------------------------- #
# the sharded flat view
# ---------------------------------------------------------------------- #

# (scan_impl, dtype, metric, N): every scan name on both arena kinds, and
# every metric and both mesh sizes among them
FLAT_CASES = [
    ("gather", "float32", "L2", 2), ("gather", "int8", "Cosine", 8),
    ("pallas", "float32", "InnerProduct", 8), ("pallas", "int8", "L2", 2),
    ("pallas_sorted", "float32", "Cosine", 2),
    ("pallas_sorted", "int8", "InnerProduct", 8),
    ("pallas_grouped", "float32", "L2", 8),
    ("pallas_grouped", "int8", "L2", 2),
    ("ragged", "float32", "InnerProduct", 2), ("ragged", "int8", "L2", 8),
]


@pytest.mark.parametrize("impl,dtype,metric,n", FLAT_CASES,
                         ids=["-".join(map(str, c)) for c in FLAT_CASES])
def test_sharded_flat_matches_jax_and_single_device(impl, dtype, metric, n):
    """Tolerance: fp32 sums in another order (``_tol``), ids equal up to
    ties at the k-th place."""
    jidx, _ = _flat_pair(metric, dtype)
    tidx = _port_flat(metric, dtype)
    _, q = _data()
    params = dict(nprobe=8, k=10)
    view = ShardedIVFFlatIndex(tidx, _mesh(n), scan_impl=impl)
    got = view.search(q, SearchParams(**params))
    jview = JSharded(jidx, j_make_mesh(n), scan_impl=impl)
    assert view.global_cap == jview.global_cap
    assert_topk_match(*got, *jview.search(q, JParams(**params)),
                      **_tol(q, metric))
    tidx.config.scan_impl = impl
    assert_topk_match(*got, *tidx.search(q, SearchParams(**params)),
                      **_tol(q, metric))


def test_sharded_flat_deep_k_and_device_tensors():
    """k 100 (above K1's 64) through the grouped name, the device hook,
    one stripe per shard with 1/N of the slots, and a one-shard view that
    publishes the base arena itself (no copy)."""
    tidx = _port_flat("L2", "float32")
    _, q = _data()
    view = ShardedIVFFlatIndex(tidx, _mesh(4), scan_impl="pallas_grouped")
    p = SearchParams(nprobe=16, k=100)
    got = view.search(q, p)
    assert_topk_match(*got, *tidx.search(q, p), **_tol(q, "L2"))
    d_dev, pos_dev = view.search_device(torch.from_numpy(q), p)
    pos = pos_dev.numpy()
    ids = view._ids_table.reshape(-1)[np.clip(pos, 0, None)]
    ids[pos < 0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    np.testing.assert_array_equal(ids, got[1])
    np.testing.assert_array_equal(d_dev.numpy(), got[0])
    cap = tidx.arena.capacity
    assert [t.shape[1] for t in view.arena_s] == [cap // 4] * 4
    # shard s holds logical slots s, s + 4, ...
    np.testing.assert_array_equal(view.arena_s[3].numpy(),
                                  tidx.arena.arena[:, 3::4].numpy())
    one = ShardedIVFFlatIndex(tidx, _mesh(1))
    assert one.arena_s[0].data_ptr() == tidx.arena.arena.data_ptr()
    assert one.counts[0].data_ptr() != tidx.arena.counts.data_ptr()


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("op", ["add", "remove"])
def test_sharded_flat_refresh_after_add_and_remove(op, n):
    """Mutations through the view re-publish the stripes: the view equals
    the base searched alone (the same rows in other slots: fp32 ties)."""
    x, q = _data()
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=8,
                                     dtype="float32", train_iters=4),
                       device="cpu")
    idx.train(x)
    idx.add(x[:1000], np.arange(1000, dtype=np.uint64))
    view = ShardedIVFFlatIndex(idx, _mesh(n))
    p = SearchParams(nprobe=8, k=10)
    if op == "add":
        view.add(x[1000:], np.arange(1000, 2000, dtype=np.uint64))
        assert view.ntotal == 2000
    else:
        victims = np.arange(0, 1000, 3, dtype=np.uint64)
        assert view.remove_ids(victims) == victims.size
        assert not np.isin(view.search(x[:50], p)[1], victims).any()
    assert_topk_match(*view.search(q, p), *idx.search(q, p),
                      **_tol(q, "L2"))


def test_memory_stats_have_the_jax_keys():
    jidx, _ = _flat_pair("L2", "float32")
    tidx = _port_flat("L2", "float32")
    j = JSharded(jidx, j_make_mesh(2)).memory_stats()
    t = ShardedIVFFlatIndex(tidx, _mesh(2)).memory_stats()
    assert set(t) == set(j)
    for key in ("total_vectors", "nlist", "n_shards", "capacity_per_list"):
        assert t[key] == j[key], key
    assert t["striped_bytes"] > 0 and t["total_bytes"] > t["base_bytes"]
    jpq = _pq_jax("L2", False)
    tpq = _carry_pq(jpq, IVFPQConfig(**_pq_kw("L2", False)))
    assert set(ShardedIVFPQIndex(tpq, _mesh(2)).memory_stats()) == set(
        JShardedPQ(jpq, j_make_mesh(2)).memory_stats())


@pytest.mark.parametrize("n", [1, 4])
def test_memory_stats_count_each_storage_once(n):
    """A one-shard view publishes the base arena with no copy and counts
    none of it again; on more shards each stripe is a copy, counted once,
    while the replicas on the base's device are the base's own tensors."""
    tidx = _port_flat("L2", "int8")
    view = ShardedIVFFlatIndex(tidx, _mesh(n))
    st = view.memory_stats()
    arena = tidx.arena
    stripes = sum(t.numel() * t.element_size()
                  for t in (arena.arena, arena.arena_sq, arena.arena_scale))
    assert st["base_bytes"] == tidx.memory_stats()["total_bytes"]
    assert st["striped_bytes"] == (0 if n == 1 else stripes)
    assert st["total_bytes"] == st["base_bytes"] + st["striped_bytes"]


@pytest.mark.parametrize("metric,n", [("L2", 1), ("L2", 2), ("Cosine", 2)])
def test_sharded_flat_view_reranks_as_the_single_device(metric, n):
    """The port's sharded flat view stripes the lo plane and answers a
    ``use_exact_rerank`` search as the single-device index does (ids up to
    ties, the scans' tolerance), at 1 and 2 shards; the lo stripes count
    once in ``memory_stats``. The JAX package's view keeps the reference
    fault: it never stripes the lo plane and ignores the request, while
    its single-device index reranks."""
    jidx, _ = _flat_pair(metric, "int8", store_residuals=True)
    tidx = _port_flat(metric, "int8", store_residuals=True)
    _, q = _data()
    plain = dict(nprobe=8, k=10)
    rr = dict(nprobe=8, k=10, use_exact_rerank=True)
    view = ShardedIVFFlatIndex(tidx, _mesh(n))
    got = view.search(q, SearchParams(**rr))
    assert_topk_match(*got, *tidx.search(q, SearchParams(**rr)),
                      **_tol(q, metric))
    assert np.abs(got[0] - view.search(q, SearchParams(**plain))[0]).max() \
        > 1e-4
    arena = tidx.arena
    stripes = sum(t.numel() * t.element_size()
                  for t in (arena.arena, arena.arena_sq, arena.arena_scale,
                            arena.arena_lo))
    assert view.memory_stats()["striped_bytes"] == (0 if n == 1
                                                     else stripes)
    jview = JSharded(jidx, j_make_mesh(2))
    a, b = jview.search(q, JParams(**plain)), jview.search(q, JParams(**rr))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert np.abs(jidx.search(q, JParams(**plain))[0]
                  - jidx.search(q, JParams(**rr))[0]).max() > 1e-4


def test_build_on_mesh_stripes_the_lo_plane_for_rerank():
    """A mesh-built view of a ``store_residuals`` config fills the lo
    plane's stripes: its reranked distances are those to the original
    rows in float64, within the scans' tolerance, where the scan's own
    distances (to the int8 rows) are not."""
    x, q = _data()
    cfg = IVFFlatConfig(dimension=DIM, nlist=8, dtype="int8",
                        store_residuals=True, train_sample_per_list=64,
                        train_iters=6)
    view = ShardedIVFFlatIndex.build_on_mesh(
        _mesh(4), cfg, torch.from_numpy(x), chunk_rows=512,
        generator=torch.Generator().manual_seed(3))
    assert view.arena_lo_s is not None and len(view.arena_lo_s) == 4
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    atol = _tol(q, "L2")["atol"][:, None]

    def off(params):
        d, ids = view.search(q, params)
        exact = ((q64[:, None] - x64[ids.astype(np.int64)]) ** 2).sum(-1)
        return np.abs(d - exact) / (1e-5 * exact + atol)

    assert off(SearchParams(nprobe=8, k=10, use_exact_rerank=True)).max() \
        <= 1.0
    assert off(SearchParams(nprobe=8, k=10)).max() > 1.0


@pytest.mark.parametrize("n", [1, 4])
def test_search_concurrent_with_add_and_remove(n):
    """A serving thread beside removals and adds through the view: every
    (id, distance) it returns is the distance to that id's row (fp32
    arena: the stored row is the row), within the fp32 tolerance."""
    x, q = _data()
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=8,
                                     dtype="float32", train_iters=4),
                       device="cpu")
    idx.train(x)
    idx.add(x[:1200], np.arange(1200, dtype=np.uint64))
    view = ShardedIVFFlatIndex(idx, _mesh(n), scan_impl="pallas_grouped")
    stop = threading.Event()
    results, errors = [], []

    def serve():
        try:
            while not stop.is_set():
                results.append(view.search(q, SearchParams(nprobe=8, k=10)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=serve)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the two threads finely
    t.start()
    try:
        # remove a seventh of the rows and add them back, until the
        # serving thread has searched beside several mutations (≤ 60 s)
        deadline = time.monotonic() + 60
        r = 0
        while (r < 10 or len(results) < 20) and time.monotonic() < deadline:
            ids = np.arange(r % 7, 1200, 7, dtype=np.uint64)
            assert view.remove_ids(ids) == ids.size
            view.add(x[ids.astype(np.int64)], ids)
            r += 1
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    assert not errors, errors
    assert len(results) >= 20
    q64 = q.astype(np.float64)
    for d, ids in results:
        ok = ids != np.uint64(0xFFFFFFFFFFFFFFFF)
        rows = x[ids[ok].astype(np.int64)].astype(np.float64)
        qs = np.broadcast_to(q64[:, None], d.shape + (DIM,))[ok]
        exact = ((qs - rows) ** 2).sum(1)
        tol = 1e-5 * exact + 1e-5 * (qs * qs).sum(1)
        assert (np.abs(d[ok] - exact) <= tol).all()


# ---------------------------------------------------------------------- #
# build on the mesh and data-parallel k-means
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_build_on_mesh_gives_the_jax_stripes(dtype):
    """With the same centroids: the JAX package's global_cap, counts and
    id table exactly; the stripes in physical order, int8 codes within 1
    on ≤ 0.1% of entries (a rounding tie), scales rtol 1e-6, norms and
    fp32 rows rtol 1e-5; the JAX stripes carried across search as the JAX
    view does."""
    x, q = _data()
    jidx, kw = _flat_pair("L2", dtype)
    jview = JSharded.build_on_mesh(j_make_mesh(8), jidx.config, x,
                                   centroids=jidx.centroids, chunk_rows=700)
    cfg = IVFFlatConfig(**kw)
    view = ShardedIVFFlatIndex.build_on_mesh(
        _mesh(8), cfg, x, centroids=np.asarray(jidx.centroids),
        chunk_rows=700)
    assert view.global_cap == jview.global_cap
    np.testing.assert_array_equal(view.counts[0].numpy(),
                                  np.asarray(jview.counts))
    np.testing.assert_array_equal(view._ids_table, jview._ids_table)
    # the JAX pack diverts every foreign row to its stripes' last slot
    # (TRASH); the port writes nothing there: compare the other slots
    cap_l = view.global_cap // 8
    keep = np.arange(view.global_cap) % cap_l != cap_l - 1

    def both(port_parts, jax_array):
        return (torch.cat(port_parts, 1).numpy()[:, keep],
                np.asarray(jax_array)[:, keep])

    arena, j_arena = both(view.arena_s, jview.arena_s)
    if dtype == "int8":
        diff = np.abs(arena.astype(np.int32) - j_arena.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_allclose(*both(view.arena_scale,
                                         jview.arena_scale), rtol=1e-6)
    else:
        np.testing.assert_allclose(arena, j_arena, rtol=1e-5)
    np.testing.assert_allclose(*both(view.arena_sq_s, jview.arena_sq_s),
                               rtol=1e-5, atol=1e-5)
    j_arena = np.asarray(jview.arena_s)
    p = dict(nprobe=8, k=10)
    ref = jview.search(q, JParams(**p))
    assert_topk_match(*view.search(q, SearchParams(**p)), *ref,
                      **_tol(q, "L2"))
    carried = sharded_ivf_flat_from_arrays(
        cfg, _mesh(8), arena_s=j_arena,
        arena_sq_s=np.asarray(jview.arena_sq_s),
        arena_scale=(np.asarray(jview.arena_scale) if jview.has_scale
                     else None),
        anchors=(np.asarray(jview.arena_anchors) if jview.has_anchor
                 else None),
        centroids=np.asarray(jview.centroids),
        counts=np.asarray(jview.counts), ids=jview._ids_table,
        global_cap=jview.global_cap, scan_impl="pallas_grouped")
    assert carried.read_only and carried.ntotal == x.shape[0]
    assert_topk_match(*carried.search(q, SearchParams(**p)), *ref,
                      **_tol(q, "L2"))


def test_build_on_mesh_trains_packs_and_finds_every_row():
    """Train, pack and search on the mesh with no single-device index:
    every row finds itself, and the view is read-only."""
    x, _ = _data()
    cfg = IVFFlatConfig(dimension=DIM, nlist=8, dtype="int8",
                        train_sample_per_list=64, train_iters=6)
    view = ShardedIVFFlatIndex.build_on_mesh(
        _mesh(8), cfg, torch.from_numpy(x), chunk_rows=512,
        generator=torch.Generator().manual_seed(3))
    d, ids = view.search(x[:16], SearchParams(nprobe=8, k=5))
    assert (ids[:, 0] == np.arange(16)).all()
    assert (d[:, 0] < 1e-2).all()
    assert view.read_only and view.ntotal == x.shape[0]
    with pytest.raises(PermissionError):
        view.add(x[:2])


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_lloyd_step_matches_jax(n):
    """One data-parallel Lloyd step equals the JAX step (atol 1e-4),
    with padding rows that join no cluster: zero rows in the JAX package,
    rows of weight 0 in the port."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((512, DIM)).astype(np.float32)
    x[-8:] = 0.0                                   # padding rows
    weight = np.ones(512, np.float32)
    weight[-8:] = 0.0
    c0 = x[:8].copy()
    jm = j_make_mesh(n)
    ref = np.asarray(j_lloyd_step(
        jm, jax.device_put(jnp.asarray(x), NamedSharding(jm, P("shard",
                                                                None))),
        jnp.asarray(c0), 8))
    got = sharded_kmeans_lloyd_step(_mesh(n), torch.from_numpy(x), c0, 8,
                                    weight=torch.from_numpy(weight))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_sharded_lloyd_step_counts_real_zero_rows():
    """Without a weight every row counts, a real all-zero row too: it
    pulls its cluster's centroid toward the origin (the JAX step drops
    it); weighted out, it does not."""
    rng = np.random.default_rng(6)
    x = (1.0 + rng.random((64, DIM))).astype(np.float32)
    x[::8] = 0.0                                   # real zero vectors
    c0 = np.stack([np.zeros(DIM), np.full(DIM, 1.5)]).astype(np.float32)
    got = sharded_kmeans_lloyd_step(_mesh(4), torch.from_numpy(x), c0, 2)
    np.testing.assert_array_equal(got[0].numpy(), np.zeros(DIM))
    np.testing.assert_allclose(got[1].numpy(),
                               np.delete(x, np.s_[::8], 0).mean(0),
                               rtol=1e-5)
    w = torch.ones(64)
    w[::8] = 0.0
    dropped = sharded_kmeans_lloyd_step(_mesh(4), torch.from_numpy(x), c0,
                                        2, weight=w)
    np.testing.assert_array_equal(dropped[0].numpy(), c0[0])   # empty


def test_build_on_mesh_trains_zero_vectors_and_masks_padding(monkeypatch):
    """The mesh build hands its trainer a 0 / 1 weight for the padding
    rows (the sample padded from 1801 to 1808 rows over 8 shards), and a
    cluster of real zero vectors gets its centroid at the origin, where
    the zero query finds them at distance 0."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.parallel import (
        sharded as sharded_mod,
    )

    rng = np.random.default_rng(4)
    centers = 3.0 * rng.standard_normal((7, DIM))
    x = centers[rng.integers(0, 7, 1500)] + 0.2 * rng.standard_normal(
        (1500, DIM))
    x = np.concatenate([x, np.zeros((301, DIM))]).astype(np.float32)
    ids = rng.permutation(x.shape[0])
    x = x[np.argsort(ids)]                       # zero rows spread out
    zero_ids = np.flatnonzero(~x.any(1))
    seen = {}
    real_fit = sharded_mod.sharded_kmeans_fit

    def fit(mesh, gen, sample, k, **kw):
        seen["rows"], seen["weight"] = sample.shape[0], kw["weight"].clone()
        return real_fit(mesh, gen, sample, k, **kw)

    monkeypatch.setattr(sharded_mod, "sharded_kmeans_fit", fit)
    cfg = IVFFlatConfig(dimension=DIM, nlist=8, dtype="float32",
                        train_sample_per_list=512, train_iters=8)
    view = ShardedIVFFlatIndex.build_on_mesh(
        _mesh(8), cfg, x, generator=torch.Generator().manual_seed(0))
    w = seen["weight"].numpy()
    assert seen["rows"] == 1808 and w.sum() == 1801
    assert (w[-7:] == 0).all()
    assert np.linalg.norm(view.centroids.numpy(), axis=1).min() < 1e-6
    d, found = view.search(np.zeros((1, DIM), np.float32),
                           SearchParams(nprobe=1, k=10))
    assert (d == 0).all() and np.isin(found, zero_ids).all()


def test_sharded_kmeans_fit_inertia_near_jax():
    """Data-parallel training on clustered data: inertia within 2% of the
    JAX package's data-parallel trainer (the two draw different random
    numbers, so centroids are compared by quality)."""
    rng = np.random.default_rng(9)
    k, per = 16, 150
    centers = 4 * rng.standard_normal((k, DIM)).astype(np.float32)
    x = (np.repeat(centers, per, 0)
         + 0.3 * rng.standard_normal((k * per, DIM))).astype(np.float32)
    rng.shuffle(x)

    def inertia(c):
        c = np.asarray(c, np.float64)
        return ((x[:, None].astype(np.float64) - c[None]) ** 2).sum(
            -1).min(1).mean()

    jm = j_make_mesh(8)
    c_j = j_sharded_kmeans_fit(
        jm, jax.random.PRNGKey(0),
        jax.device_put(jnp.asarray(x), NamedSharding(jm, P("shard", None))),
        k, iters=12)
    c_t = sharded_kmeans_fit(_mesh(8), torch.Generator().manual_seed(0),
                             torch.from_numpy(x), k, iters=12)
    assert c_t.shape == (k, DIM)
    assert inertia(c_t) <= inertia(c_j) * 1.02


# ---------------------------------------------------------------------- #
# the sharded IVF-PQ view
# ---------------------------------------------------------------------- #

def _pq_kw(metric, opq):
    return dict(dimension=DIM, nlist=8, m=4, metric=metric, opq=opq,
                opq_iters=2, pq_train_sample=2048, train_iters=6)


@functools.lru_cache(maxsize=None)
def _pq_jax(metric, opq):
    x, _ = _data()
    idx = JPQIndex(JPQConfig(**_pq_kw(metric, opq)))
    idx.train(x)
    idx.add(x)
    return idx


def _carry_pq(jidx, cfg):
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


PQ_CASES = [("L2", False, 2), ("L2", False, 8), ("InnerProduct", False, 2),
            ("Cosine", False, 8), ("L2", True, 4)]


@pytest.mark.parametrize("metric,opq,n", PQ_CASES,
                         ids=["-".join(map(str, c)) for c in PQ_CASES])
def test_sharded_pq_adc_matches_jax_and_single_device(metric, opq, n):
    """ADC only: the port's sharded K2 path equals the JAX sharded view
    and the port's single-device K2 path (tie-aware, ``_tol``)."""
    jidx = _pq_jax(metric, opq)
    tidx = _carry_pq(jidx, IVFPQConfig(**_pq_kw(metric, opq),
                                       scan_impl="pallas"))
    _, q = _data()
    p = dict(nprobe=6, k=10)
    got = ShardedIVFPQIndex(tidx, _mesh(n)).search(q, SearchParams(**p))
    assert_topk_match(*got, *JShardedPQ(jidx, j_make_mesh(n)).search(
        q, JParams(**p)), **_tol(q, metric))
    assert_topk_match(*got, *tidx.search(q, SearchParams(**p)),
                      **_tol(q, metric))


@pytest.mark.parametrize("metric,opq", [("L2", False), ("L2", True),
                                        ("Cosine", False)])
def test_sharded_pq_rerank_recall_at_least_single_device(metric, opq,
                                                         oracle):
    """Each shard reranks its own top-rerank_k, so the merged pool is a
    superset of one device's: recall ≥ the single device's, every sorted
    distance ≤ the one-shard view's (+1e-4), and the head equals the JAX
    sharded view's."""
    jidx = _pq_jax(metric, opq)
    tidx = _carry_pq(jidx, IVFPQConfig(**_pq_kw(metric, opq),
                                       scan_impl="pallas"))
    x, q = _data()
    p = dict(nprobe=8, k=10, use_exact_rerank=True)
    got = ShardedIVFPQIndex(tidx, _mesh(4)).search(q, SearchParams(**p))
    one = ShardedIVFPQIndex(tidx, _mesh(1)).search(q, SearchParams(**p))
    single = tidx.search(q, SearchParams(**p))
    _, truth = oracle(q, x, 10, metric)
    assert _recall(got[1], truth) >= _recall(single[1], truth) - 1e-9
    assert (got[0] <= one[0] + 1e-4).all()
    jgot = JShardedPQ(jidx, j_make_mesh(4)).search(q, JParams(**p))
    np.testing.assert_array_equal(got[1][:, 0], jgot[1][:, 0])
    np.testing.assert_allclose(got[0][:, 0], jgot[0][:, 0], rtol=1e-4,
                               atol=1e-4)


def test_sharded_pq_refresh_and_lifecycle():
    """Removal through the PQ view re-publishes codes, raw rows and ids:
    removed ids never return; the view equals its base's K2 path."""
    x, q = _data()
    jidx = _pq_jax("L2", False)
    tidx = _carry_pq(jidx, IVFPQConfig(**_pq_kw("L2", False),
                                       scan_impl="pallas"))
    view = ShardedIVFPQIndex(tidx, _mesh(4))
    victims = np.arange(0, 2000, 5, dtype=np.uint64)
    assert view.remove_ids(victims) == victims.size
    p = SearchParams(nprobe=8, k=10)
    got = view.search(x[:40], p)
    assert not np.isin(got[1], victims).any()
    assert_topk_match(*got, *tidx.search(x[:40], p), **_tol(x[:40], "L2"))
    assert view.ntotal == 2000 - victims.size
    view.warmup_lists(batch_sizes=(1, 3), nprobes=(2,))
