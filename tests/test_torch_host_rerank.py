"""PyTorch port, the capacity tier: ``io_host/host_rerank.HostReranker``
against the JAX package's on the same stores, and the IVF-PQ host-rerank
surface (``attach_host_rerank``, ``load_ivf_pq_capacity``) against the JAX
package on snapshots written by either package (CPU). Each comparison runs
both packages on the same path: the numpy one (``use_native=False``) and
the fused C++ one (``use_native=True``; the same ``vdbhost.cc`` in both)."""

import os

import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import native as jnative
from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFPQConfig as JPQConfig,
    IVFPQIndex as JPQIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.io_host import (
    host_rerank as jhr,
)
from cuda_acceleratedvectordatabaseengine_tpu.io_host.streaming import (
    HostListStore as JStore,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu.storage import snapshot as jsnap
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host import (
    host_rerank as thr,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.io_host.streaming import (
    HostListStore,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.storage import (
    load_ivf_pq_capacity,
    save_ivf_pq,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

DIM, NLIST = 24, 8
RTOL = 1e-6          # the stated tolerance: distances within 1e-6 relative
METRICS = ["L2", "InnerProduct", "Cosine"]


@pytest.fixture(params=[False, True], ids=["numpy", "native"])
def use_native(request):
    """The rerank path both packages take. The JAX package turns a failed
    native build into its numpy path silently; that would compare two
    different paths, so its library must be there."""
    if request.param:
        assert jnative.available(), "the JAX package's native library"
    return request.param


def _same_path(rr, jrr, use_native):
    """Both rerankers ran every batch on the ``use_native`` path."""
    assert rr.use_native == jrr.use_native == use_native
    if use_native:
        assert rr.native_batches > 0 and rr.numpy_batches == 0
    else:
        assert rr.numpy_batches > 0 and rr.native_batches == 0


def _stores(rng, n, dtype, sparse_ids):
    """The same rows, ids and list assignment packed by both packages."""
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64)
    if sparse_ids:
        ids = (ids * 977 + 12345) * np.uint64(2**20)
    assigns = rng.integers(0, NLIST, n).astype(np.int64)
    anchors = None
    if dtype == "int8":
        anchors = np.stack([x[assigns == l].mean(0) for l in range(NLIST)])
    mine = HostListStore.from_assignments(x, ids, assigns, NLIST,
                                          dtype=dtype, anchors=anchors)
    theirs = JStore.from_assignments(x, ids, assigns, NLIST, dtype=dtype,
                                     anchors=anchors)
    return x, ids, mine, theirs


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("sparse_ids", [False, True])
def test_reranker_matches_jax(rng, metric, dtype, sparse_ids, use_native):
    """Same store, same shortlists (INVALID_ID padding, a fully padded row,
    an unknown id; k below, at and above the shortlist depth): the same
    distances within 1e-6 relative and the same ids up to ties."""
    x, ids, mine, theirs = _stores(rng, 400, dtype, sparse_ids)
    rr = thr.HostReranker(mine, use_native=use_native)
    jrr = jhr.HostReranker(theirs, use_native=use_native)
    assert (rr._inv is None) == sparse_ids == (jrr._inv is None)
    assert rr.nbytes() == jrr.nbytes()
    q = rng.standard_normal((9, DIM)).astype(np.float32)
    if metric == "Cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    cand = ids[rng.integers(0, len(ids), (9, 17))]
    cand[0, 2] = INVALID_ID
    cand[1, :] = INVALID_ID
    cand[2, 5] = np.uint64(10**9 + 7)
    for k in (5, 17, 20):
        d, got = rr.rerank(q, cand, Metric.parse(metric), k)
        jd, jgot = jrr.rerank(q, cand, JMetric.parse(metric), k)
        assert d.shape == (9, k) and got.dtype == np.uint64
        assert_topk_match(d, got, jd, jgot, rtol=RTOL)
        assert (got[1] == INVALID_ID).all()
    _same_path(rr, jrr, use_native)


def test_reranker_distances_are_exact_to_the_stored_point(rng, use_native):
    """L2 distances equal the direct computation from the dequantized
    int8 store (the JAX package's own check, on the port)."""
    x, ids, store, _ = _stores(rng, 300, "int8", False)
    rr = thr.HostReranker(store, use_native=use_native)
    deq = np.zeros_like(x)
    for l in range(NLIST):
        deq[store.ids[l].astype(np.int64)] = (
            store.anchors[l] + store.vectors[l] * store.scale[l][:, None])
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    cand = rng.integers(0, 300, (5, 12)).astype(np.uint64)
    d, got = rr.rerank(q, cand, Metric.L2, 4)
    for b in range(5):
        ref = ((q[b] - deq[cand[b].astype(np.int64)]) ** 2).sum(1)
        order = np.argsort(ref, kind="stable")[:4]
        np.testing.assert_allclose(d[b], ref[order], rtol=1e-4, atol=1e-4)
        assert set(got[b].tolist()) == set(cand[b][order].tolist())


def test_flatten_lists_is_zero_copy_over_one_backing_array():
    """Consecutive views of one buffer flatten without a copy (the
    persisted-store path), anything else concatenates; both as the JAX
    helper does."""
    base = np.arange(60, dtype=np.float32).reshape(20, 3)
    views = [base[0:4], base[4:4], base[4:11], base[11:20]]
    flat = thr._flatten_lists(views, (0, 3), np.float32)
    assert np.shares_memory(flat, base)
    np.testing.assert_array_equal(flat, jhr._flatten_lists(views, (0, 3),
                                                           np.float32))
    gapped = [base[0:4], base[5:9]]
    flat = thr._flatten_lists(gapped, (0, 3), np.float32)
    assert not np.shares_memory(flat, base)
    np.testing.assert_array_equal(flat, np.concatenate(gapped))
    assert thr._flatten_lists([base[:0]], (0, 3), np.float32).shape == (0, 3)


def test_preload_and_rows_of_ids(rng):
    _, ids, store, theirs = _stores(rng, 200, "int8", True)
    rr = thr.HostReranker(store)
    rr.preload(chunk_rows=64)
    probe = np.array([[ids[3], INVALID_ID, np.uint64(5), ids[199]]],
                     np.uint64)
    np.testing.assert_array_equal(
        rr._rows_of_ids(probe),
        jhr.HostReranker(theirs, use_native=False)._rows_of_ids(probe))
    assert (rr._rows_of_ids(probe)[0, 1:3] == -1).all()


# --------------------------------------------------------------------------- #
# IVF-PQ: attach_host_rerank and the capacity tier
# --------------------------------------------------------------------------- #

def _clustered(rng, n):
    centers = 2.0 * rng.standard_normal((NLIST, DIM)).astype(np.float32)
    return (centers[rng.integers(0, NLIST, n)]
            + rng.standard_normal((n, DIM))).astype(np.float32)


def _kw(metric="L2", opq=False):
    return dict(dimension=DIM, nlist=NLIST, m=4, keep_raw=False, opq=opq,
                opq_iters=2, train_iters=8, pq_train_sample=1024,
                metric=metric)


def _search_both(tidx, jidx, q, p):
    got = tidx.search(q, SearchParams(**p))
    want = jidx.search(q, JParams(**p))
    assert_topk_match(*got, *want, rtol=RTOL,
                      atol=RTOL * (q.astype(np.float64) ** 2).sum(1))
    return got


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("opq", [False, True])
def test_capacity_tier_loads_either_package_snapshot(tmp_path, rng, writer,
                                                     opq, use_native):
    """One keep_raw=False snapshot with host rows, written by either
    package, with OPQ and without: the port's ``load_ivf_pq_capacity``
    and the JAX package's load it alike (codes, host store bit for bit)
    and their reranked searches agree within 1e-6 relative."""
    x = _clustered(rng, 1500)
    ids = np.arange(1500, dtype=np.uint64) * 3 + 7
    path = str(tmp_path / "cap")
    perm = rng.permutation(1500)
    if writer == "jax":
        src = JPQIndex(JPQConfig(scan_impl="xla", **_kw(opq=opq)))
        src.train(x)
        src.add(x, ids)
        jsnap.save_ivf_pq(path, src, host_rows=(x[perm], ids[perm]))
    else:
        src = IVFPQIndex(IVFPQConfig(**_kw(opq=opq)), device="cpu")
        src.train(x)
        src.add(x, ids)
        save_ivf_pq(path, src, host_rows=(x[perm], ids[perm]))
    tidx = load_ivf_pq_capacity(path, rerank_k=48, device="cpu")
    jidx = jsnap.load_ivf_pq_capacity(path, rerank_k=48)
    jidx.config.scan_impl = "xla"
    jidx._host_rr.use_native = use_native
    tidx._host_rr.use_native = use_native
    assert tidx.read_only and tidx.raw is None
    assert (tidx.opq_R is not None) == opq
    np.testing.assert_array_equal(tidx._host_rr.ids, jidx._host_rr.ids)
    np.testing.assert_array_equal(tidx._host_rr.vecs, jidx._host_rr.vecs)
    np.testing.assert_array_equal(tidx._host_rr.scale, jidx._host_rr.scale)
    np.testing.assert_allclose(tidx._host_rr.anchors, jidx._host_rr.anchors,
                               rtol=1e-6, atol=1e-6)
    q = x[:10] + 0.3 * rng.standard_normal((10, DIM)).astype(np.float32)
    for rr in (False, True):
        d, got = _search_both(tidx, jidx, q,
                              dict(nprobe=4, k=10, use_exact_rerank=rr))
    # a stored row finds itself through the rerank
    d, got = tidx.search(x[:5], SearchParams(nprobe=NLIST, k=1,
                                             use_exact_rerank=True))
    assert (got[:, 0] == ids[:5]).all()
    _same_path(tidx._host_rr, jidx._host_rr, use_native)


@pytest.mark.parametrize("metric", METRICS)
def test_attached_rerank_matches_jax(rng, metric, use_native):
    """``attach_host_rerank`` on the same codes in both packages (the JAX
    index's state loaded into the port): the shortlist goes through the
    emit_full depth (rerank_k 64 > 32) and both packages' host stage."""
    x = _clustered(rng, 1500)
    jidx = JPQIndex(JPQConfig(scan_impl="xla", **_kw(metric)))
    jidx.train(x)
    jidx.add(x)
    tidx = _port_copy(jidx)
    assigns = _assignments(jidx)
    anchors = np.asarray(jidx.centroids)
    xs = x / np.linalg.norm(x, axis=1, keepdims=True) \
        if metric == "Cosine" else x
    ids = np.arange(1500, dtype=np.uint64)
    tidx.attach_host_rerank(HostListStore.from_assignments(
        xs, ids, assigns, NLIST, dtype="int8", anchors=anchors), rerank_k=64)
    jidx.attach_host_rerank(JStore.from_assignments(
        xs, ids, assigns, NLIST, dtype="int8", anchors=anchors), rerank_k=64)
    jidx._host_rr.use_native = use_native
    tidx._host_rr.use_native = use_native
    q = rng.standard_normal((12, DIM)).astype(np.float32)
    _search_both(tidx, jidx, q, dict(nprobe=NLIST, k=10,
                                     use_exact_rerank=True))
    _same_path(tidx._host_rr, jidx._host_rr, use_native)


def test_adaptive_margin_matches_jax(rng, use_native):
    """``margin``: a huge margin keeps every candidate (the fixed-depth
    result), a moderate one prunes the same candidates as the JAX package
    (``last_rerank_kept`` equal) and reranks to the same answer."""
    x = _clustered(rng, 1500)
    jidx = JPQIndex(JPQConfig(scan_impl="xla", **_kw()))
    jidx.train(x)
    jidx.add(x)
    tidx = _port_copy(jidx)
    assigns = _assignments(jidx)
    anchors = np.asarray(jidx.centroids)
    ids = np.arange(1500, dtype=np.uint64)
    store = HostListStore.from_assignments(x, ids, assigns, NLIST,
                                           dtype="int8", anchors=anchors)
    jstore = JStore.from_assignments(x, ids, assigns, NLIST, dtype="int8",
                                     anchors=anchors)
    q = rng.standard_normal((16, DIM)).astype(np.float32)
    p = SearchParams(nprobe=NLIST, k=10, use_exact_rerank=True)
    tidx.attach_host_rerank(store, rerank_k=64)
    fixed = tidx.search(q, p)
    tidx.attach_host_rerank(store, rerank_k=64, margin=1e6)
    wide = tidx.search(q, p)
    np.testing.assert_array_equal(fixed[1], wide[1])
    assert tidx.last_rerank_kept == 64.0
    tidx.attach_host_rerank(store, rerank_k=64, margin=0.05)
    jidx.attach_host_rerank(jstore, rerank_k=64, margin=0.05)
    jidx._host_rr.use_native = use_native
    tidx._host_rr.use_native = use_native
    _search_both(tidx, jidx, q, dict(nprobe=NLIST, k=10,
                                     use_exact_rerank=True))
    _same_path(tidx._host_rr, jidx._host_rr, use_native)
    assert tidx.last_rerank_kept < 64
    assert tidx.last_rerank_kept == pytest.approx(jidx.last_rerank_kept,
                                                  abs=0.5)


def _port_copy(jidx) -> IVFPQIndex:
    """The JAX index's codes and tables in a port index (through a
    snapshot, the way the engines share them)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        jsnap.save_ivf_pq(tmp, jidx)
        return IVFPQIndex.load(tmp, device="cpu")


def _assignments(jidx) -> np.ndarray:
    out = np.zeros(jidx.ntotal, np.int64)
    ids_tab = np.asarray(jidx.ids)
    lists, slots = np.nonzero(ids_tab != INVALID_ID)
    out[ids_tab[lists, slots].astype(np.int64)] = lists
    return out


def test_host_rerank_guards_and_warmup(rng, monkeypatch):
    """Adds are refused while a store is attached (they would be dropped
    by the rerank), removal stays allowed (a removed id never reaches the
    host stage), a resident raw arena refuses a store, and the warm-up
    also runs the reranked search."""
    x = _clustered(rng, 800)
    idx = IVFPQIndex(IVFPQConfig(**_kw()), device="cpu")
    idx.train(x)
    idx.add(x)
    store = HostListStore.from_assignments(
        x, np.arange(800, dtype=np.uint64), _assignments(idx), NLIST,
        dtype="int8", anchors=idx.centroids.numpy())
    idx.attach_host_rerank(store, rerank_k=40)
    with pytest.raises(RuntimeError, match="host-rerank"):
        idx.add(x[:3])
    with pytest.raises(RuntimeError, match="host-rerank"):
        idx.add_from_device(torch.from_numpy(x[:3]))
    assert idx.remove_ids(np.arange(5, dtype=np.uint64)) == 5
    _, got = idx.search(x[:5], SearchParams(nprobe=NLIST, k=5,
                                            use_exact_rerank=True))
    assert not np.isin(got, np.arange(5)).any()
    calls = []
    orig = thr.HostReranker.rerank
    monkeypatch.setattr(thr.HostReranker, "rerank",
                        lambda self, *a: calls.append(a[-1]) or orig(self,
                                                                     *a))
    idx.warmup_lists(batch_sizes=(1, 4), nprobes=(2,))
    assert len(calls) == 2
    raw = IVFPQIndex(IVFPQConfig(**{**_kw(), "keep_raw": True}),
                     device="cpu")
    raw.train(x)
    with pytest.raises(ValueError, match="keep_raw"):
        raw.attach_host_rerank(store)


def test_pipelined_batches_match_sequential(rng):
    x = _clustered(rng, 800)
    idx = IVFPQIndex(IVFPQConfig(**_kw()), device="cpu")
    idx.train(x)
    idx.add(x)
    idx.attach_host_rerank(HostListStore.from_assignments(
        x, np.arange(800, dtype=np.uint64), _assignments(idx), NLIST,
        dtype="int8", anchors=idx.centroids.numpy()), rerank_k=32)
    p = SearchParams(nprobe=4, k=5, use_exact_rerank=True)
    batches = [rng.standard_normal((6, DIM)).astype(np.float32)
               for _ in range(3)]
    seq = [idx.search(q, p) for q in batches]
    for (d1, i1), (d2, i2) in zip(seq, idx.search_batches_pipelined(batches,
                                                                    p)):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)


def test_capacity_loader_refuses_other_snapshots(tmp_path, rng):
    x = _clustered(rng, 600)
    idx = IVFPQIndex(IVFPQConfig(**{**_kw(), "keep_raw": True,
                                    "raw_dtype": "float32"}), device="cpu")
    idx.train(x)
    idx.add(x)
    idx.save(str(tmp_path / "raw"))
    with pytest.raises(ValueError, match="keep_raw"):
        load_ivf_pq_capacity(str(tmp_path / "raw"), device="cpu")
    bare = IVFPQIndex(IVFPQConfig(**_kw()), device="cpu")
    bare.train(x)
    bare.add(x)
    bare.save(str(tmp_path / "bare"))
    with pytest.raises(ValueError, match="host rows"):
        load_ivf_pq_capacity(str(tmp_path / "bare"), device="cpu")
    assert os.path.isfile(tmp_path / "bare" / "manifest.json")
