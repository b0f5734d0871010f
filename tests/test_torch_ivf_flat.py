"""PyTorch port, the IVF-Flat slice as a whole: a JAX-built index carried
across searches the same in both packages; the port's own train / build /
search reaches the JAX tests' recall bars; API edges (CPU)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFFlatConfig as JConfig,
    IVFFlatIndex as JIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops import pallas_scan
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.arena import (
    INVALID_ID,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.convert import (
    ivf_flat_from_arrays,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

DIM, NLIST = 32, 16


def _recall(found_ids, true_ids):
    hits = sum(len(set(f.tolist()) & set(t.tolist()))
               for f, t in zip(found_ids, true_ids))
    return hits / true_ids.size


def _clustered(rng, n, dim=DIM, modes=NLIST):
    centers = 2.0 * rng.standard_normal((modes, dim)).astype(np.float32)
    x = centers[rng.integers(0, modes, n)] + rng.standard_normal(
        (n, dim)).astype(np.float32)
    return x


def _carry(jidx, cfg):
    a = jidx.arena
    opt = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    return ivf_flat_from_arrays(
        cfg, centroids=np.asarray(jidx.centroids), arena=np.asarray(a.arena),
        arena_sq=np.asarray(a.arena_sq), arena_scale=opt(a.arena_scale),
        anchors=opt(a.anchors), counts=np.asarray(a.counts), ids=a.ids,
        counts_max=a.counts_max, device="cpu",
    )


@pytest.mark.parametrize("dtype,metric", [
    ("int8", "L2"), ("bfloat16", "L2"), ("float32", "InnerProduct"),
    ("float32", "Cosine"),
])
def test_carried_index_searches_like_jax(rng, monkeypatch, dtype, metric):
    """(a) JAX trains and builds (append_balanced, two chunks); the state
    is carried across and both packages search the same queries."""
    # The JAX main-path scan is the Pallas grouped kernel; on the CPU it
    # runs in interpret mode (as in tests/test_pallas_scan.py).
    monkeypatch.setattr(
        pallas_scan, "scan_probed_lists_pallas_grouped",
        functools.partial(pallas_scan.scan_probed_lists_pallas_grouped,
                          interpret=True),
    )
    x = _clustered(rng, 3000)
    kw = dict(dimension=DIM, nlist=NLIST, metric=metric, dtype=dtype,
              train_iters=10)
    jidx = JIndex(JConfig(scan_impl="pallas_grouped", **kw))
    jidx.train(x)
    cap = 384
    jidx.append_balanced(jnp.asarray(x[:1500]), capacity=cap)
    jidx.append_balanced(jnp.asarray(x[1500:]),
                         ids=np.arange(1500, 3000, dtype=np.uint64) + 10**12)
    tidx = _carry(jidx, IVFFlatConfig(**kw))
    assert tidx.ntotal == jidx.ntotal == 3000
    q = x[rng.choice(3000, 24, replace=False)] + 0.3 * rng.standard_normal(
        (24, DIM)).astype(np.float32)
    atol = 1e-5 if metric == "Cosine" else 1e-5 * (q * q).sum(1)
    for nprobe in (4, NLIST):
        p = dict(nprobe=nprobe, k=10)
        ref = jidx.search(q, JParams(**p))
        refs = [ref]
        if dtype != "bfloat16":
            # the JAX gather scan is fp32-exact except on bf16 arenas
            # (where it rounds the query to bf16)
            jidx.config.scan_impl = "gather"
            refs.append(jidx.search(q, JParams(**p)))
            jidx.config.scan_impl = "pallas_grouped"
        for impl in ("auto", "grouped"):
            tidx.config.scan_impl = impl
            got = tidx.search(q, SearchParams(**p))
            for r in refs:
                assert_topk_match(*got, *r, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_port_recall_full_probe_is_exact(rng, oracle, metric):
    """(b) the port's own train + add + search: exact at full probe."""
    x = rng.standard_normal((4000, DIM)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                     metric=metric, dtype="float32"),
                       device="cpu")
    idx.train(x)
    idx.add(x)
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=NLIST, k=10))
    _, ref = oracle(q, x, 10, metric)
    assert _recall(ids, ref.astype(np.uint64)) == 1.0
    assert (np.diff(d, axis=1) >= -1e-6).all()


@pytest.mark.parametrize("scan_impl", ["auto", "grouped"])
def test_port_bfloat16_and_int8_recall(rng, oracle, scan_impl):
    """(b) bf16 storage keeps top-10 recall > 0.95 (the JAX bar); the int8
    residual arena clears it too on the same data."""
    x = rng.standard_normal((4000, DIM)).astype(np.float32)
    q = rng.standard_normal((10, DIM)).astype(np.float32)
    _, ref = oracle(q, x, 10)
    for dtype in ("bfloat16", "int8"):
        idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                         dtype=dtype, scan_impl=scan_impl),
                           device="cpu")
        idx.train(x)
        idx.add(x)
        _, ids = idx.search(q, SearchParams(nprobe=NLIST, k=10))
        assert _recall(ids, ref.astype(np.uint64)) > 0.95, dtype


def test_build_from_device_matches_jax(rng):
    """The one-shot bulk build packs the same arena as the JAX package's
    from the same centroids."""
    x = _clustered(rng, 2000)
    kw = dict(dimension=DIM, nlist=NLIST, dtype="int8", train_iters=5)
    jidx = JIndex(JConfig(**kw))
    jidx.train(x)
    jidx.build_from_device(jnp.asarray(x))
    tidx = IVFFlatIndex(IVFFlatConfig(**kw), device="cpu")
    tidx.centroids = torch.from_numpy(np.array(jidx.centroids))
    tidx.trained = True
    tidx._publish_anchors()
    tidx.build_from_device(torch.from_numpy(x))
    ja, ta = jidx.arena, tidx.arena
    assert ta.capacity == ja.capacity and ta.counts_max == ja.counts_max
    np.testing.assert_array_equal(ta.counts.numpy(), np.asarray(ja.counts))
    np.testing.assert_array_equal(ta.ids, ja.ids)
    diff = np.abs(ta.arena.numpy().astype(int) - np.asarray(ja.arena))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    np.testing.assert_allclose(ta.arena_sq.numpy(), np.asarray(ja.arena_sq),
                               rtol=1e-5, atol=1e-5)


def test_append_balanced_keeps_capacity_clamp(rng):
    """(c) a chunked build never grows the arena past the fixed capacity:
    overflow rows spill to next-nearest lists instead."""
    x = _clustered(rng, 3000)
    x[:1200] = x[0] + 0.01 * rng.standard_normal((1200, DIM)).astype(
        np.float32)                                  # one overfull mode
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                     dtype="int8", train_iters=10),
                       device="cpu")
    idx.train(x)
    cap = 256
    idx.append_balanced(torch.from_numpy(x[:1500]), capacity=cap)
    idx.append_balanced(torch.from_numpy(x[1500:]))
    counts = idx.arena.counts.numpy()
    assert idx.arena.capacity == cap and counts.max() <= cap
    assert counts.sum() == 3000 == idx.ntotal
    ids = idx.arena.ids[idx.arena.ids != INVALID_ID]
    np.testing.assert_array_equal(np.sort(ids), np.arange(3000))
    _, found = idx.search(x[1500:1505], SearchParams(nprobe=NLIST, k=1))
    np.testing.assert_array_equal(found[:, 0], np.arange(1500, 1505))


def test_calibrate_nprobe_meets_target(oracle):
    """(c) the bar of the JAX package's calibration test."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((8000, DIM)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=32,
                                     dtype="float32"), device="cpu")
    idx.train(x)
    idx.add(x)
    q = rng.standard_normal((64, DIM)).astype(np.float32)
    rep = idx.calibrate_nprobe(queries=q, target_coverage=0.9, k=10)
    assert rep["nprobe"] >= 1 and rep["coverage"] >= 0.9
    assert idx.calibrated_nprobe == rep["nprobe"]
    ps = sorted(rep["curve"])
    vals = [rep["curve"][p] for p in ps]
    assert all(b >= a - 1e-9 for a, b in zip(vals, vals[1:]))
    assert rep["curve"][32] == 1.0
    _, ids = idx.search(q, SearchParams(nprobe=0, k=10))
    _, ref = oracle(q, x, 10)
    assert _recall(ids, ref.astype(np.uint64)) >= 0.85
    rep2 = idx.calibrate_nprobe(sample=64, target_coverage=0.9)
    assert rep2["sample"] == 64 and 1 <= rep2["nprobe"] <= 32


def test_custom_ids_query_shapes_and_errors(rng):
    """(c) uint64 ids round-trip, a 1-D query works, misuse raises."""
    x = rng.standard_normal((600, DIM)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=8, dtype="int8"),
                       device="cpu")
    with pytest.raises(RuntimeError):
        idx.search(x[:2])
    with pytest.raises(RuntimeError):
        idx.add(x)
    with pytest.raises(RuntimeError):
        idx.calibrate_nprobe()
    with pytest.raises(ValueError):
        idx.train(x[:4])
    idx.train(x)
    big = np.arange(600, dtype=np.uint64) + np.uint64(2**63)
    idx.add(x, ids=big)
    d, ids = idx.search(x[7], SearchParams(nprobe=8, k=3))
    assert ids.shape == (1, 3) and ids.dtype == np.uint64
    assert ids[0, 0] == big[7] and d[0, 0] < 1e-2
    with pytest.raises(ValueError):
        idx.search(np.zeros((2, DIM + 1), np.float32))
    # fewer stored rows than k: sentinels pad the tail
    small = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=8), device="cpu")
    small.train(x)
    small.add(x[:5])
    d, ids = small.search(x[:1], SearchParams(nprobe=8, k=10))
    assert (ids[0, 5:] == INVALID_ID).all()
    assert (d[0, 5:] == np.finfo(np.float32).max).all()
    with pytest.raises(ValueError):
        IVFFlatConfig(scan_impl="ragged_dot")
    IVFFlatConfig(scan_impl="ragged", store_residuals=True)   # ported
    with pytest.raises(NotImplementedError):
        IVFFlatConfig(stage_bf16=True)


def test_multi_assign_state_hotness_and_stats(rng):
    x = _clustered(rng, 2000)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                     dtype="float32", multi_assign_eps=0.5,
                                     train_iters=10), device="cpu")
    idx.train(x)
    idx.append_balanced(torch.from_numpy(x), capacity=512)
    assert idx.ntotal > 2000                     # some rows got a replica
    _, ids = idx.search(x[:20], SearchParams(nprobe=4, k=10))
    for row in ids:                              # dedup: unique ids
        live = row[row != INVALID_ID]
        assert len(set(live.tolist())) == live.size
    assert (ids[:, 0] == np.arange(20)).all()
    assert idx.list_access_count.sum() > 0
    hot = idx.get_hot_lists(3)
    idx.evict_list(int(hot[0]))
    assert idx.list_access_count[hot[0]] == 0
    idx.warmup_lists(list_ids=[1], batch_sizes=(1, 2))
    st = idx.state_arrays()
    back = IVFFlatIndex.from_state(idx.config, st["centroids"], st["arena"],
                                   st["counts"], st["ids"], device="cpu")
    a = idx.search(x[:8], SearchParams(nprobe=4, k=5))
    b = back.search_batch(x[:8], SearchParams(nprobe=4, k=5))
    np.testing.assert_array_equal(a[1], b[1])
    ms = idx.memory_stats()
    assert ms["total_vectors"] == idx.ntotal and ms["arena_bytes"] > 0


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("scan_impl", ["pallas_sorted", "pallas"])
def test_kernel_scan_names_match_jax(rng, monkeypatch, dtype, scan_impl):
    """The JAX package's names for K3 ("pallas_sorted") and K4 ("pallas";
    K3 on an int8 arena, whose rows carry scales) reach the port's scans,
    here their plain versions, and search a carried index as the JAX
    kernels do in interpret mode."""
    for name in ("scan_probed_lists_pallas_sorted",
                 "scan_probed_lists_pallas"):
        monkeypatch.setattr(pallas_scan, name, functools.partial(
            getattr(pallas_scan, name), interpret=True))
    x = _clustered(rng, 1500)
    kw = dict(dimension=DIM, nlist=NLIST, dtype=dtype, train_iters=8)
    jidx = JIndex(JConfig(scan_impl=scan_impl, **kw))
    jidx.train(x)
    jidx.append_balanced(jnp.asarray(x), capacity=256)
    tidx = _carry(jidx, IVFFlatConfig(scan_impl=scan_impl, **kw))
    q = x[:12] + 0.3 * rng.standard_normal((12, DIM)).astype(np.float32)
    p = dict(nprobe=4, k=10)
    got = tidx.search(q, SearchParams(**p))
    assert_topk_match(*got, *jidx.search(q, JParams(**p)), rtol=1e-5,
                      atol=1e-5 * (q * q).sum(1))


def test_deep_k_sorted_matches_jax_gather(rng):
    """The device half at k 100 through the sorted scan (the route of deep
    k on the card) against the JAX package's gather search at k 100."""
    from cuda_acceleratedvectordatabaseengine_tpu.models.ivf_flat import (
        _ivf_search_device as j_device,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat \
        import _ivf_search_device as t_device
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        Metric,
    )

    x = _clustered(rng, 2000)
    kw = dict(dimension=DIM, nlist=NLIST, dtype="int8", train_iters=8)
    jidx = JIndex(JConfig(**kw))
    jidx.train(x)
    jidx.append_balanced(jnp.asarray(x), capacity=384)
    a = jidx.arena
    q = x[:6] + 0.2
    jd, jp, _ = j_device(jnp.asarray(q), jidx.centroids, a.arena,
                         a.arena_sq, a.counts, 4, 100, jidx.metric,
                         scan_impl="gather", arena_scale=a.arena_scale,
                         arena_anchors=a.anchors)
    tidx = _carry(jidx, IVFFlatConfig(**kw))
    t = tidx.arena
    td, tp, _ = t_device(
        torch.from_numpy(q), tidx.centroids, t.arena, t.arena_sq, t.counts,
        4, 100, Metric.L2, "sorted", t.arena_scale, t.anchors,
        scan_capacity=t.scan_capacity_hint())
    assert td.shape == (6, 100)
    assert_topk_match(td.numpy(), tp.numpy(), np.asarray(jd),
                      np.asarray(jp), rtol=1e-5, atol=1e-5 * (q * q).sum(1))


def test_deep_k_search_takes_the_sorted_scan(rng, monkeypatch):
    """A grouped-scan index sends every search deeper than K1's KMAX to the
    sorted scan: k 100, and k 40 on a multi-assignment index (whose device
    shortlist is 2k). Shallower searches stay on the grouped scan."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import flat_scan

    calls = []
    for name in ("scan_probed_lists_sorted", "scan_probed_lists_grouped"):
        real = getattr(flat_scan, name)
        monkeypatch.setattr(flat_scan, name, functools.partial(
            lambda real, name, *a, **kw: calls.append((name, a[5]))
            or real(*a, **kw), real, name))
    x = _clustered(rng, 2000)
    for eps, k, k_dev in ((0.0, 100, 100), (0.5, 40, 80), (0.0, 10, 10)):
        idx = IVFFlatIndex(IVFFlatConfig(
            dimension=DIM, nlist=NLIST, dtype="int8", train_iters=8,
            scan_impl="grouped", multi_assign_eps=eps), device="cpu")
        idx.train(x)
        idx.append_balanced(torch.from_numpy(x), capacity=512)
        calls.clear()
        got = idx.search(x[:5], SearchParams(nprobe=4, k=k))
        scan = "scan_probed_lists_sorted" if k_dev > 64 else \
            "scan_probed_lists_grouped"
        assert calls == [(scan, k_dev)]
        idx.config.scan_impl = "gather"
        ref = idx.search(x[:5], SearchParams(nprobe=4, k=k))
        assert_topk_match(*got, *ref, rtol=1e-5,
                          atol=1e-5 * (x[:5] ** 2).sum(1))
        assert (got[1][:, 0] == np.arange(5)).all()


@pytest.mark.parametrize("dtype,metric", [
    ("int8", "L2"), ("int8", "InnerProduct"), ("bfloat16", "L2"),
    ("bfloat16", "Cosine")])
def test_exact_rerank_matches_jax(rng, dtype, metric):
    """``store_residuals`` + ``use_exact_rerank``: a JAX-built index with
    its lo plane carried across reranks like the JAX index, in fp32 (both
    scans feed the same shortlist depth; the rerank picks by exact
    distances to ``stored + lo``)."""
    x = _clustered(rng, 2500)
    kw = dict(dimension=DIM, nlist=NLIST, metric=metric, dtype=dtype,
              train_iters=8, store_residuals=True)
    jidx = JIndex(JConfig(scan_impl="gather", **kw))
    jidx.train(x)
    jidx.append_balanced(jnp.asarray(x), capacity=384)
    a = jidx.arena
    assert a.arena_lo is not None
    opt = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    tidx = ivf_flat_from_arrays(
        IVFFlatConfig(**kw), centroids=np.asarray(jidx.centroids),
        arena=np.asarray(a.arena), arena_sq=np.asarray(a.arena_sq),
        arena_scale=opt(a.arena_scale), anchors=opt(a.anchors),
        counts=np.asarray(a.counts), ids=a.ids, counts_max=a.counts_max,
        arena_lo=np.asarray(a.arena_lo), device="cpu")
    q = x[:16] + 0.3 * rng.standard_normal((16, DIM)).astype(np.float32)
    atol = 1e-5 if metric == "Cosine" else 1e-5 * (q * q).sum(1)
    for nprobe in (4, NLIST):
        p = dict(nprobe=nprobe, k=10, use_exact_rerank=True)
        got = tidx.search(q, SearchParams(**p))
        assert_topk_match(*got, *jidx.search(q, JParams(**p)), rtol=1e-5,
                          atol=atol)
    if metric == "InnerProduct":
        return
    # the reranked distance is the fp32 distance to x itself, to the
    # precision of the bf16 lo plane; without the rerank, to the stored x̂
    d_rr, i_rr = tidx.search(x[:8], SearchParams(nprobe=NLIST, k=1,
                                                 use_exact_rerank=True))
    d_st, _ = tidx.search(x[:8], SearchParams(nprobe=NLIST, k=1))
    assert (i_rr[:, 0] == np.arange(8)).all()
    if metric == "L2":
        assert d_rr.max() < 1e-3 * d_st.max() + 1e-4


def test_exact_rerank_depth_rule(rng, monkeypatch):
    """The scan keeps ``min(max(4k, k_dev), 256)`` candidates when the
    index holds a lo plane and the rerank is asked for, else k (k_dev: 2k
    on a multi-assignment index); a keep above K1's 64 goes to K3."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models import (
        ivf_flat as tif,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import flat_scan

    keeps = []
    real = tif.scan_flat
    monkeypatch.setattr(tif, "scan_flat", lambda name, *a, **kw: (
        keeps.append((flat_scan.resolve_scan(name, on_cuda=True, k=a[5]),
                      a[5])) or real(name, *a, **kw)))
    x = _clustered(rng, 2000)
    for lo, eps, k, rr, want in (
            (True, 0.0, 10, True, ("grouped", 40)),
            (True, 0.5, 10, True, ("grouped", 40)),
            (True, 0.0, 5, False, ("grouped", 5)),
            (False, 0.0, 10, True, ("grouped", 10)),
            (True, 0.0, 30, True, ("sorted", 120)),
            (True, 0.0, 100, True, ("sorted", 256))):
        idx = IVFFlatIndex(IVFFlatConfig(
            dimension=DIM, nlist=NLIST, dtype="int8", train_iters=5,
            store_residuals=lo, multi_assign_eps=eps, scan_impl="grouped"),
            device="cpu")
        idx.train(x)
        idx.append_balanced(torch.from_numpy(x), capacity=512)
        keeps.clear()
        d, ids = idx.search(x[:4], SearchParams(nprobe=NLIST, k=k,
                                                use_exact_rerank=rr))
        assert keeps == [want] and ids.shape == (4, k)
        assert (ids[:, 0] == np.arange(4)).all()


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_ragged_scan_name_routes_to_k3_like_jax_ragged(rng, dtype):
    """``scan_impl="ragged"`` (the JAX package's plain-XLA list-centric
    scan) runs K3's function in the port (its plain version here): the
    scan against ``scan_probed_lists_ragged`` on the same arena and
    probes, and a search against the JAX index with the same name."""
    from cuda_acceleratedvectordatabaseengine_tpu.ops.scan import (
        scan_probed_lists_ragged,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import flat_scan
    from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import (
        Metric,
    )

    assert flat_scan.resolve_scan("ragged", on_cuda=True, k=10) == "sorted"
    assert flat_scan.resolve_scan("ragged", on_cuda=False, k=10) == "sorted"
    x = _clustered(rng, 2000)
    kw = dict(dimension=DIM, nlist=NLIST, dtype=dtype, train_iters=8,
              scan_impl="ragged")
    jidx = JIndex(JConfig(**kw))
    jidx.train(x)
    jidx.append_balanced(jnp.asarray(x), capacity=384)
    tidx = _carry(jidx, IVFFlatConfig(**kw))
    q = x[:12] + 0.3 * rng.standard_normal((12, DIM)).astype(np.float32)
    atol = 1e-5 * (q * q).sum(1)
    probes = rng.integers(-1, NLIST, (12, 5)).astype(np.int32)
    a, t = jidx.arena, tidx.arena
    for k in (10, 100):
        jd, jp = scan_probed_lists_ragged(
            jnp.asarray(q), a.arena, a.arena_sq, a.counts,
            jnp.asarray(probes), k, approx=False,
            arena_scale=a.arena_scale, arena_anchors=a.anchors)
        td, tp = flat_scan.scan_flat(
            "ragged", torch.from_numpy(q), t.arena, t.arena_sq, t.counts,
            torch.from_numpy(probes), k, Metric.L2,
            arena_scale=t.arena_scale, arena_anchors=t.anchors)
        assert_topk_match(td[:, :k].numpy(), tp[:, :k].numpy(),
                          np.asarray(jd), np.asarray(jp), rtol=1e-5,
                          atol=atol)
    p = dict(nprobe=4, k=10)
    assert_topk_match(*tidx.search(q, SearchParams(**p)),
                      *jidx.search(q, JParams(**p)), rtol=1e-5, atol=atol)


def test_list_heat_counts_each_query_over_its_probe_set(rng, monkeypatch):
    """List heat, one definition for both families: each search adds 1 to
    each list that each query probed; two queries probing one list add 2,
    and a -1 probe adds nothing (the JAX package counts a probed list once
    per batch). It is counted on the device: the search's host side
    fetches no probes."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models import (
        ivf_flat as flat_mod,
    )

    x = _clustered(rng, 600)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                     dtype="float32", train_iters=6),
                       device="cpu")
    idx.train(x)
    idx.append_balanced(torch.from_numpy(x), capacity=256)
    real = flat_mod._ivf_search_device
    probes = torch.tensor([[3, 5], [3, -1]], dtype=torch.int32)

    def fixed(*a, **kw):
        d, pos, _ = real(*a, **kw)
        return d, pos, probes

    monkeypatch.setattr(flat_mod, "_ivf_search_device", fixed)
    before = idx.list_access_count
    idx.search(x[:2], SearchParams(nprobe=2, k=5))
    added = idx.list_access_count - before
    expect = np.zeros(NLIST, np.int64)
    expect[[3, 5]] = [2, 1]
    np.testing.assert_array_equal(added, expect)
    assert isinstance(idx._heat._counts, torch.Tensor)
