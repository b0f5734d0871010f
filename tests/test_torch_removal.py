"""PyTorch port, removal: the swap-from-tail plan, the arena's in-place
compaction, ``remove_ids`` on both index families against the JAX package,
and searches running alongside removals (CPU)."""

import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu import (
    IVFFlatConfig as JFlatConfig,
    IVFFlatIndex as JFlatIndex,
    IVFPQConfig as JPQConfig,
    IVFPQIndex as JPQIndex,
    SearchParams as JParams,
)
from cuda_acceleratedvectordatabaseengine_tpu.models import arena as jarena
from cuda_acceleratedvectordatabaseengine_tpu_torch import (
    IVFFlatConfig,
    IVFFlatIndex,
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models import arena
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.convert import (
    _tensor,
    ivf_flat_from_arrays,
    ivf_pq_from_arrays,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

DIM, NLIST = 24, 8
JAX_DTYPES = {"int8": jnp.int8, "bfloat16": jnp.bfloat16,
              "float32": jnp.float32}


def _clustered(rng, n, dim=DIM, modes=NLIST):
    centers = 2.0 * rng.standard_normal((modes, dim)).astype(np.float32)
    return (centers[rng.integers(0, modes, n)]
            + rng.standard_normal((n, dim))).astype(np.float32)


def _np(v):
    return None if v is None else np.asarray(v)


def _random_plan(rng, counts, n_del):
    """Deletions at random (list, slot) pairs: duplicates, and slots past a
    list's fill (stale), included."""
    lists = rng.integers(0, len(counts), n_del)
    slots = rng.integers(0, counts.max() + 3, n_del)
    return lists.astype(np.int64), slots.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_and_id_mirror_match_jax(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, 12).astype(np.int64)
    lists, slots = _random_plan(rng, counts, 60)
    got = arena.plan_removals(counts, lists, slots)
    want = jarena.plan_removals(counts, lists, slots)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids = rng.integers(0, 2**63, (12, 48)).astype(np.uint64)
    np.testing.assert_array_equal(
        arena.apply_removal_to_ids(ids, *got, counts),
        jarena.apply_removal_to_ids(ids, *want, counts))


def _jax_arena(rng, dtype, lo, anchored):
    j = jarena.PackedListArena.create(NLIST, DIM, dtype=JAX_DTYPES[dtype],
                                      store_residuals=lo)
    if anchored:
        anchors = rng.standard_normal((NLIST, DIM)).astype(np.float32)
        j = dataclasses.replace(j, anchors=jnp.asarray(anchors))
    for step in range(2):
        n = 300
        x = (2.0 * rng.standard_normal((n, DIM))).astype(np.float32)
        j = j.append(x, np.arange(step * n, step * n + n, dtype=np.uint64),
                     rng.integers(0, NLIST, n).astype(np.int32))
    return j


def _carry_arena(j):
    t = arena.PackedListArena(
        nlist=j.nlist, dim=j.dim, dtype=arena.torch_dtype(str(j.dtype)),
        capacity=j.capacity, arena=_tensor(np.asarray(j.arena), "cpu"),
        arena_sq=_tensor(np.asarray(j.arena_sq), "cpu"),
        counts=_tensor(np.asarray(j.counts), "cpu"), ids=j.ids.copy(),
        arena_scale=None if j.arena_scale is None else _tensor(
            np.asarray(j.arena_scale), "cpu"),
        anchors=None if j.anchors is None else _tensor(
            np.asarray(j.anchors), "cpu"),
        arena_lo=None if j.arena_lo is None else _tensor(
            np.asarray(j.arena_lo), "cpu"),
        counts_max=j.counts_max)
    return t


def _planes(a):
    as_np = lambda v: None if v is None else (  # noqa: E731
        v.float().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v, np.float32))
    return [as_np(a.arena), as_np(a.arena_sq), as_np(a.arena_scale),
            as_np(a.arena_lo), as_np(a.counts)]


@pytest.mark.parametrize("dtype,lo,anchored", [
    ("int8", False, True), ("int8", True, True), ("int8", True, False),
    ("bfloat16", False, False), ("bfloat16", True, False),
    ("float32", False, False)])
def test_arena_remove_matches_jax(rng, dtype, lo, anchored):
    """The same removals from the same state leave the same planes
    (codes, norms, scales, lo), counts and ids; the old handle keeps its
    own counts and id table (copy-on-write)."""
    j = _jax_arena(rng, dtype, lo, anchored)
    t = _carry_arena(j)
    assert (t.arena_lo is not None) == lo
    old_counts, old_ids = t.counts, t.ids
    counts = np.asarray(j.counts).astype(np.int64)
    lists, slots = _random_plan(rng, counts, 150)
    j2, nj = j.remove(lists, slots)
    t2, nt = t.remove(lists, slots)
    assert nt == nj > 0
    for g, w in zip(_planes(t2), _planes(j2)):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(t2.ids, j2.ids)
    assert t2.counts_max == j2.counts_max
    assert old_counts is t.counts and t2.counts is not old_counts
    assert t2.ids is not old_ids and (t.ids == old_ids).all()
    # appends after a removal and growth keep every plane in step
    x = rng.standard_normal((900, DIM)).astype(np.float32)
    assign = rng.integers(0, NLIST, 900).astype(np.int32)
    ids = np.arange(10**6, 10**6 + 900, dtype=np.uint64)
    j3, t3 = j2.append(x, ids, assign), t2.append(x, ids, assign)
    assert t3.capacity == j3.capacity > t2.capacity
    np.testing.assert_array_equal(t3.ids, j3.ids)
    np.testing.assert_array_equal(t3.counts.numpy(), np.asarray(j3.counts))
    if lo:
        assert t3.arena_lo.shape == t3.arena.shape
    assert t.remove(np.zeros(0, np.int64), np.zeros(0, np.int64))[1] == 0


def _carry_flat(jidx, cfg):
    a = jidx.arena
    return ivf_flat_from_arrays(
        cfg, centroids=np.asarray(jidx.centroids), arena=np.asarray(a.arena),
        arena_sq=np.asarray(a.arena_sq), arena_scale=_np(a.arena_scale),
        anchors=_np(a.anchors), counts=np.asarray(a.counts), ids=a.ids,
        counts_max=a.counts_max, arena_lo=_np(a.arena_lo), device="cpu")


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_ivf_flat_remove_ids_searches_like_jax(rng, dtype):
    x = _clustered(rng, 2400)
    kw = dict(dimension=DIM, nlist=NLIST, dtype=dtype, train_iters=8,
              scan_impl="gather")
    jidx = JFlatIndex(JFlatConfig(**kw))
    jidx.train(x)
    jidx.append_balanced(jnp.asarray(x), capacity=512)
    tidx = _carry_flat(jidx, IVFFlatConfig(**kw))
    q = x[:16] + 0.3 * rng.standard_normal((16, DIM)).astype(np.float32)
    atol = 1e-5 * (q * q).sum(1)
    victims = np.concatenate([np.arange(0, 2400, 3, dtype=np.uint64),
                              np.array([10**9, 2**64 - 1], np.uint64)])
    gone = np.zeros(0, np.uint64)
    for step in np.array_split(victims, 3):
        gone = np.concatenate([gone, step])
        assert tidx.remove_ids(step) == jidx.remove_ids(step)
        assert tidx.ntotal == jidx.ntotal
        for nprobe in (2, NLIST):
            p = dict(nprobe=nprobe, k=10)
            got = tidx.search(q, SearchParams(**p))
            assert_topk_match(*got, *jidx.search(q, JParams(**p)),
                              rtol=1e-5, atol=atol)
            assert not np.isin(got[1], gone).any()
    assert tidx.ntotal == 1600
    assert tidx.remove_ids(victims) == 0
    assert tidx.remove_ids(np.zeros(0, np.uint64)) == 0


@pytest.mark.parametrize("keep_raw,opq", [(True, False), (False, False),
                                          (True, True)])
def test_ivf_pq_remove_ids_searches_like_jax(rng, keep_raw, opq):
    """One plan drives codes, norms and (with ``keep_raw``) the raw rows,
    in both packages: the same removals give the same searches."""
    x = _clustered(rng, 2400)
    jidx = JPQIndex(JPQConfig(dimension=DIM, nlist=NLIST, m=4,
                              keep_raw=keep_raw, opq=opq, opq_iters=2,
                              train_iters=8, pq_train_sample=1024,
                              scan_impl="xla"))
    jidx.train(x)
    jidx.add(x)
    raw = jidx.raw
    tidx = ivf_pq_from_arrays(
        IVFPQConfig(dimension=DIM, nlist=NLIST, m=4, keep_raw=keep_raw,
                    opq=opq, scan_impl="xla"),
        centroids=np.asarray(jidx.centroids),
        codebooks=np.asarray(jidx.codebooks),
        codes_t=np.asarray(jidx.code_arena_t),
        code_sq=np.asarray(jidx.code_sq), counts=np.asarray(jidx.counts),
        ids=jidx.ids, raw_arena=None if raw is None else np.asarray(
            raw.arena),
        raw_sq=None if raw is None else np.asarray(raw.arena_sq),
        raw_scale=None if raw is None else _np(raw.arena_scale),
        raw_anchors=None if raw is None else _np(raw.anchors),
        opq_R=_np(jidx.opq_R), device="cpu")
    q = x[:12] + 0.3 * rng.standard_normal((12, DIM)).astype(np.float32)
    victims = np.arange(1, 2400, 4, dtype=np.uint64)
    gone = np.zeros(0, np.uint64)
    for step in np.array_split(victims, 2):
        gone = np.concatenate([gone, step])
        assert tidx.remove_ids(step) == jidx.remove_ids(step)
        np.testing.assert_array_equal(tidx.ids, jidx.ids)
        np.testing.assert_array_equal(tidx.code_arena_t.numpy(),
                                      np.asarray(jidx.code_arena_t))
        for rr in ((False, True) if keep_raw else (False,)):
            p = dict(nprobe=4, k=10, use_exact_rerank=rr)
            got = tidx.search(q, SearchParams(**p))
            assert_topk_match(*got, *jidx.search(q, JParams(**p)),
                              rtol=1e-5, atol=1e-5 * (q * q).sum(1))
            assert not np.isin(got[1], gone).any()
    assert tidx.ntotal == 1800
    assert not np.isin(tidx.ids, victims).any()


def _stored_rows(idx):
    """{id: the fp32 point the index stores for it} (rows only move on a
    removal, so this holds across removals)."""
    a = idx.arena if hasattr(idx, "arena") else idx.raw
    rows, ids = a.live_rows(0, a.nlist)
    return dict(zip(ids.tolist(), rows.numpy()))


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq"])
def test_search_alongside_removals_stays_consistent(rng, family):
    """Searches on other threads while the main thread removes rows: each
    returned (id, distance) pair matches the distance to that id's stored
    row, and no id removed before a search began comes back. Six
    searching threads (more than this test's one core of torch), a short
    switch interval, and a bound on the time."""
    x = _clustered(rng, 3000)
    if family == "ivf_flat":
        idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                         dtype="int8", train_iters=5),
                           device="cpu")
        params = SearchParams(nprobe=NLIST, k=10)
    else:
        idx = IVFPQIndex(IVFPQConfig(dimension=DIM, nlist=NLIST, m=4,
                                     train_iters=5, raw_dtype="float32"),
                         device="cpu")
        params = SearchParams(nprobe=NLIST, k=10, use_exact_rerank=True)
    idx.train(x)
    idx.add(x)
    stored = _stored_rows(idx)
    q = x[:8] + 0.2 * rng.standard_normal((8, DIM)).astype(np.float32)
    removed_before: list[set] = []
    done = threading.Event()
    results, errors = [], []

    def serve():
        try:
            while not done.is_set():
                gone = set().union(*removed_before)
                results.append((gone, idx.search(q, params)))
        except Exception as e:          # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve) for _ in range(6)]
        for t in threads:
            t.start()
        for b in np.array_split(np.arange(0, 3000, 2, dtype=np.uint64), 10):
            assert idx.remove_ids(b) == b.size
            removed_before.append(set(b.tolist()))
        done.set()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) >= 6
    for gone, (d, ids) in results:
        assert not gone & set(ids.ravel().tolist())
        for r in range(len(q)):
            for dist, i in zip(d[r], ids[r]):
                p = stored[int(i)]
                want = float(((q[r].astype(np.float64) - p) ** 2).sum())
                assert abs(dist - want) <= 1e-4 * (1 + want), (i, dist, want)
